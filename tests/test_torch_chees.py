"""The port's ChEES-HMC against the JAX package's `infer/chees.py` at float64.

The JAX kernel draws one (C, dim) normal block from k_mom and (C,) uniforms
from k_acc, k_mom, k_acc = split(key) (chees.py:182, :188, :218); the
draws below rebuild those blocks from the JAX key tree: one transition
step for step on a correlated Gaussian and on the whitened SVC density
(N = 5), then the whole `run_chees` (warmup, mass matrix, re-adaptation,
sampling).  Then the streaming contract of `chees_sample`, and the moments
test of `tests/test_samplers.py` with the port's own generator draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.infer import chees as jchees
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import chees as tchees
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.hmc import (
    GeneratorDraws,
)
from test_torch_samplers import DIM, _svc_density, _t, gauss_lp_jax, gauss_lp_torch
from torch_port_helpers import assert_close, run_jax

torch.set_num_threads(1)


class JaxCheesDraws:
    """The draws of a sequence of ChEES iteration keys: for each key,
    k_mom, k_acc = split(key), normal(k_mom, (C, dim)) and uniform(k_acc,
    (C,)).  Each `momentum()` call starts the next key."""

    def __init__(self, keys, chains, dim):
        def one(key):
            k_mom, k_acc = jax.random.split(key)
            return (jax.random.normal(k_mom, (chains, dim), jnp.float64),
                    jax.random.uniform(k_acc, (chains,), dtype=jnp.float64))

        z, u = run_jax(jax.vmap(one), jnp.asarray(keys))
        self._z, self._u = _t(z), _t(u)
        self._i = -1

    def momentum(self):
        self._i += 1
        return self._z[self._i]

    def accept(self):
        return self._u[self._i]

    def used(self):
        return self._i + 1


def run_chees_keys(key, num_warmup, num_samples):
    """The iteration keys of the JAX `run_chees(key)` in order: k_warm,
    k_main = split(key) (:574); in `chees_warmup`, split(k_warm) (:419),
    then split(k_warm', num_warmup) (:441) and split(k_re, n_re) (:460);
    in `chees_sample`, split(k_main, num_samples) (:524)."""
    k_warm, k_main = jax.random.split(key)
    k_warm, k_re = jax.random.split(k_warm)
    n_re = max(num_warmup // 4, 1)
    return jnp.concatenate([jax.random.split(k_warm, num_warmup), jax.random.split(k_re, n_re),
                            jax.random.split(k_main, num_samples)])


def _target(name):
    if name == "gaussian":
        return gauss_lp_jax, gauss_lp_torch, DIM
    return _svc_density(5)


def test_halton_sequence_is_a_copy():
    for n, offset in ((8, 0), (50, 7), (300, 1000)):
        np.testing.assert_array_equal(tchees.halton_sequence(n, offset),
                                      jchees.halton_sequence(n, offset))


def test_init_carry_takes_the_jax_call_form_with_dtype():
    """`init_carry` has the JAX parameters in the JAX order, and the JAX
    call form of `parallel/sharded_mcmc.py:167`, `init_carry(lp, q, eps,
    traj, dtype)`: with float32 on float64 positions every leaf has the
    dtype and the value of the JAX carry's (the state keeps the positions'
    float64); without `dtype`, the positions' dtype."""
    import inspect

    assert (list(inspect.signature(tchees.init_carry).parameters)
            == list(inspect.signature(jchees.init_carry).parameters))
    rng = np.random.default_rng(5)
    q0 = rng.standard_normal((4, DIM))
    want = jax.jit(lambda q: jchees.init_carry(gauss_lp_jax, q, 0.1, 0.3, jnp.float32))(
        jnp.asarray(q0))
    got = tchees.init_carry(gauss_lp_torch, _t(q0), 0.1, 0.3, torch.float32)
    got_leaves = jax.tree_util.tree_leaves(tuple(got))
    want_leaves = jax.tree_util.tree_leaves(tuple(want))
    assert len(got_leaves) == len(want_leaves) == 16
    for g, w in zip(got_leaves, want_leaves):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert_close(g, w, rtol=1e-10)
    default = tchees.init_carry(gauss_lp_torch, _t(q0), 0.1, 0.3)
    assert all(t.dtype == torch.float64 for t in jax.tree_util.tree_leaves(tuple(default)))


@pytest.mark.parametrize("target", ["gaussian", "svc"])
def test_chees_kernel_step_for_step(target):
    """One transition of six chains: positions, log-probs, gradients,
    accept probabilities (some chains accept, some not), the ChEES gradient
    and the shared step count."""
    jfn, tfn, dim = _target(target)
    C = 6
    rng = np.random.default_rng(40)
    q0 = (0.5 if target == "svc" else 1.5) * rng.standard_normal((C, dim))
    inv_mass = np.exp(0.2 * rng.standard_normal(dim))
    eps, traj = (2.0, 6.0) if target == "gaussian" else (0.2, 0.9)
    key = jax.random.PRNGKey(11)
    draws = JaxCheesDraws(key[None], C, dim)
    state = tchees.init_carry(tfn, _t(q0), 0.1, 0.1).state
    new, aps, mean_acc, grad_t, n = tchees._chees_kernel(
        tfn, state, draws, _t(eps), _t(traj), _t(inv_mass), 1024, lambda x: x.mean(0))

    def jax_kernel(q, k):
        lp, g = jax.vmap(jax.value_and_grad(jfn))(q)
        return jchees._chees_kernel(jfn, jchees.CheesState(q, lp, g), k, jnp.float64(eps),
                                    jnp.float64(traj), jnp.asarray(inv_mass), 1024,
                                    jchees._make_cmean(None))

    js, japs, jmean, jgrad, jn = run_jax(jax_kernel, jnp.asarray(q0), key)
    assert n == int(jn) > 1
    atol = 1e-12 if target == "gaussian" else 1e-9
    assert_close(new.position, js.position, rtol=1e-10, atol=atol)
    assert_close(new.log_prob, js.log_prob, rtol=1e-10)
    assert_close(new.grad, js.grad, rtol=1e-10, atol=atol)
    assert_close(aps, japs, rtol=1e-10, atol=1e-14)
    assert_close(mean_acc, jmean, rtol=1e-10)
    assert_close(grad_t, jgrad, rtol=1e-9)
    accepted = (new.position == state.position).all(1)
    assert 0 < int(accepted.sum()) < C  # some chains rejected, some moved


@pytest.mark.parametrize("target", ["gaussian", "svc"])
def test_run_chees_step_for_step(target):
    """The whole `run_chees` (C = 4, 20 warmup, 10 samples, T from 0.5)
    against the JAX one with the draws of its key tree, at the tolerances
    tests/test_torch_run_nuts.py holds run_nuts to: rtol 1e-10 on the
    Gaussian; on the SVC density 1e-4 (one evaluation agrees to ~1e-12; the
    leapfrogs and dual averaging grow that, test_torch_run_nuts.py:68-72)."""
    jfn, tfn, dim = _target(target)
    rtol, atol = (1e-10, 1e-12) if target == "gaussian" else (1e-4, 1e-5)
    C, W, S = 4, 20, 10
    q0 = 0.5 * np.random.default_rng(41).standard_normal((C, dim))
    key = jax.random.PRNGKey(13)
    draws = JaxCheesDraws(run_chees_keys(key, W, S), C, dim)
    # a trajectory of several steps from the start (the default starts at one)
    kw = dict(num_warmup=W, num_samples=S, init_traj_length=0.5)
    pos, info = tchees.run_chees(tfn, _t(q0), draws=draws, **kw)
    jpos, ji = run_jax(lambda q, k: jchees.run_chees(jfn, q, k, **kw), jnp.asarray(q0), key)
    assert draws.used() == W + max(W // 4, 1) + S  # every iteration key of the JAX run
    np.testing.assert_array_equal(info["num_steps"].numpy(), np.asarray(ji["num_steps"]))
    assert info["leapfrogs"] > info["host_reads"] == W + max(W // 4, 1) + S
    for got, want in ((info["step_size"], ji["step_size"]),
                      (info["trajectory_length"], ji["trajectory_length"]),
                      (info["inv_mass"], ji["inv_mass"]),
                      (info["warmup_accept_mean"], ji["warmup_accept_mean"]),
                      (pos, jnp.swapaxes(jpos, 0, 1)),
                      (info["accept_prob"], jnp.swapaxes(ji["accept_prob"], 0, 1)),
                      (info["log_prob"], jnp.swapaxes(ji["log_prob"], 0, 1))):
        assert_close(got, want, rtol=rtol, atol=atol)


def test_chees_sample_streams():
    """Two `chees_sample` calls with advancing offsets, the generator
    going on, give the draws of one call, bit for bit."""
    C = 4
    q0 = _t(np.random.default_rng(42).standard_normal((C, DIM)))
    state, tuning, winfo = tchees.chees_warmup(gauss_lp_torch, q0, torch.Generator().manual_seed(1),
                                               num_warmup=16)
    off = winfo["halton_offset"]
    _, whole, info = tchees.chees_sample(gauss_lp_torch, state, tuning,
                                         torch.Generator().manual_seed(2), 9, halton_offset=off)
    gen = torch.Generator().manual_seed(2)
    st, first, i1 = tchees.chees_sample(gauss_lp_torch, state, tuning, gen, 5, halton_offset=off)
    _, second, i2 = tchees.chees_sample(gauss_lp_torch, st, tuning, gen, 4, halton_offset=off + 5)
    assert torch.equal(torch.cat([first, second], 1), whole)
    assert torch.equal(torch.cat([i1["num_steps"], i2["num_steps"]]), info["num_steps"])


def test_chees_gaussian_moments_with_generator_draws():
    """tests/test_samplers.py's ChEES moments test (C = 8, 400 + 600,
    init step 0.5, its tolerances), on the port with GeneratorDraws."""
    from test_samplers import COV, MEAN, _check_moments

    dim = MEAN.shape[0]
    prec = torch.as_tensor(np.linalg.inv(COV))
    mean = torch.as_tensor(MEAN)

    def lp(q):
        d = q - mean
        return -0.5 * torch.sum(d * (d @ prec), dim=-1)

    C = 8
    init = torch.as_tensor(np.random.default_rng(43).standard_normal((C, dim)))
    gen = torch.Generator().manual_seed(7)
    draws = GeneratorDraws(gen, C, dim, torch.float64, torch.device("cpu"))
    positions, info = tchees.run_chees(lp, init, num_warmup=400, num_samples=600,
                                       init_step_size=0.5, draws=draws)
    _check_moments(positions.reshape(-1, dim).numpy(), mean_tol=0.35, cov_tol=0.25)
    acc = float(info["accept_prob"].mean())
    assert 0.4 < acc < 0.95, acc
    assert float(info["trajectory_length"]) > float(info["step_size"])
