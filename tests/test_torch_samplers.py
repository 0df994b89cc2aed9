"""The port's samplers against the JAX package at float64.

One `hmc_kernel` and one `nuts_kernel` transition step for step, several
chains at once, with each chain's draws rebuilt from the JAX key splits
(hmc.py:108-121; nuts.py:129, :197, :293-306): position, log-prob, accept
probability, depth and number of steps at rtol 1e-10.  Then ESS and split
R-hat on one array, and `run_map` against optax Adam step for step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.infer import hmc as jhmc
from collaborative_nonstationary_multivariate_gaussian_process_tpu.infer import map as jmap
from collaborative_nonstationary_multivariate_gaussian_process_tpu.infer import nuts as jnuts
from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import logdensities as jld
from collaborative_nonstationary_multivariate_gaussian_process_tpu.parallel import sharded_mcmc as jsm
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import hmc as thmc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import map as tmap
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import nuts as tnuts
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
    logdensities as tld,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel import (
    sharded_mcmc as tsm,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import sim_mnts
from torch_port_helpers import assert_close, run_jax

torch.set_num_threads(1)

DIM = 5
RNG = np.random.default_rng(31)
_A = RNG.standard_normal((DIM, DIM))
PREC = np.linalg.inv(_A @ _A.T + 0.5 * np.eye(DIM))
MEAN = RNG.standard_normal(DIM)


def gauss_lp_jax(q):
    d = q - jnp.asarray(MEAN)
    return -0.5 * d @ jnp.asarray(PREC) @ d


def gauss_lp_torch(q):
    d = q - torch.as_tensor(MEAN)
    return -0.5 * torch.sum(d * (d @ torch.as_tensor(PREC)), dim=-1)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


class JaxHMCDraws:
    """Each chain's momentum normals and accept uniform of `hmc_kernel(key)`:
    k_mom, k_acc = split(key)."""

    def __init__(self, keys, dim):
        z, u = [], []
        for key in keys:
            k_mom, k_acc = jax.random.split(key)
            z.append(jax.random.normal(k_mom, (dim,), jnp.float64))
            u.append(jax.random.uniform(k_acc, dtype=jnp.float64))
        self._z, self._u = _t(np.stack(z)), _t(np.stack(u))

    def momentum(self):
        return self._z

    def accept(self):
        return self._u


class JaxNUTSDraws:
    """Each chain's draws of `nuts_kernel(key)`: k_mom, k_dir, k_prop =
    split(key, 3) (nuts.py:129); per doubling key, k_dir, k_sub, k_bias =
    split(key, 4) from k_prop on (:293), direction bernoulli(k_dir), bias
    uniform(k_bias); per leaf key, k_sel = split(key) from k_sub on (:197)."""

    def __init__(self, keys, dim, max_depth):
        self._z, self._dirs, self._bias, self._leaves = [], [], [], []
        for key in keys:
            k_mom, _, key = jax.random.split(key, 3)
            self._z.append(np.asarray(jax.random.normal(k_mom, (dim,), jnp.float64)))
            dirs, bias, leaves = [], [], []
            for depth in range(max_depth):
                key, k_dir, k_sub, k_bias = jax.random.split(key, 4)
                dirs.append(bool(jax.random.bernoulli(k_dir)))
                bias.append(float(jax.random.uniform(k_bias, dtype=jnp.float64)))
                row = []
                for _ in range(2**depth):
                    k_sub, k_sel = jax.random.split(k_sub)
                    row.append(float(jax.random.uniform(k_sel, dtype=jnp.float64)))
                leaves.append(row)
            self._dirs.append(dirs)
            self._bias.append(bias)
            self._leaves.append(leaves)

    def momentum(self):
        return _t(np.stack(self._z))

    def direction(self, depth):
        return torch.tensor([d[depth] for d in self._dirs])

    def bias(self, depth):
        return _t([b[depth] for b in self._bias])

    def leaf(self, depth, n):
        return _t([rows[depth][n] for rows in self._leaves])


@pytest.mark.parametrize("num_steps", [1, 7])
def test_hmc_kernel_step_for_step(num_steps):
    C = 4
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    q0 = RNG.standard_normal((C, DIM))
    inv_mass = np.exp(0.3 * RNG.standard_normal(DIM))
    eps = np.array([0.05, 0.3, 0.8, 1.5])  # some chains accept, some do not
    state = thmc.hmc_init(gauss_lp_torch, _t(q0))
    new, ap = thmc.hmc_kernel(gauss_lp_torch, state, JaxHMCDraws(keys, DIM), _t(eps), _t(inv_mass),
                              num_steps)
    for c in range(C):
        js = jhmc.hmc_init(gauss_lp_jax, jnp.asarray(q0[c]))
        jn, jap = jhmc.hmc_kernel(gauss_lp_jax, js, keys[c], eps[c], jnp.asarray(inv_mass), num_steps)
        assert_close(new.position[c], jn.position, rtol=1e-10)
        assert_close(new.log_prob[c], jn.log_prob, rtol=1e-10)
        assert_close(new.grad[c], jn.grad, rtol=1e-10)
        assert_close(ap[c], jap, rtol=1e-10)


def _svc_density(N):
    x, _, _, _, Y = sim_mnts(M=2, N=N, seed=1)
    jx, jY = jnp.asarray(x), jnp.asarray(Y)
    jcl, jcL = jld.svc_whiten_chols(jx, 3.0, 0.4, 5.0, 1.0)
    tx, tY, tcl, tcL = _t(x), _t(Y), _t(jcl), _t(jcL)
    return (lambda q: jld.svc_log_posterior_whitened(q, jY, jx, jcl, jcL, mu_tilde_l=-3.0),
            lambda q: tld.svc_log_posterior_whitened(q, tY, tx, tcl, tcL, mu_tilde_l=-3.0),
            N + 3 * N + 1)


@pytest.mark.parametrize("target", ["gaussian", "svc"])
def test_nuts_kernel_step_for_step(target):
    """Chains that stop at different depths (the lockstep masks), on a
    correlated Gaussian and on the whitened SVC density (N=5)."""
    if target == "gaussian":
        jfn, tfn, dim = gauss_lp_jax, gauss_lp_torch, DIM
        C, max_depth, seed = 5, 7, 4
        eps = np.array([0.02, 0.1, 0.3, 0.6, 1.2])
    else:
        jfn, tfn, dim = _svc_density(5)
        C, max_depth, seed = 3, 5, 5
        eps = np.array([0.05, 0.2, 0.5])
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    q0 = 0.5 * RNG.standard_normal((C, dim))
    inv_mass = np.exp(0.2 * RNG.standard_normal((C, dim)))
    draws = JaxNUTSDraws(keys, dim, max_depth)
    state = thmc.hmc_init(tfn, _t(q0))
    new, info = tnuts.nuts_kernel(tfn, state, draws, _t(eps), _t(inv_mass), max_depth)
    kernel = jax.jit(lambda q, k, e, m: jnuts.nuts_kernel(jfn, jhmc.hmc_init(jfn, q), k, e, m,
                                                          max_depth))
    depths = []
    for c in range(C):
        js, ji = kernel(jnp.asarray(q0[c]), keys[c], jnp.asarray(eps[c]), jnp.asarray(inv_mass[c]))
        assert_close(new.position[c], js.position, rtol=1e-10, atol=1e-12)
        assert_close(new.log_prob[c], js.log_prob, rtol=1e-10)
        assert_close(info.accept_prob[c], ji.accept_prob, rtol=1e-10)
        assert int(info.depth[c]) == int(ji.depth) and int(info.num_steps[c]) == int(ji.num_steps)
        assert bool(info.diverging[c]) == bool(ji.diverging)
        depths.append(int(ji.depth))
    assert len(set(depths)) > 1, depths  # the masks were exercised
    assert info.host_reads > 0 and info.leapfrogs >= max(int(n) for n in info.num_steps)


def test_nuts_kernel_dense_metric_step_for_step():
    C, max_depth = 3, 6
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    q0 = RNG.standard_normal((C, DIM))
    B = RNG.standard_normal((C, DIM, DIM))
    inv_mass = B @ np.swapaxes(B, -1, -2) / DIM + 0.5 * np.eye(DIM)
    state = thmc.hmc_init(gauss_lp_torch, _t(q0))
    new, info = tnuts.nuts_kernel(gauss_lp_torch, state, JaxNUTSDraws(keys, DIM, max_depth), 0.4,
                                  _t(inv_mass), max_depth)
    for c in range(C):
        js, ji = jnuts.nuts_kernel(gauss_lp_jax, jhmc.hmc_init(gauss_lp_jax, jnp.asarray(q0[c])),
                                   keys[c], 0.4, jnp.asarray(inv_mass[c]), max_depth)
        assert_close(new.position[c], js.position, rtol=1e-10, atol=1e-12)
        assert int(info.num_steps[c]) == int(ji.num_steps)


def test_find_reasonable_step_size_matches_jax():
    C = 3
    keys = jax.random.split(jax.random.PRNGKey(12), C)
    q0 = RNG.standard_normal((C, DIM))
    init = np.array([1e-3, 1.0, 40.0])  # grows, about right, shrinks
    state = thmc.hmc_init(gauss_lp_torch, _t(q0))
    eps, reads = thmc.find_reasonable_step_size(gauss_lp_torch, state, JaxHMCDraws(keys, DIM),
                                                torch.ones(DIM, dtype=torch.float64), _t(init))
    assert reads > 1
    for c in range(C):
        js = jhmc.hmc_init(gauss_lp_jax, jnp.asarray(q0[c]))
        want = jhmc.find_reasonable_step_size(gauss_lp_jax, js, keys[c], jnp.ones(DIM), init[c])
        assert_close(eps[c], want, rtol=1e-12)


def test_dual_averaging_matches_jax():
    eps0 = np.array([0.1, 0.5])
    t, j = thmc.da_init(_t(eps0)), jhmc.da_init(jnp.asarray(eps0))
    for ap in ([0.9, 0.2], [0.7, 0.95], [0.1, 0.8]):
        t, j = thmc.da_update(t, _t(ap), 0.8), jhmc.da_update(j, jnp.asarray(ap), 0.8)
    for a, b in zip(t, j):
        assert_close(a, b, rtol=1e-12)


def test_ess_and_rhat_match_jax():
    x = np.cumsum(RNG.standard_normal((4, 301, 3)), axis=1) * 0.1 + RNG.standard_normal((4, 301, 3))
    assert_close(tsm.effective_sample_size(_t(x)), jsm.effective_sample_size(jnp.asarray(x)), rtol=1e-10)
    assert_close(tsm.potential_scale_reduction(_t(x)),
                 jsm.potential_scale_reduction(jnp.asarray(x)), rtol=1e-10)


def test_run_map_matches_optax_adam_step_for_step():
    """Adam on the LMC negative log-posterior, two chains, against the JAX
    `run_map` (optax.adam) one chain at a time, 25 steps."""
    x, _, _, _, Y = sim_mnts(M=2, N=10, seed=2)
    q0 = 0.2 * RNG.standard_normal((2, 6))
    tnlp = tld.make_nlp(tld.lmc_log_posterior, _t(Y), _t(x))
    jnlp = jld.make_nlp(jld.lmc_log_posterior, jnp.asarray(Y), jnp.asarray(x))
    q, losses = tmap.run_map(tnlp, _t(q0), num_steps=25, learning_rate=0.05)
    assert losses.shape == (25, 2)
    for c in range(2):
        jq, jl = run_jax(lambda p: jmap.run_map(jnlp, p, num_steps=25, learning_rate=0.05),
                         jnp.asarray(q0[c]))
        assert_close(losses[:, c], jl, rtol=1e-8)
        assert_close(q[c], jq, rtol=1e-8)


def test_run_map_scipy_reaches_the_jax_optimum():
    x, _, _, _, Y = sim_mnts(M=2, N=10, seed=2)
    q0 = 0.2 * RNG.standard_normal(6)
    tnlp = tld.make_nlp(tld.lmc_log_posterior, _t(Y), _t(x))
    jnlp = jld.make_nlp(jld.lmc_log_posterior, jnp.asarray(Y), jnp.asarray(x))
    xt, rt = tmap.run_map_scipy(tnlp, q0, maxiter=200, device="cpu", dtype=torch.float64)
    xj, rj = jmap.run_map_scipy(jnlp, q0, maxiter=200)
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=1e-6)
    np.testing.assert_allclose(xt, xj, rtol=1e-3, atol=1e-4)
