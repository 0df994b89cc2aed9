"""The port's `run_nuts` against the JAX `run_nuts` at float64, whole.

Several chains at once against the JAX run one chain at a time, with each
chain's draws rebuilt from the JAX key splits: the step-size search, the
warmup (dual averaging, the Welford diagonal or dense mass), the
re-adaptation of the step size under the new metric, then the draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from collaborative_nonstationary_multivariate_gaussian_process_tpu.infer import nuts as jnuts
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import nuts as tnuts
from test_torch_samplers import (
    DIM,
    JaxHMCDraws,
    JaxNUTSDraws,
    _svc_density,
    _t,
    gauss_lp_jax,
    gauss_lp_torch,
)
from torch_port_helpers import assert_close


class JaxRunNUTSDraws:
    """Each chain's draws of the JAX `run_nuts(key)`, in the order the
    port's `run_nuts` asks for them: k_find, k_warm, k_main = split(key, 3)
    (nuts.py:390); the step-size search's draws from k_find, then one
    transition's from each of split(k_warm, num_warmup) (:428),
    split(fold_in(k_warm, 1), num_warmup // 5) (:460) and split(k_main,
    num_samples) (:468).  Each `momentum()` call starts the next set."""

    def __init__(self, keys, dim, max_depth, num_warmup, num_samples):
        parts = [jax.random.split(key, 3) for key in keys]
        per_chain = [
            list(jax.random.split(k_warm, num_warmup))
            + list(jax.random.split(jax.random.fold_in(k_warm, 1), max(num_warmup // 5, 1)))
            + list(jax.random.split(k_main, num_samples))
            for _, k_warm, k_main in parts
        ]
        sets = [JaxHMCDraws([p[0] for p in parts], dim)]
        sets += [JaxNUTSDraws(list(ks), dim, max_depth) for ks in zip(*per_chain)]
        self._sets, self._cur = iter(sets), None

    def momentum(self):
        self._cur = next(self._sets)
        return self._cur.momentum()

    def accept(self):
        return self._cur.accept()

    def direction(self, depth):
        return self._cur.direction(depth)

    def bias(self, depth):
        return self._cur.bias(depth)

    def leaf(self, depth, n):
        return self._cur.leaf(depth, n)


@pytest.mark.parametrize("target,dense_mass", [("gaussian", False), ("gaussian", True),
                                               ("svc", False)])
def test_run_nuts_warmup_and_sampling_step_for_step(target, dense_mass):
    """The whole of `run_nuts`, several chains at once, against the JAX
    `run_nuts` one chain at a time with the draws of its key splits: the
    step-size search, dual averaging and the Welford mass of the warmup, the
    re-adaptation under the new metric, then the draws."""
    if target == "gaussian":
        (jfn, tfn, dim), max_depth, rtol, atol = (gauss_lp_jax, gauss_lp_torch, DIM), 5, 1e-10, 1e-12
    else:
        # One evaluation of the SVC density agrees with JAX to ~1e-12; the
        # leapfrogs of the run (~130 at depth 3) and dual averaging (which
        # scales accept-probability differences by sqrt(t) / gamma, 80 at
        # the 16th update) grow that to 1e-7-2e-6 in the positions and
        # accept probabilities, by the starting point (3e-5 at depth 5).  A
        # fault of the adaptation moves the step size and the mass at 1e-2
        # or more; the tree decisions (steps) still match exactly.
        (jfn, tfn, dim), max_depth, rtol, atol = _svc_density(5), 3, 1e-4, 1e-5
    C, num_warmup, num_samples = 3, 12, 4
    keys = jax.random.split(jax.random.PRNGKey(21), C)
    q0 = 0.5 * np.random.default_rng(21).standard_normal((C, dim))
    draws = JaxRunNUTSDraws(keys, dim, max_depth, num_warmup, num_samples)
    pos, info = tnuts.run_nuts(tfn, _t(q0), num_warmup=num_warmup, num_samples=num_samples,
                               max_depth=max_depth, dense_mass=dense_mass, draws=draws)
    run = jax.jit(lambda q, k: jnuts.run_nuts(jfn, q, k, num_warmup=num_warmup,
                                              num_samples=num_samples, max_depth=max_depth,
                                              dense_mass=dense_mass))
    for c in range(C):
        jpos, ji = run(jnp.asarray(q0[c]), keys[c])
        assert_close(info["step_size"][c], ji["step_size"], rtol=rtol, atol=atol)
        assert_close(info["inv_mass"][c], ji["inv_mass"], rtol=rtol, atol=atol)
        assert_close(info["warmup_accept_mean"][c], ji["warmup_accept_mean"], rtol=rtol,
                     atol=atol)
        assert_close(pos[c], jpos, rtol=rtol, atol=atol)
        assert_close(info["log_prob"][c], ji["log_prob"], rtol=rtol, atol=atol)
        assert_close(info["accept_prob"][c], ji["accept_prob"], rtol=rtol, atol=atol)
        np.testing.assert_array_equal(info["num_steps"][c].numpy(), np.asarray(ji["num_steps"]))
    with pytest.raises(StopIteration):  # every draw set of the JAX run was used
        draws.momentum()
