"""The port's adaptive-tempering SMC and information criteria against the
JAX package at float64.

`_ess`, `_find_next_beta` and `_systematic_resample` (the parents equal);
the whole `run_smc` with the draws of the JAX key tree replayed (per stage
key, k_beta, k_res, k_mut = split(key, 4), smc.py:127; the resampling
uniform from k_res; each mutation's per-particle HMC keys split(k, P) of
split(k_mut, num_mutations), :145, :156); the analytic log Z of
`tests/test_samplers.py` with the port's generator; `run_smc_staged` equal
to `run_smc`.  Then `lpd`, `aic`, `bic` and `dic` against the JAX
`utils/metrics.py` on the three deviances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.infer import smc as jsmc
from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import logdensities as jld
from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import metrics as jmetrics
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import smc as tsmc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
    logdensities as tld,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
    metrics as tmetrics,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import sim_mnts
from test_torch_samplers import JaxHMCDraws, _t
from torch_port_helpers import assert_close, run_jax

torch.set_num_threads(1)

RNG = np.random.default_rng(50)

# the conjugate model of tests/test_samplers.py:82-112: prior N(0, s0^2 I),
# one observation y ~ N(q, s1^2 I)
S0, S1 = 2.0, 0.5
Y_OBS = np.array([0.7, -0.3])
D = 2


def log_prior_jax(q):
    return -0.5 * jnp.sum(q**2) / S0**2 - D * jnp.log(S0) - 0.5 * D * jnp.log(2 * jnp.pi)


def log_like_jax(q):
    return (-0.5 * jnp.sum((jnp.asarray(Y_OBS) - q) ** 2) / S1**2 - D * jnp.log(S1)
            - 0.5 * D * jnp.log(2 * jnp.pi))


def log_prior_torch(q):
    return (-0.5 * torch.sum(q**2, dim=-1) / S0**2 - D * np.log(S0)
            - 0.5 * D * np.log(2 * np.pi))


def log_like_torch(q):
    return (-0.5 * torch.sum((torch.as_tensor(Y_OBS) - q) ** 2, dim=-1) / S1**2 - D * np.log(S1)
            - 0.5 * D * np.log(2 * np.pi))


class JaxSMCDraws:
    """The draws of the JAX `run_smc(key)` in the order the port asks for
    them: at each stage's `resample()`, key, k_beta, k_res, k_mut =
    split(key, 4) and uniform(k_res); then each mutation's momentum and
    accept draws from split(k, P) for k in split(k_mut, num_mutations)."""

    def __init__(self, key, particles, dim, num_mutations):
        self.key, self.P, self.dim, self.K = key, particles, dim, num_mutations
        self.stages = 0

    def resample(self):
        self.key, _, k_res, k_mut = jax.random.split(self.key, 4)
        self._muts = iter([JaxHMCDraws(jax.random.split(k, self.P), self.dim)
                           for k in jax.random.split(k_mut, self.K)])
        self.stages += 1
        return _t(jax.random.uniform(k_res, (), dtype=jnp.float64))

    def momentum(self):
        self._cur = next(self._muts)
        return self._cur.momentum()

    def accept(self):
        return self._cur.accept()


def test_ess_matches_jax():
    for scale in (0.1, 3.0, 40.0):
        log_w = scale * RNG.standard_normal(64)
        assert_close(tsmc._ess(_t(log_w)), jsmc._ess(jnp.asarray(log_w)), rtol=1e-12)


@pytest.mark.parametrize("beta", [0.0, 0.3, 0.9999])
@pytest.mark.parametrize("scale", [0.01, 5.0, 300.0])
def test_find_next_beta_matches_jax(beta, scale):
    """A small spread takes the whole remaining jump; a large one bisects."""
    log_like = -scale * np.abs(RNG.standard_normal(128))
    got = tsmc._find_next_beta(_t(log_like), _t(beta), 0.5, 128)
    want = run_jax(lambda ll, b: jsmc._find_next_beta(ll, b, 0.5, 128), jnp.asarray(log_like),
                   jnp.float64(beta))
    assert_close(got, want, rtol=1e-13)


@pytest.mark.parametrize("scale", [0.0, 1.0, 30.0])
def test_systematic_resample_parents_equal_jax(scale):
    P = 200
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        log_w = scale * RNG.standard_normal(P)
        u0 = jax.random.uniform(key, (), dtype=jnp.float64)
        got = tsmc._systematic_resample(_t(u0), _t(log_w), P)
        want = jsmc._systematic_resample(key, jnp.asarray(log_w), P)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_run_smc_step_for_step(monkeypatch):
    """The whole run (P = 16, 2 mutations of 4 leapfrogs) against the JAX
    run with its draws replayed: the beta of every stage (recorded from
    the JAX `_find_next_beta` by a callback), log Z, positions, step size
    and the number of stages, rtol 1e-10."""
    P, K, L = 16, 2, 4
    kw = dict(num_mutations=K, num_leapfrog=L)
    q0 = S0 * RNG.standard_normal((P, D))
    key = jax.random.PRNGKey(4)
    draws = JaxSMCDraws(key, P, D, K)
    pos, info = tsmc.run_smc(log_prior_torch, log_like_torch, _t(q0), draws=draws, **kw)

    jbetas, find_next_beta = [], jsmc._find_next_beta

    def recorded(*args):
        beta = find_next_beta(*args)
        jax.debug.callback(lambda b: jbetas.append(float(b)), beta)
        return beta

    monkeypatch.setattr(jsmc, "_find_next_beta", recorded)
    jpos, ji = run_jax(lambda q, k: jsmc.run_smc(log_prior_jax, log_like_jax, q, k, **kw),
                       jnp.asarray(q0), key)
    n = info["num_stages"]
    assert n == int(ji["num_stages"]) == draws.stages == len(jbetas) > 1
    assert_close(info["betas"], sorted(jbetas), rtol=1e-10)  # beta rises stage by stage
    assert float(info["betas"][-1]) == 1.0
    assert_close(info["log_z"], ji["log_z"], rtol=1e-10)
    assert_close(pos, jpos, rtol=1e-10, atol=1e-12)
    assert_close(info["final_step_size"], ji["final_step_size"], rtol=1e-10)


def test_smc_analytic_log_marginal_likelihood_with_a_generator():
    """tests/test_samplers.py:82-112 on the port: P = 1024, 4 mutations of
    8 leapfrogs, |log Z - exact| < 0.15 and the posterior mean within 0.1."""
    var = S0**2 + S1**2
    log_z_true = float(-0.5 * np.sum(Y_OBS**2) / var - 0.5 * D * np.log(2 * np.pi * var))
    gen = torch.Generator().manual_seed(3)
    init = S0 * torch.randn(1024, D, generator=gen, dtype=torch.float64)
    final, info = tsmc.run_smc(log_prior_torch, log_like_torch, init, gen, num_mutations=4,
                               num_leapfrog=8)
    assert abs(float(info["log_z"]) - log_z_true) < 0.15, (float(info["log_z"]), log_z_true)
    np.testing.assert_allclose(final.mean(0).numpy(), Y_OBS * S0**2 / var, atol=0.1)


def test_run_smc_staged_equals_run_smc(capsys):
    init = S0 * torch.randn(64, D, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    runs = []
    for fn, kw in ((tsmc.run_smc, {}), (tsmc.run_smc_staged, {"progress": True})):
        runs.append(fn(log_prior_torch, log_like_torch, init, torch.Generator().manual_seed(6),
                       num_mutations=2, num_leapfrog=4, **kw))
    (p1, i1), (p2, i2) = runs
    assert torch.equal(p1, p2) and torch.equal(i1["betas"], i2["betas"])
    assert float(i1["log_z"]) == float(i2["log_z"]) and i1["num_stages"] == i2["num_stages"]
    assert capsys.readouterr().out.count("smc stage") == i2["num_stages"]


def test_log_marginal_likelihood_takes_a_prior_sampler():
    gen = torch.Generator().manual_seed(8)
    log_z = tsmc.log_marginal_likelihood(
        log_prior_torch, log_like_torch,
        lambda g, n: S0 * torch.randn(n, D, generator=g, dtype=torch.float64), gen,
        num_particles=256, num_mutations=2, num_leapfrog=4)
    assert np.isfinite(float(log_z))


# ---------------------------------------------------------------------------
# information criteria
# ---------------------------------------------------------------------------


def _deviance_case(name):
    N, M = 6, 2
    x, _, _, _, Y = sim_mnts(M=M, N=N, seed=3)
    dim = {"svc": N + 3 * N + 1, "snmgp": 2 * N + 3 + 1, "lmc": 2 + 3 + 1}[name]
    hist = 0.3 * RNG.standard_normal((7, dim))
    hist[:, -1] = np.log(0.1)
    return x, Y, hist


@pytest.mark.parametrize("name", ["svc", "snmgp", "lmc"])
def test_information_criteria_match_jax(name):
    x, Y, hist = _deviance_case(name)
    jdev, tdev = getattr(jld, f"{name}_deviance"), getattr(tld, f"{name}_deviance")
    jargs, targs = (jnp.asarray(Y), jnp.asarray(x)), (_t(Y), _t(x))
    np.testing.assert_allclose(tmetrics.dic(hist, tdev, *targs),
                               jmetrics.dic(hist, jdev, *jargs), rtol=1e-12)
    np.testing.assert_allclose(tmetrics.dic(_t(hist), tdev, *targs),
                               jmetrics.dic(hist, jdev, *jargs), rtol=1e-12)
    np.testing.assert_allclose(tmetrics.aic(hist[0], tdev, *targs),
                               jmetrics.aic(hist[0], jdev, *jargs), rtol=1e-12)
    np.testing.assert_allclose(tmetrics.bic(hist[1], tdev, Y.size, *targs),
                               jmetrics.bic(hist[1], jdev, Y.size, *jargs), rtol=1e-12)


def test_lpd_matches_jax():
    m, s, y = RNG.standard_normal(40), np.exp(RNG.standard_normal(40)), RNG.standard_normal(40)
    assert tmetrics.lpd(m, s, y) == jmetrics.lpd(m, s, y)
    assert tmetrics.lpd(_t(m), _t(s), _t(y)) == jmetrics.lpd(m, s, y)
