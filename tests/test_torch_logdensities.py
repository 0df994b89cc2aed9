"""`models/logdensities.py` of the port against the JAX package at float64,
on `sim_mnts(M=2, N=12)`: every log-posterior, deviance and covs function,
value (rtol 1e-10) and gradient (rtol 1e-8), a chain batch of 3 against 3
single JAX calls; and the identities of `tests/test_whitened.py` (whitened
= centered + a constant; deviance = -2 loglik) on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import logdensities as jld
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
    logdensities as tld,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops.linalg import (
    uvec_to_lvec,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import sim_mnts
from torch_port_helpers import assert_close, jax_value_and_grad

torch.set_num_threads(1)

N, M = 12, 2
T = 3
C = 3
X, _, _, _, YM = sim_mnts(M=M, N=N, seed=0)
RNG = np.random.default_rng(21)
INDX = RNG.integers(0, M, N)
YH = RNG.standard_normal(N)
SVC_HYP = dict(mu_tilde_l=-3.0, alpha_tilde_l=3.0, beta_tilde_l=0.4, mu_L=0.0, alpha_L=5.0,
               beta_L=1.0, a=1.0, b=1.0)
SNMGP_HYP = dict(mu_tilde_l=-0.5, alpha_tilde_l=2.0, beta_tilde_l=0.5, mu_tilde_sigma=0.1,
                 alpha_tilde_sigma=1.5, beta_tilde_sigma=0.7, a=1.0, b=1.0, c=10.0)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _pars(dim, scale=0.3, shift=0.0):
    return shift + scale * RNG.standard_normal((C, dim))


def _check(port_fn, jax_fn, pars, port_args, jax_args):
    """Value and gradient of each chain against one JAX call per chain."""
    q = _t(pars).requires_grad_(True)
    lp = port_fn(q, *port_args)
    assert lp.shape == (C,)
    (g,) = torch.autograd.grad(lp.sum(), q)
    for c in range(C):
        val, grad = jax_value_and_grad(jax_fn, jnp.asarray(pars[c]), *jax_args)
        assert_close(lp[c], val, rtol=1e-10)
        assert_close(g[c], grad, rtol=1e-8, atol=1e-10 * float(np.abs(grad).max()))
    # one chain alone, as a (dim,) vector
    assert_close(port_fn(_t(pars[0]), *port_args), lp[0].item(), rtol=1e-12)


ISOTOPIC = {
    "snmgp_log_posterior": (2 * N + T + 1, SNMGP_HYP),
    "svc_log_posterior": (N + N * T + 1, SVC_HYP),
    "lmc_log_posterior": (2 + T + 1, dict(mu_tilde_l=0.2, sigma_tilde_l=1.5, a=1.0, b=1.0, c=10.0)),
}


@pytest.mark.parametrize("name", sorted(ISOTOPIC))
@pytest.mark.parametrize("prior", [True, False])
def test_isotopic_log_posteriors(name, prior):
    dim, hyp = ISOTOPIC[name]
    pfn, jfn = getattr(tld, name), getattr(jld, name)
    _check(lambda q, Y, x: pfn(q, Y, x, prior=prior, **hyp),
           lambda q, Y, x: jfn(q, Y, x, prior=prior, **hyp),
           _pars(dim), (_t(YM), _t(X)), (jnp.asarray(YM), jnp.asarray(X)))


HADAMARD = {
    # GP priors of lengthscale 0.1 over N = 12 points in [0, 1]: at the
    # default 1 their covariance has condition ~1e6 and a random vector's
    # prior density is ~-4e5, rounded in the tenth digit
    "snmgp_hadamard_log_posterior": (2 * N + T + 1, dict(mu_tilde_l=-0.3, alpha_tilde_l=1.5,
                                                         beta_tilde_l=0.1, beta_tilde_sigma=0.1)),
    "svc_hadamard_log_posterior": (N + N * T + 1, dict(mu_tilde_l=-1.0, beta_tilde_l=0.1,
                                                       alpha_L=2.0, beta_L=0.1)),
    "lmc_hadamard_log_posterior": (2 + T + 1, dict(mu_tilde_l=0.1)),
}


@pytest.mark.parametrize("name", sorted(HADAMARD))
def test_hadamard_log_posteriors(name):
    dim, hyp = HADAMARD[name]
    pfn, jfn = getattr(tld, name), getattr(jld, name)
    # the Hadamard variants take the L vecs raw: keep their diagonal away from 0
    pars = _pars(dim, shift=0.5)
    _check(lambda q, x, i, y: pfn(q, x, i, y, M, **hyp),
           lambda q, x, i, y: jfn(q, x, i, y, M, **hyp),
           pars, (_t(X), torch.as_tensor(INDX), _t(YH)),
           (jnp.asarray(X), jnp.asarray(INDX), jnp.asarray(YH)))


DEVIANCES = {"snmgp_deviance": 2 * N + T + 1, "lmc_deviance": 2 + T + 1,
             "svc_deviance": N + N * T + 1}


@pytest.mark.parametrize("name", sorted(DEVIANCES))
def test_deviances(name):
    _check(getattr(tld, name), getattr(jld, name), _pars(DEVIANCES[name], shift=0.5),
           (_t(YM), _t(X)), (jnp.asarray(YM), jnp.asarray(X)))


def test_covs_match_jax():
    pars = _pars(2 * N + T + 1, shift=0.5)
    got = tld.snmgp_covs(_t(pars), _t(YM), _t(X))
    hg = tld.snmgp_hadamard_covs(_t(pars), _t(X), torch.as_tensor(INDX))
    for c in range(C):
        want = jld.snmgp_covs(jnp.asarray(pars[c]), jnp.asarray(YM), jnp.asarray(X))
        for k in want:
            assert_close(got[k][c], want[k], rtol=1e-10)
        hw = jld.snmgp_hadamard_covs(jnp.asarray(pars[c]), jnp.asarray(X), INDX)
        for k in hw:
            assert_close(hg[k][c], hw[k], rtol=1e-10)


def test_svc_covariance_per_chain():
    pars = _pars(N + N * T + 1)
    p = tld.svc_unflatten(_t(pars), N, M)
    K, L_f = tld.svc_covariance(p.tilde_l, p.uL_vecs, _t(X))
    assert K.shape == (C, M * N, M * N) and L_f.shape == (C, N, M, M)
    for c in range(C):
        jp = jld.svc_unflatten(jnp.asarray(pars[c]), N, M)
        Kj, Lj = jld.svc_covariance(jp.tilde_l, jp.uL_vecs, jnp.asarray(X))
        assert_close(K[c], Kj, rtol=1e-10, atol=1e-14)
        assert_close(L_f[c], Lj, rtol=1e-10)


def test_whitened_densities_match_jax():
    x, Y = jnp.asarray(X), jnp.asarray(YM)
    a = (SVC_HYP["alpha_tilde_l"], SVC_HYP["beta_tilde_l"], SVC_HYP["alpha_L"], SVC_HYP["beta_L"])
    jchols = jld.svc_whiten_chols(x, *a)
    for got, want in zip(tld.svc_whiten_chols(_t(X), *a), jchols):
        assert_close(got, want, rtol=1e-9, atol=1e-10 * float(np.abs(want).max()))
    chols = tuple(_t(c) for c in jchols)  # the same factors into both densities
    kw = dict(mu_tilde_l=-3.0, mu_L=0.2, a=1.0, b=1.0)
    _check(lambda q, *r: tld.svc_log_posterior_whitened(q, *r, **kw),
           lambda q, *r: jld.svc_log_posterior_whitened(q, *r, **kw),
           _pars(N + N * T + 1), (_t(YM), _t(X)) + chols, (Y, x) + jchols)

    s = (SNMGP_HYP["alpha_tilde_l"], SNMGP_HYP["beta_tilde_l"], SNMGP_HYP["alpha_tilde_sigma"],
         SNMGP_HYP["beta_tilde_sigma"])
    jchols = jld.snmgp_whiten_chols(x, *s)
    for got, want in zip(tld.snmgp_whiten_chols(_t(X), *s), jchols):
        assert_close(got, want, rtol=1e-9, atol=1e-10 * float(np.abs(want).max()))
    chols = tuple(_t(c) for c in jchols)
    kw = dict(mu_tilde_l=-0.5, mu_tilde_sigma=0.1, a=1.0, b=1.0, c=10.0)
    _check(lambda q, *r: tld.snmgp_log_posterior_whitened(q, *r, **kw),
           lambda q, *r: jld.snmgp_log_posterior_whitened(q, *r, **kw),
           _pars(2 * N + T + 1), (_t(YM), _t(X)) + chols, (Y, x) + jchols)


def test_whitened_equals_centered_up_to_a_constant():
    """tests/test_whitened.py on the port, the chains of one batch in place
    of its loop over draws."""
    x, Y = _t(X), _t(YM)
    hyp = dict(mu_tilde_l=-1.0, alpha_tilde_l=3.0, beta_tilde_l=0.4, mu_L=0.2, alpha_L=5.0,
               beta_L=1.0, a=1.0, b=1.0)
    chol_l, chol_L = tld.svc_whiten_chols(x, 3.0, 0.4, 5.0, 1.0)
    eta = _t(0.5 * RNG.standard_normal((4, N + N * T + 1)))
    lw = tld.svc_log_posterior_whitened(eta, Y, x, chol_l, chol_L, mu_tilde_l=-1.0, mu_L=0.2)
    lc = tld.svc_log_posterior(tld.svc_flatten(tld.svc_unwhiten(eta, x, -1.0, 0.2, chol_l, chol_L, M)),
                               Y, x, **hyp)
    d = (lw - lc).numpy()
    np.testing.assert_allclose(d, d[0], atol=1e-6)

    hyp = SNMGP_HYP
    chol_l, chol_s = tld.snmgp_whiten_chols(x, 2.0, 0.5, 1.5, 0.7)
    eta = _t(0.5 * RNG.standard_normal((4, 2 * N + T + 1)))
    lw = tld.snmgp_log_posterior_whitened(eta, Y, x, chol_l, chol_s, mu_tilde_l=-0.5,
                                          mu_tilde_sigma=0.1)
    p = tld.snmgp_unwhiten(eta, x, -0.5, 0.1, chol_l, chol_s, M)
    d = (lw - tld.snmgp_log_posterior(tld.snmgp_flatten(p), Y, x, **hyp)).numpy()
    np.testing.assert_allclose(d, d[0], atol=1e-5)


def test_deviance_is_minus_twice_the_loglik():
    x, Y = _t(X), _t(YM)
    pars = _t(np.concatenate([[[-0.3, 0.1]] * C, 0.5 + 0.1 * RNG.standard_normal((C, T)),
                              [[-1.0]] * C], axis=1))
    lp = tld.lmc_log_posterior(pars, Y, x, prior=False)
    p = tld.lmc_unflatten(pars, M)
    dev = tld.lmc_deviance(torch.cat([pars[:, :2], uvec_to_lvec(p.uL_vec, M), pars[:, -1:]], 1), Y, x)
    assert_close(lp, (-dev / 2).numpy(), rtol=1e-8)
    pars = _t(np.concatenate([0.1 * RNG.standard_normal((C, N)) - 1, 0.2 * RNG.standard_normal((C, N * T)),
                              [[-1.0]] * C], axis=1))
    lp = tld.svc_log_posterior(pars, Y, x, prior=False)
    p = tld.svc_unflatten(pars, N, M)
    lvecs = uvec_to_lvec(p.uL_vecs.reshape(C, N, T), M).reshape(C, -1)
    dev = tld.svc_deviance(torch.cat([p.tilde_l, lvecs, pars[:, -1:]], 1), Y, x)
    assert_close(lp, (-dev / 2).numpy(), rtol=1e-8)


def test_make_nlp_negates():
    pars = _t(_pars(2 + T + 1))
    nlp = tld.make_nlp(tld.lmc_log_posterior, _t(YM), _t(X), c=5.0)
    assert_close(nlp(pars), (-tld.lmc_log_posterior(pars, _t(YM), _t(X), c=5.0)).numpy(), rtol=0)
