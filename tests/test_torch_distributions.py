"""`ops/kron.py` and `ops/distributions.py` of the port against the JAX
package at float64: values rtol 1e-10, gradients 1e-8.  `mvn_logpdf_kron`
is held on both of its routes (the dense Cholesky, and the factor-eigh
route through `kron_mv`, forced by `dense_max_dim=0`), with a chain batch
checked chain by chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import distributions as jd
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import kron as jkron
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    distributions as td,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import kron as tkron
from torch_port_helpers import assert_close

torch.set_num_threads(1)
RNG = np.random.default_rng(11)


def _spd(m, batch=()):
    A = RNG.standard_normal(batch + (m, m))
    return A @ np.swapaxes(A, -1, -2) / m + 0.5 * np.eye(m)


def _t(a, grad=False):
    return torch.tensor(a, dtype=torch.float64, requires_grad=grad)


def test_kron_algebra_matches_jax():
    B, K = _spd(3), _spd(5)
    d1, d2 = RNG.random(3), RNG.random(5)
    assert_close(tkron.kron(_t(B), _t(K)), jkron.kron(jnp.asarray(B), jnp.asarray(K)), rtol=0)
    assert_close(tkron.kron_diag(_t(d1), _t(d2)), jkron.kron_diag(jnp.asarray(d1), jnp.asarray(d2)),
                 rtol=0)
    assert_close(tkron.kron_inv(0.3, _t(B), _t(K)), jkron.kron_inv(0.3, jnp.asarray(B), jnp.asarray(K)),
                 rtol=1e-10, atol=1e-13)
    assert_close(tkron.kron_logdet(0.3, _t(B), _t(K)),
                 jkron.kron_logdet(0.3, jnp.asarray(B), jnp.asarray(K)), rtol=1e-10)
    y = RNG.standard_normal(15)
    assert_close(tkron.kron_mv(_t(B), _t(K), _t(y)),
                 jkron.kron_mv(jnp.asarray(B), jnp.asarray(K), jnp.asarray(y)), rtol=1e-10)
    (wB, vB), (wK, vK) = tkron.kron_eigh(_t(B), _t(K))
    assert_close(wB, np.linalg.eigvalsh(B), rtol=1e-10)
    rebuilt = tkron.kron(vB, vK) @ torch.diag(tkron.kron_diag(wB, wK)) @ tkron.kron(vB, vK).T
    assert_close(rebuilt, np.kron(B, K), rtol=1e-10, atol=1e-12)
    # a chain axis: one Kronecker product per chain
    Bs, Ks = _spd(2, (3,)), _spd(4, (3,))
    got = tkron.kron(_t(Bs), _t(Ks))
    for c in range(3):
        assert_close(got[c], np.kron(Bs[c], Ks[c]), rtol=0)


def test_eigh_gives_nan_for_a_non_finite_member():
    A = _spd(4, (3,))
    A[1, 0, 0] = np.nan
    w, v = tkron.eigh(_t(A))
    assert torch.isnan(w[1]).all() and torch.isnan(v[1]).all()
    assert_close(w[[0, 2]], np.linalg.eigvalsh(A[[0, 2]]), rtol=1e-10)


@pytest.mark.parametrize("dense_max_dim", [None, 0], ids=["dense", "eigen"])
@pytest.mark.parametrize("jitter", [0.0, 1e-6])
def test_mvn_logpdf_kron_both_routes_per_chain(dense_max_dim, jitter):
    C, M, N = 3, 2, 7
    Bs, Ks = _spd(M, (C,)), _spd(N, (C,))
    s2 = np.exp(RNG.standard_normal(C) - 1.0)
    y, mu = RNG.standard_normal(M * N), 0.1 * RNG.standard_normal(M * N)
    tB, tK, ts2 = _t(Bs, True), _t(Ks, True), _t(s2, True)
    lp = td.mvn_logpdf_kron(_t(y), _t(mu), tB, tK, ts2, jitter=jitter, dense_max_dim=dense_max_dim)
    assert lp.shape == (C,)
    lp.sum().backward()
    f = lambda b, k, s: jd.mvn_logpdf_kron(jnp.asarray(y), jnp.asarray(mu), b, k, s,  # noqa: E731
                                            jitter=jitter, dense_max_dim=dense_max_dim)
    for c in range(C):
        args = tuple(map(jnp.asarray, (Bs[c], Ks[c], s2[c])))
        val, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(*args)
        assert_close(lp[c], val, rtol=1e-10)
        for got, want in zip((tB.grad[c], tK.grad[c], ts2.grad[c]), grads):
            assert_close(got, want, rtol=1e-8, atol=1e-12)


def test_mvn_logpdf_kron_routes_agree():
    B, K = _spd(2), _spd(9)
    y = RNG.standard_normal(18)
    dense = td.mvn_logpdf_kron(_t(y), torch.zeros(18, dtype=torch.float64), _t(B), _t(K), 0.2)
    eigen = td.mvn_logpdf_kron(_t(y), torch.zeros(18, dtype=torch.float64), _t(B), _t(K), 0.2,
                               dense_max_dim=0)
    assert_close(eigen, float(dense), rtol=1e-10)
    assert td.KRON_DENSE_MAX_DIM == jd.KRON_DENSE_MAX_DIM == 1024


def test_dense_chol_and_prec_logpdfs_match_jax():
    n, C = 6, 3
    S = _spd(n, (C,))
    y, mu = RNG.standard_normal(n), RNG.standard_normal((C, n))
    tS = _t(S, True)
    lp = td.mvn_logpdf_dense(_t(y), _t(mu), tS)
    lc = td.mvn_logpdf_chol(_t(y), _t(mu), _t(S))
    (lp.sum()).backward()
    for c in range(C):
        val, g = jax.value_and_grad(lambda s: jd.mvn_logpdf_dense(jnp.asarray(y), jnp.asarray(mu[c]), s))(
            jnp.asarray(S[c]))
        assert_close(lp[c], val, rtol=1e-10)
        assert_close(tS.grad[c], g, rtol=1e-8, atol=1e-12)
        assert_close(lc[c], jd.mvn_logpdf_chol(jnp.asarray(y), jnp.asarray(mu[c]), jnp.asarray(S[c])),
                     rtol=1e-10)
    inv = np.linalg.inv(S[0])
    logdet = np.linalg.slogdet(S[0])[1]
    assert_close(td.mvn_logpdf_prec(_t(y), _t(mu[0]), logdet, _t(inv)),
                 jd.mvn_logpdf_prec(jnp.asarray(y), jnp.asarray(mu[0]), logdet, jnp.asarray(inv)),
                 rtol=1e-10)


def test_gamma_family_and_normal_logprob_match_jax():
    x = np.exp(RNG.standard_normal(5))
    for fname in ("inverse_gamma_logpdf", "inverse_gamma_logpdf_u", "gamma_logpdf"):
        got = getattr(td, fname)(_t(x), alpha=2.5, beta=0.7)
        assert_close(got, getattr(jd, fname)(jnp.asarray(x), alpha=2.5, beta=0.7), rtol=1e-10)
    loc, y = RNG.standard_normal(5), RNG.standard_normal(5)
    assert_close(td.normal_logprob_sum(_t(loc), 0.4, _t(y)),
                 jd.normal_logprob_sum(jnp.asarray(loc), 0.4, jnp.asarray(y)), rtol=1e-10)
    assert_close(td.normal_logprob_sum(_t(loc), _t(x), _t(y)),
                 jd.normal_logprob_sum(jnp.asarray(loc), jnp.asarray(x), jnp.asarray(y)), rtol=1e-10)
