"""The fully-Bayesian path's kernels on the CPU: the plain versions of the
RBF, Cholesky, Kronecker-matvec and (blocked-size) Cholesky-inverse kernels
against the JAX functions and the Pallas kernels in interpret mode, and the
port's autograd Functions over them (`ops.kernels.rbf`,
`ops.kernels.nonstationary_rbf`, `ops.linalg.cholesky`, `ops.kron.kron_mv`)
against `jax.grad`.  float64; values rtol 1e-10, gradients 1e-8 unless
stated.  The kernels themselves are held against these plain versions on
the card (`chip_smoke.py`, `tests/test_torch_cuda.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import kernels as jk
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import kron as jkron
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import linalg as jl
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops.pallas_kernels import (
    chol_inv_pallas,
    cholesky_pallas,
    kron_mv_pallas,
    rbf_pallas,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import kernels as tk
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import kron as tkron
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import linalg as tl
from torch_port_helpers import assert_close

torch.set_num_threads(1)


def _rng(seed):
    return np.random.default_rng(seed)


def _spd(r, batch, m, shift=None):
    A = r.standard_normal((batch, m, m))
    return np.einsum("bij,bkj->bik", A, A) + (m if shift is None else shift) * np.eye(m)


def _leaf(a):
    return torch.as_tensor(a, dtype=torch.float64).requires_grad_(True)


@pytest.mark.parametrize("n, m", [(130, 260), (12, 7)])
def test_rbf_plain_matches_jax_and_pallas(n, m):
    r = _rng(n)
    x1, x2 = np.sort(r.random(n)), np.sort(r.random(m))
    got = ck.rbf_plain(torch.as_tensor(x1), torch.as_tensor(x2), 2.0, 0.4)
    assert_close(got, jk.rbf(x1, x2, 2.0, 0.4), rtol=1e-10)
    pal = rbf_pallas(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(2.0), jnp.asarray(0.4), True)
    assert_close(got, pal, rtol=1e-10)


def test_rbf_plain_per_pair_scales():
    """(S,) scales and lengthscales give one gram per pair (the chains of
    `lmc_hadamard`), each the JAX rbf of that pair; 2-D inputs keep the
    exact sq_dist of the scaled inputs."""
    r = _rng(1)
    x = r.random(9)
    s2, ls = np.exp(r.standard_normal(3)), np.exp(0.3 * r.standard_normal(3))
    got = ck.rbf_plain(torch.as_tensor(x), torch.as_tensor(x), torch.as_tensor(s2), torch.as_tensor(ls))
    assert got.shape == (3, 9, 9)
    for s in range(3):
        assert_close(got[s], jk.rbf(x, x, s2[s], ls[s]), rtol=1e-10)
    X1, X2 = r.random((7, 2)), r.random((5, 2))
    got2 = ck.rbf_plain(torch.as_tensor(X1), torch.as_tensor(X2), 1.5, torch.as_tensor(ls))
    for s in range(3):
        assert_close(got2[s], jk.rbf(X1, X2, 1.5, ls[s]), rtol=1e-10)


def test_rbf_function_gradients_match_jax():
    """The closed-form backward against jax.grad of the JAX rbf, in the
    inputs, the scale and the lengthscale, scalar and per-pair."""
    r = _rng(2)
    n, m = 14, 9
    x1, x2 = np.sort(r.random(n)), np.sort(r.random(m))
    W = r.standard_normal((n, m))
    args = (x1, x2, 2.0, 0.4)
    g_jax = jax.grad(lambda a, b, s, l: jnp.sum(W * jk.rbf(a, b, s, l)), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, args))
    t = [_leaf(a) for a in args]
    (torch.as_tensor(W) * tk.rbf(*t)).sum().backward()
    for got, want in zip(t, g_jax):
        assert_close(got.grad, want, rtol=1e-8)

    S = 3
    s2, ls = np.exp(r.standard_normal(S)), np.exp(0.3 * r.standard_normal(S))
    W3 = r.standard_normal((S, n, n))
    ts2, tls, tx = _leaf(s2), _leaf(ls), _leaf(x1)
    (torch.as_tensor(W3) * tk.rbf(tx, tx, ts2, tls)).sum().backward()
    f = lambda x, s, l: sum(jnp.sum(W3[i] * jk.rbf(x, x, s[i], l[i])) for i in range(S))  # noqa: E731
    gx, gs, gl = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x1), jnp.asarray(s2), jnp.asarray(ls))
    assert_close(ts2.grad, gs, rtol=1e-8)
    assert_close(tls.grad, gl, rtol=1e-8)
    # x is both sides: its gradient is two large sums that cancel, so the
    # tolerance is taken of the largest entry
    assert_close(tx.grad, gx, rtol=1e-8, atol=1e-8 * float(np.abs(gx).max()))


def test_nonstationary_rbf_matches_jax_per_chain():
    """Per-chain (C, N) sigma and ell give (C, N, N), each the JAX
    nonstationary_rbf of that chain; gradients in sigma and ell too."""
    r = _rng(3)
    N, C = 11, 3
    x = np.sort(r.random(N))
    sig, ell = np.exp(0.3 * r.standard_normal((C, N))), np.exp(0.3 * r.standard_normal((C, N)))
    W = r.standard_normal((C, N, N))
    ts, te = _leaf(sig), _leaf(ell)
    K = tk.nonstationary_rbf(torch.as_tensor(x), sigma1=ts, ell1=te)
    (torch.as_tensor(W) * K).sum().backward()
    for c in range(C):
        f = lambda s, e: jnp.sum(W[c] * jk.nonstationary_rbf(jnp.asarray(x), sigma1=s, ell1=e))  # noqa: E731
        val = jk.nonstationary_rbf(jnp.asarray(x), sigma1=jnp.asarray(sig[c]), ell1=jnp.asarray(ell[c]))
        assert_close(K[c], val, rtol=1e-10)
        gs, ge = jax.grad(f, argnums=(0, 1))(jnp.asarray(sig[c]), jnp.asarray(ell[c]))
        assert_close(ts.grad[c], gs, rtol=1e-8)
        assert_close(te.grad[c], ge, rtol=1e-8)
    x2 = np.sort(r.random(4))
    got = tk.nonstationary_rbf(torch.as_tensor(x), torch.as_tensor(x2))
    assert_close(got, jk.nonstationary_rbf(jnp.asarray(x), jnp.asarray(x2)), rtol=1e-10)


@pytest.mark.parametrize("m", [20, 13])
def test_cholesky_plain_matches_pallas(m):
    S = _spd(_rng(m), 5, m)
    got = ck.cholesky_plain(torch.as_tensor(S))
    assert_close(got, cholesky_pallas(jnp.asarray(S), interpret=True), rtol=1e-10, atol=1e-12)
    assert_close(got, np.linalg.cholesky(S), rtol=1e-10, atol=1e-12)


def test_cholesky_function_gradient_matches_pallas_vjp_and_jnp():
    """The Murray pullback of `ops.linalg.cholesky` against the Pallas
    kernel's VJP (`_chol_bwd`) and jnp.linalg.cholesky's, batched."""
    r = _rng(4)
    m = 8
    S = _spd(r, 2, m)
    W = r.standard_normal((2, m, m))
    t = _leaf(S)
    (torch.as_tensor(W) * tl.cholesky(t)).sum().backward()
    g_pal = jax.grad(lambda s: jnp.sum(W * cholesky_pallas(s, interpret=True)))(jnp.asarray(S))
    g_ref = jax.grad(lambda s: jnp.sum(W * jnp.linalg.cholesky(s)))(jnp.asarray(S))
    assert_close(t.grad, g_pal, rtol=1e-8, atol=1e-12)
    assert_close(t.grad, g_ref, rtol=1e-8, atol=1e-12)


def test_cholesky_nan_on_a_non_pd_member():
    S = _spd(_rng(5), 3, 6)
    S[1, 2, 2] = -5.0
    L = tl.cholesky(torch.as_tensor(S))
    lower = torch.ones(6, 6, dtype=torch.bool).tril()
    assert torch.isnan(L[1][lower]).all() and (L[1][~lower] == 0).all()
    assert torch.isfinite(L[[0, 2]]).all()


def test_kron_mv_plain_matches_pallas_and_dense():
    r = _rng(6)
    m1, m2, n1, n2 = 3, 2, 200, 150
    B, K, y = r.standard_normal((m1, m2)), r.standard_normal((n1, n2)), r.standard_normal(m2 * n2)
    got = ck.kron_mv_plain(*map(torch.as_tensor, (B, K, y)))
    assert_close(got, jkron.kron_mv(jnp.asarray(B), jnp.asarray(K), jnp.asarray(y)), rtol=1e-10)
    assert_close(got, np.kron(B, K) @ y, rtol=1e-10, atol=1e-12)
    # the Pallas kernel accumulates its tiles in f32 whatever the operands
    pal = kron_mv_pallas(jnp.asarray(B), jnp.asarray(K), jnp.asarray(y), interpret=True)
    assert_close(got, pal, rtol=1e-5, atol=1e-8)


def test_kron_mv_function_gradients_match_jax_per_chain():
    """dB, dK (matmuls) and dy (through the kernel's plain version) of a
    chain batch against jax.grad of the JAX kron_mv, chain by chain; a y
    shared by the chains gets the sum."""
    r = _rng(7)
    C, M, N = 3, 2, 9
    B, K = r.standard_normal((C, M, M)), r.standard_normal((C, N, N))
    y = r.standard_normal(M * N)
    W = r.standard_normal((C, M * N))
    tB, tK, ty = _leaf(B), _leaf(K), _leaf(y)
    out = tkron.kron_mv(tB, tK, ty)
    assert out.shape == (C, M * N)
    (torch.as_tensor(W) * out).sum().backward()
    gy = np.zeros_like(y)
    for c in range(C):
        f = lambda b, k, v: jnp.sum(W[c] * jkron.kron_mv(b, k, v))  # noqa: E731
        assert_close(out[c], jkron.kron_mv(jnp.asarray(B[c]), jnp.asarray(K[c]), jnp.asarray(y)),
                     rtol=1e-10)
        gb, gk, gv = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (B[c], K[c], y)))
        assert_close(tB.grad[c], gb, rtol=1e-8)
        assert_close(tK.grad[c], gk, rtol=1e-8)
        gy += np.asarray(gv)
    assert_close(ty.grad, gy, rtol=1e-8)


def test_chol_inv_plain_at_m200_matches_pallas():
    """The SVC covariance's size (M = 200, more than one block's shared
    memory holds whole): the plain (L, L^-1) against chol_inv_pallas in
    interpret mode and the JAX chol_tri_inv."""
    S = _spd(_rng(8), 1, 200, shift=200.0)
    L, Linv = ck.chol_inv_plain(torch.as_tensor(S))
    pL, pLinv = chol_inv_pallas(jnp.asarray(S), interpret=True)
    assert_close(L, pL, rtol=1e-10, atol=1e-12)
    assert_close(Linv, pLinv, rtol=1e-10, atol=1e-12)
    jL, jLinv = jl.chol_tri_inv(jnp.asarray(S))
    assert_close(Linv, jLinv, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [1, 4])
def test_tril_transforms_match_jax(n):
    r = _rng(n)
    T = n * (n + 1) // 2
    u = r.standard_normal((3, T))
    assert_close(tl.vec_to_tril(torch.as_tensor(u), n), jl.vec_to_tril(jnp.asarray(u), n), rtol=0)
    L = r.standard_normal((2, n, n))
    assert_close(tl.tril_to_vec(torch.as_tensor(L)), jl.tril_to_vec(jnp.asarray(L)), rtol=0)
    np.testing.assert_array_equal(tl.diag_indices_of_trilvec(n), jl.diag_indices_of_trilvec(n))
    lv = tl.uvec_to_lvec(torch.as_tensor(u), n)
    assert_close(lv, jl.uvec_to_lvec(jnp.asarray(u), n), rtol=1e-15)
    assert_close(tl.lvec_to_uvec(lv, n), jl.lvec_to_uvec(jnp.asarray(lv.numpy()), n), rtol=1e-15)
    K = r.standard_normal((n, n))
    assert_close(tl.add_jitter(torch.as_tensor(K), 0.3), jl.add_jitter(jnp.asarray(K), 0.3), rtol=0)
