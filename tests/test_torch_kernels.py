"""Plain versions of the port's CUDA kernels against the JAX functions and
the Pallas kernels in interpret mode (the CPU side of each kernel; the
kernels themselves are held against these plain versions on the card by
`chip_smoke.py` and `tests/test_torch_cuda.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import kernels as jk
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import linalg as jl
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops.pallas_kernels import (
    chol_inv_pallas,
    gibbs_pallas,
    quadform_diag_pallas,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)
from torch_port_helpers import assert_close

torch.set_num_threads(1)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("n, m", [(200, 150), (37, 5), (1, 1)])
def test_gibbs_plain_matches_jax_and_pallas(n, m):
    r = _rng(n + m)
    x1, x2 = np.sort(r.random(n)), np.sort(r.random(m))
    e1 = np.exp(0.3 * r.standard_normal(n))
    e2 = np.exp(0.3 * r.standard_normal(m))
    got = ck.gibbs_plain(*map(torch.as_tensor, (x1, x2, e1, e2)), 1.7)
    assert_close(got, jk.gibbs(x1, x2, jnp.asarray(e1), jnp.asarray(e2), 1.7), rtol=1e-10)
    pal = gibbs_pallas(*map(jnp.asarray, (x1, x2, e1, e2)), jnp.asarray(1.7), True)
    assert_close(got, pal, rtol=1e-10)


def test_gibbs_plain_draw_dimension_and_2d_inputs():
    """(S, N) / (S, M) lengthscales give one gram per draw; (N, 2) inputs
    use the exact broadcast distance, as the JAX sq_dist does for d <= 4."""
    r = _rng(1)
    S, n, m = 3, 23, 9
    x1, x2 = r.random((n, 2)), r.random((m, 2))
    e1 = np.exp(0.3 * r.standard_normal((S, n)))
    e2 = np.exp(0.3 * r.standard_normal((S, m)))
    got = ck.gibbs_plain(*map(torch.as_tensor, (x1, x2, e1, e2)), 0.8)
    assert got.shape == (S, n, m)
    for s in range(S):
        want = jk.gibbs(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(e1[s]), jnp.asarray(e2[s]), 0.8)
        assert_close(got[s], want, rtol=1e-10)
    # one shared side broadcasts over the draws
    shared = ck.gibbs_plain(*map(torch.as_tensor, (x1, x2, e1, e2[0])), 0.8)
    want = jk.gibbs(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(e1[2]), jnp.asarray(e2[0]), 0.8)
    assert_close(shared[2], want, rtol=1e-10)


def _spd(r, batch, m):
    A = r.standard_normal((batch, m, m))
    return np.einsum("bij,bkj->bik", A, A) + m * np.eye(m)


@pytest.mark.parametrize("batch, m", [(4, 20), (2, 13), (1, 1)])
def test_chol_inv_plain_matches_jax_and_pallas(batch, m):
    S = _spd(_rng(batch * m), batch, m)
    L, Linv = ck.chol_inv_plain(torch.as_tensor(S))
    L_ref, Linv_ref = jl.chol_tri_inv(jnp.asarray(S))
    assert_close(L, L_ref, rtol=1e-10, atol=1e-14)
    assert_close(Linv, Linv_ref, rtol=1e-10, atol=1e-14)
    L_pal, Linv_pal = chol_inv_pallas(jnp.asarray(S), interpret=True)
    assert_close(L, L_pal, rtol=1e-10, atol=1e-14)
    assert_close(Linv, Linv_pal, rtol=1e-10, atol=1e-14)


def test_chol_inv_plain_nan_semantics_match_jnp_cholesky():
    """A member that is not positive-definite gets NaN exactly where the
    JAX path (`jnp.linalg.cholesky` + triangular solve) puts it: L's lower
    triangle and all of L^-1.  The Pallas body instead returns finite
    garbage from its clamped pivot, which the robust retry cannot see."""
    r = _rng(7)
    S = _spd(r, 3, 6)
    S[1] = np.diag([1.0, -2.0, 3.0, 1.0, 1.0, 1.0])
    S[1, 0, 1] = S[1, 1, 0] = 0.5
    L, Linv = ck.chol_inv_plain(torch.as_tensor(S))
    L_ref, Linv_ref = map(np.asarray, jl.chol_tri_inv(jnp.asarray(S)))
    np.testing.assert_array_equal(torch.isnan(L).numpy(), np.isnan(L_ref))
    np.testing.assert_array_equal(torch.isnan(Linv).numpy(), np.isnan(Linv_ref))
    assert np.isnan(L_ref[1]).any() and np.isfinite(L_ref[0]).all()
    assert_close(L[[0, 2]], L_ref[[0, 2]], rtol=1e-10, atol=1e-14)
    assert_close(Linv[[0, 2]], Linv_ref[[0, 2]], rtol=1e-10, atol=1e-14)
    two = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    L2, _ = ck.chol_inv_plain(two)
    np.testing.assert_array_equal(
        torch.isnan(L2).numpy(), np.isnan(np.asarray(jnp.linalg.cholesky(jnp.asarray(two.numpy()))))
    )


@pytest.mark.parametrize("M, N, G", [(24, 70, 5), (16, 300, 3), (9, 1, 1)])
def test_quadform_diag_plain_matches_jax_and_pallas(M, N, G):
    r = _rng(M * N + G)
    A, W = r.standard_normal((M, N)), r.standard_normal((G, M, M))
    got = ck.quadform_diag_plain(torch.as_tensor(A), torch.as_tensor(W))
    assert_close(got, jl._quadform_diag(jnp.asarray(A), jnp.asarray(W)), rtol=1e-10)
    # The Pallas body accumulates in float32 (preferred_element_type) and
    # rejects float64 operands: hold it on float32 inputs, at the tolerance
    # tests/test_pallas.py holds it against the einsum.
    A32, W32 = A.astype(np.float32), W.astype(np.float32)
    pal = quadform_diag_pallas(jnp.asarray(A32), jnp.asarray(W32), True)
    plain32 = ck.quadform_diag_plain(torch.as_tensor(A32, dtype=torch.float64),
                                     torch.as_tensor(W32, dtype=torch.float64))
    assert_close(plain32, pal, rtol=2e-4, atol=2e-4)


def test_quadform_diag_plain_draw_dimension():
    r = _rng(3)
    S, M, N, G = 3, 11, 17, 4
    A, W = r.standard_normal((S, M, N)), r.standard_normal((S, G, M, M))
    got = ck.quadform_diag_plain(torch.as_tensor(A), torch.as_tensor(W))
    assert got.shape == (S, G, N)
    for s in range(S):
        assert_close(got[s], jl._quadform_diag(jnp.asarray(A[s]), jnp.asarray(W[s])), rtol=1e-10)


def test_wrappers_take_the_plain_version_on_cpu_without_launching():
    """On CPU tensors `pick` gives each op its plain version, which runs
    without a launch; the kernel wrapper itself refuses a CPU tensor."""
    r = _rng(4)
    before = dict(ck.LAUNCHES)
    x = torch.as_tensor(np.sort(r.random(8)))
    ell = torch.ones(8, dtype=torch.float64)
    K = torch.as_tensor(_spd(r, 2, 5))
    A, W = torch.as_tensor(r.standard_normal((5, 6))), torch.as_tensor(r.standard_normal((2, 5, 5)))
    for name, args in (("gibbs", (x, x, ell, ell)), ("chol_inv", (K,)), ("quadform_diag", (A, W))):
        for dtype in (torch.float64, torch.float32):
            cpu = tuple(a.to(dtype) for a in args)
            plain = getattr(ck, f"{name}_plain")
            assert ck.pick(name, *cpu) is plain
            got, want = ck.pick(name, *cpu)(*cpu), plain(*cpu)
            for a, b in zip(*((t,) if torch.is_tensor(t) else t for t in (got, want))):
                assert torch.equal(a, b)
            with pytest.raises(TypeError, match="CUDA float32"):
                getattr(ck, f"{name}_cuda")(*cpu)
    assert ck.LAUNCHES == before
