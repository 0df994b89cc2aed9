"""The backward of the variance quadratic form on the CPU: the plain
versions of the two backward kernels and of the fused one (both gradients
from one C), and the gradients of the port's `_quadform_diag` autograd
Function, against the JAX package.

W is lower-triangular, as on the path (W = Lp^-1 @ tril(sqrt)).  dA is held
whole; dW on its lower triangle, the part the kernel computes (its strict
upper part reaches no parameter; `quadform_diag_dw_cuda`).  In float64 the
reference is `jax.vjp` of the JAX `_quadform_diag` (the einsum the training
path runs), rtol 1e-10.  The Pallas kernels' VJP (`_qf_bwd_rule`) runs in
interpret mode too, but its bodies accumulate in float32 and refuse float64
operands, so it is held on float32 inputs at the tolerance
`tests/test_pallas.py` uses for it.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import linalg as jl
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops.pallas_kernels import (
    quadform_diag_pallas,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import linalg as tl
from torch_port_helpers import assert_close

torch.set_num_threads(1)
T = torch.as_tensor


def _inputs(M, N, G, seed, S=None):
    r = np.random.default_rng(seed)
    lead = () if S is None else (S,)
    A = r.standard_normal(lead + (M, N))
    W = np.tril(r.standard_normal(lead + (G, M, M)))
    vbar = r.standard_normal(lead + (G, N))
    return A, W, vbar


def _jax_vjp(A, W, vbar):
    _, vjp = jax.vjp(jl._quadform_diag, jnp.asarray(A), jnp.asarray(W))
    return vjp(jnp.asarray(vbar))


def _lower(x):
    return np.tril(np.asarray(x))


@pytest.mark.parametrize("M, N, G", [(12, 40, 10), (5, 1, 3), (1, 7, 1)])
def test_plain_backward_matches_jax_vjp(M, N, G):
    A, W, vbar = _inputs(M, N, G, seed=M + N + G)
    dA_ref, dW_ref = _jax_vjp(A, W, vbar)
    dA = ck.quadform_diag_da_plain(T(A), T(W), T(vbar))
    dW = ck.quadform_diag_dw_plain(T(A), T(W), T(vbar))
    assert_close(dA, dA_ref, rtol=1e-10, atol=1e-13)
    assert_close(dW, _lower(dW_ref), rtol=1e-10, atol=1e-13)
    assert not np.triu(dW.numpy(), 1).any()  # zeros above the diagonal


def test_plain_backward_with_a_draw_dimension():
    S, M, N, G = 3, 9, 17, 4
    A, W, vbar = _inputs(M, N, G, seed=3, S=S)
    dA = ck.quadform_diag_da_plain(T(A), T(W), T(vbar))
    dW = ck.quadform_diag_dw_plain(T(A), T(W), T(vbar))
    assert dA.shape == (S, M, N) and dW.shape == (S, G, M, M)
    for s in range(S):
        dA_ref, dW_ref = _jax_vjp(A[s], W[s], vbar[s])
        assert_close(dA[s], dA_ref, rtol=1e-10, atol=1e-13)
        assert_close(dW[s], _lower(dW_ref), rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("S", [None, 2])
def test_autograd_function_matches_jax_vjp(S):
    """The gradients autograd gives through `_quadform_diag`, with an
    expanded (non-contiguous) cotangent."""
    A, W, vbar = _inputs(12, 40, 10, seed=7, S=S)
    At = torch.tensor(A, requires_grad=True)
    Wt = torch.tensor(W, requires_grad=True)
    V = tl._quadform_diag(At, Wt)
    v_row = T(vbar[..., :1, :])
    V.backward(v_row.expand_as(V))
    v_full = np.broadcast_to(vbar[..., :1, :], V.shape)
    if S is None:
        dA_ref, dW_ref = _jax_vjp(A, W, v_full)
        assert_close(V.detach(), jl._quadform_diag(jnp.asarray(A), jnp.asarray(W)), rtol=1e-10)
    else:
        refs = [_jax_vjp(A[s], W[s], v_full[s]) for s in range(S)]
        dA_ref, dW_ref = np.stack([r[0] for r in refs]), np.stack([r[1] for r in refs])
    assert_close(At.grad, dA_ref, rtol=1e-10, atol=1e-13)
    assert_close(Wt.grad, _lower(dW_ref), rtol=1e-10, atol=1e-13)


def test_parameter_gradients_through_a_lower_triangular_product():
    """W = Lp_inv @ tril(sqrt), as on the path: the gradients of Lp_inv's
    and sqrt's lower triangles equal the dense autodiff's, though dW keeps
    only its lower triangle.  Parameter gradients, so rtol 1e-8."""
    r = np.random.default_rng(11)
    M, N, G = 8, 30, 5
    A = r.standard_normal((M, N))
    Lp_inv = np.tril(r.standard_normal((M, M)))
    sq = r.standard_normal((G, M, M))

    def jf(A, Lp_inv, sq):
        W = jl.tril_mask(Lp_inv) @ jl.tril_mask(sq)
        return jnp.sum(jnp.sin(jl._quadform_diag(A, W)))

    want = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (A, Lp_inv, sq)))
    got = [torch.tensor(a, requires_grad=True) for a in (A, Lp_inv, sq)]
    W = tl.tril_mask(got[1]) @ tl.tril_mask(got[2])
    torch.sin(tl._quadform_diag(got[0], W)).sum().backward()
    for g, w in zip(got, want):
        assert_close(g.grad, w, rtol=1e-8, atol=1e-12)


def test_gradcheck_float64():
    """Finite differences agree with the Function's backward; W is built
    lower-triangular from a free matrix, as on the path."""
    r = np.random.default_rng(5)
    A = torch.tensor(r.standard_normal((2, 6, 9)), requires_grad=True)
    S = torch.tensor(r.standard_normal((2, 3, 6, 6)), requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, s: tl._quadform_diag(a, s.tril()), (A, S))


def test_plain_backward_matches_the_pallas_vjp_in_interpret_mode():
    """The Pallas VJP (`_qf_bwd_rule`: the dW and dA pallas_calls) on
    float32 inputs, against the plain backward in float64 on the same
    values, at test_pallas.py's tolerance for the kernel's f32 sums."""
    A, W, vbar = (a.astype(np.float32) for a in _inputs(12, 40, 10, seed=9))
    _, vjp = jax.vjp(lambda a, w: quadform_diag_pallas(a, w, True), jnp.asarray(A), jnp.asarray(W))
    dA_pal, dW_pal = vjp(jnp.asarray(vbar))
    A64, W64, v64 = (T(a, dtype=torch.float64) for a in (A, W, vbar))
    assert_close(ck.quadform_diag_da_plain(A64, W64, v64), dA_pal, rtol=2e-4, atol=2e-4)
    assert_close(ck.quadform_diag_dw_plain(A64, W64, v64), _lower(dW_pal), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("M, N, G, S", [(12, 40, 10, None), (5, 1, 3, None), (1, 7, 1, None),
                                        (9, 17, 4, 3), (16, 33, 2, 2)])
def test_fused_plain_backward_matches_the_pair_and_jax_vjp(M, N, G, S):
    """`quadform_diag_bwd_plain` returns the pair's (dA, dW) and the JAX VJP's
    (dW on its lower triangle) in float64, with and without a draw
    dimension S."""
    A, W, vbar = _inputs(M, N, G, seed=M + N + G, S=S)
    dA, dW = ck.quadform_diag_bwd_plain(T(A), T(W), T(vbar))
    assert_close(dA, ck.quadform_diag_da_plain(T(A), T(W), T(vbar)), rtol=1e-12, atol=1e-14)
    assert_close(dW, ck.quadform_diag_dw_plain(T(A), T(W), T(vbar)), rtol=1e-12, atol=1e-14)
    assert not np.triu(dW.numpy(), 1).any()
    for s in [None] if S is None else range(S):
        at = (lambda x: x) if s is None else (lambda x: x[s])
        dA_ref, dW_ref = _jax_vjp(at(A), at(W), at(vbar))
        assert_close(at(dA), dA_ref, rtol=1e-10, atol=1e-13)
        assert_close(at(dW), _lower(dW_ref), rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("S", [None, 2])
def test_autograd_function_takes_the_fused_plain_backward_on_cpu(S):
    """With both gradients needed, `_quadform_diag`'s backward on CPU
    tensors is one call of the fused route's plain version: no kernel is
    launched and neither backward kernel's plain version runs apart."""
    A, W, vbar = _inputs(7, 13, 3, seed=4, S=S)
    At = torch.tensor(A, requires_grad=True)
    Wt = torch.tensor(W, requires_grad=True)
    calls = []
    real = ck.quadform_diag_bwd_plain

    def fused(*args):
        calls.append("quadform_diag_bwd")
        return real(*args)

    before = dict(ck.LAUNCHES)
    with mock.patch.object(ck, "quadform_diag_bwd_plain", fused), \
            mock.patch.object(ck, "quadform_diag_dw_plain", side_effect=AssertionError), \
            mock.patch.object(ck, "quadform_diag_da_plain", side_effect=AssertionError):
        tl._quadform_diag(At, Wt).backward(T(vbar))
    assert calls == ["quadform_diag_bwd"] and ck.LAUNCHES == before
    dA, dW = real(T(A), T(W), T(vbar))
    assert torch.equal(At.grad, dA) and torch.equal(Wt.grad, dW)


def test_backward_wrappers_take_the_plain_versions_on_cpu_without_launching():
    """On CPU tensors, float32 too, `pick` gives each backward op its plain
    version, which runs without a launch; the wrappers refuse them."""
    before = dict(ck.LAUNCHES)
    for dtype in (torch.float64, torch.float32):
        A, W, vbar = (T(a).to(dtype) for a in _inputs(6, 11, 3, seed=1))
        for name in ("quadform_diag_dw", "quadform_diag_da", "quadform_diag_bwd"):
            plain = getattr(ck, f"{name}_plain")
            assert ck.pick(name, A, W, vbar) is plain
            got, want = ck.pick(name, A, W, vbar)(A, W, vbar), plain(A, W, vbar)
            for a, b in zip(*((t,) if torch.is_tensor(t) else t for t in (got, want))):
                assert torch.equal(a, b)
            with pytest.raises(TypeError, match="CUDA float32"):
                getattr(ck, f"{name}_cuda")(A, W, vbar)
    assert ck.LAUNCHES == before
    assert {"quadform_diag_dw", "quadform_diag_da", "quadform_diag_bwd"} <= set(ck.KERNELS)
    assert set(ck.KERNELS) == set(ck.LAUNCHES) == set(ck._ARGTYPES)
