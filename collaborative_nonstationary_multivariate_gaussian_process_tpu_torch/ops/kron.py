"""Kronecker-structured covariance algebra.

The JAX package's `ops/kron.py:24-79` (reference `kronecker_operation.py`),
each function taking an optional leading chain axis.  `kron_mv` goes
through the hand-written Kronecker-matvec kernel
(`ops.cuda_kernels.kron_mv_cuda`) for CUDA float32 tensors (the plain
version otherwise, `cuda_kernels.use_kernel`); its gradient in y goes
through the same kernel, and those in the two factors are plain matmuls, as
JAX autodiff computes them outside any Pallas kernel.  `eigh` stays a
library call (`jnp.linalg.eigh` in JAX, not a Pallas kernel).
"""

from __future__ import annotations

import torch

from . import cuda_kernels

__all__ = ["kron", "kron_diag", "kron_mv", "eigh", "kron_eigh", "kron_inv", "kron_logdet"]


def kron(a, b):
    """Dense Kronecker product of the last two dims, (..., M1, M2) x (...,
    N1, N2) -> (..., M1 N1, M2 N2) (`jnp.kron` for 2-D operands)."""
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    lead = out.shape[:-4]
    return out.reshape(lead + (a.shape[-2] * b.shape[-2], a.shape[-1] * b.shape[-1]))


def kron_diag(d1, d2):
    """diag(D1 kron D2) from the two diagonals, (..., M) x (..., N) -> (..., M N)."""
    out = d1[..., :, None] * d2[..., None, :]
    return out.reshape(out.shape[:-2] + (-1,))


class _KronMV(torch.autograd.Function):
    """out = vec(A^T) with A = K Y B^T, Y = y reshaped (M2, N2) and
    transposed.  With G the cotangent reshaped as A: dy = kron_mv(B^T, K^T,
    g) through the same kernel, dK = G B Y^T and dB = G^T K Y as matmuls;
    each summed back to its operand's shape (a side without the chain axis
    is shared by the chains)."""

    @staticmethod
    def forward(ctx, B, K, y):
        ctx.save_for_backward(B, K, y)
        return cuda_kernels.pick("kron_mv", B, K, y)(B, K, y)

    @staticmethod
    def backward(ctx, g):
        B, K, y = ctx.saved_tensors
        need_B, need_K, need_y = ctx.needs_input_grad
        (m1, m2), (n1, n2) = B.shape[-2:], K.shape[-2:]
        dB = dK = dy = None
        if need_y:
            Bt, Kt = B.transpose(-1, -2), K.transpose(-1, -2)
            dy = cuda_kernels.pick("kron_mv", Bt, Kt, g)(Bt, Kt, g)
            dy = dy.sum_to_size(y.shape)
        if need_B or need_K:
            G = g.reshape(g.shape[:-1] + (m1, n1)).transpose(-1, -2)  # (..., N1, M1)
            Y = y.reshape(y.shape[:-1] + (m2, n2)).transpose(-1, -2)  # (..., N2, M2)
            if need_K:
                dK = (G @ B @ Y.transpose(-1, -2)).sum_to_size(K.shape)
            if need_B:
                dB = (G.transpose(-1, -2) @ K @ Y).sum_to_size(B.shape)
        return dB, dK, dy


def kron_mv(B, K, y):
    """(B kron K) y without forming the product: B (..., M1, M2), K (...,
    N1, N2), y (..., M2 N2) task-major (task blocks of length N2, the
    reference's `Y.t().contiguous().view(-1)`).  Returns (..., M1 N1)."""
    return _KronMV.apply(B, K, y)


def eigh(A):
    """`torch.linalg.eigh` of symmetric A (..., N, N) with `jnp.linalg.eigh`'s
    handling of a non-finite member: NaN eigenvalues and eigenvectors for it
    instead of an error (LAPACK and cuSOLVER refuse NaN input), the other
    members unchanged."""
    bad = ~torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    w, v = torch.linalg.eigh(torch.where(bad[..., None, None], eye, A))
    nan = float("nan")
    return (torch.where(bad[..., None], torch.full_like(w, nan), w),
            torch.where(bad[..., None, None], torch.full_like(v, nan), v))


def kron_eigh(B, K):
    """Eigendecompositions of both factors: (w_B, v_B), (w_K, v_K) with
    B kron K = (v_B kron v_K) diag(w_B kron w_K) (v_B kron v_K)^T."""
    return eigh(B), eigh(K)


def kron_inv(sigma2, B, K):
    """(sigma2 I + B kron K)^-1, dense (oracle and tiny problems)."""
    (w_B, v_B), (w_K, v_K) = kron_eigh(B, K)
    U = kron(v_B, v_K)
    t = kron_diag(w_B, w_K)
    return (U * (1.0 / (t + sigma2))[..., None, :]) @ U.transpose(-1, -2)


def kron_logdet(sigma2, B, K):
    """log det(sigma2 I + B kron K) from the factors' eigenvalues."""
    w_B = torch.linalg.eigvalsh(B)
    w_K = torch.linalg.eigvalsh(K)
    return torch.sum(torch.log(kron_diag(w_B, w_K) + sigma2), dim=-1)
