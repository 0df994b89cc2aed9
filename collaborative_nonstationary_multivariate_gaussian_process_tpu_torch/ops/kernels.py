"""Covariance kernels: stationary RBF and the Gibbs nonstationary kernel.

Same formulas as the JAX package's `ops/kernels.py:33-148` (reference
`create_RBF` / `create_Gibbs` / `Nonstationary_RBF_cov`, code/utils.py:75-103,
SIM_code/Utility/kernels.py:46-73).  `rbf` and `gibbs` go through the
hand-written RBF and Gibbs kernels (`ops.cuda_kernels.rbf_cuda`,
`gibbs_cuda`) for CUDA float32 tensors of the dimensions they take, the
plain versions otherwise (`cuda_kernels.use_kernel`), and their backwards
are the closed forms of the JAX package's `_rbf_bwd` and `_gibbs_bwd`
(pallas_kernels.py:121-178), there in plain jnp as here.  Both take a
leading chain (or draw) axis on their scale and lengthscale arguments.
"""

from __future__ import annotations

import torch

from . import cuda_kernels

__all__ = ["sq_dist", "rbf", "gibbs", "nonstationary_rbf"]


def _as_points(x):
    """(N,) -> (N, 1); (N, d) unchanged.  Inputs are rows of points."""
    return x[:, None] if x.ndim == 1 else x


def sq_dist(x1, x2):
    """Pairwise squared Euclidean distances, (N1, d) x (N2, d) -> (N1, N2).

    For d <= 4 the exact broadcast difference, like the reference: the
    ||a||^2 + ||b||^2 - 2 a.b expansion loses ~eps ||x||^2 absolute accuracy
    to cancellation, which at large input scales reaches the Cholesky
    jitter and makes f32 grams indefinite.  For d > 4 the expansion is
    kept, input-centred and clamped at zero.
    """
    x1 = _as_points(x1)
    x2 = _as_points(x2)
    if x1.shape[-1] <= 4:
        diff = x1[:, None, :] - x2[None, :, :]
        return torch.sum(diff * diff, dim=-1)
    c = 0.5 * (x1.mean(dim=0) + x2.mean(dim=0))
    x1 = x1 - c
    x2 = x2 - c
    n1 = torch.sum(x1 * x1, dim=-1)[:, None]
    n2 = torch.sum(x2 * x2, dim=-1)[None, :]
    return torch.clamp(n1 + n2 - 2.0 * (x1 @ x2.T), min=0.0)


class _RBF(torch.autograd.Function):
    """The RBF gram by the kernel; the backward in closed form (the JAX
    package's `_rbf_bwd`, for any input dimension and per-pair scales),
    with E = exp(-r2 / 2) and r2 = sq_dist(x1 / l, x2 / l):

      dk/ds = E,   dk/dl = k r2 / l,   dk/dx1 = -k (x1 - x2) / l^2 = -dk/dx2

    A scale or lengthscale that is a Python float gets no gradient; a (S,)
    one gets the sum over its gram."""

    @staticmethod
    def forward(ctx, x1, x2, scale2, length_scale):
        K = cuda_kernels.pick("rbf", x1, x2, scale2, length_scale)(x1, x2, scale2, length_scale)
        ctx.scale2, ctx.length_scale = scale2, length_scale
        ctx.save_for_backward(x1, x2)
        return K

    @staticmethod
    def backward(ctx, g):
        x1, x2 = ctx.saved_tensors
        need_x1, need_x2, need_s, need_l = ctx.needs_input_grad
        s = cuda_kernels._pair_axis(ctx.scale2)
        l = cuda_kernels._pair_axis(ctx.length_scale)
        r2 = cuda_kernels.scaled_sq_dist(x1, x2, ctx.length_scale)
        gE = g * torch.exp(-0.5 * r2)
        gK = gE * s
        d_x1 = d_x2 = d_s = d_l = None
        if need_s:
            d_s = _sum_to_param(gE, ctx.scale2)
        if need_l:
            d_l = _sum_to_param(gK * r2 / l, ctx.length_scale)
        if need_x1 or need_x2:
            p1, p2 = _as_points(x1), _as_points(x2)
            if p1.shape[-1] <= 4:  # the exact scaled difference, as sq_dist has it
                D = (p1 / l)[..., :, None, :] - (p2 / l)[..., None, :, :]
                w = (-gK / l)[..., None] * D  # (..., N1, N2, d); the pairs share the inputs
                d_x1 = w.sum(-2).sum_to_size(p1.shape).reshape(x1.shape)
                d_x2 = (-w.sum(-3)).sum_to_size(p2.shape).reshape(x2.shape)
            else:
                c = (-gK / (l * l)).sum_to_size(r2.shape[-2:])
                d_x1 = (c.sum(1)[:, None] * p1 - c @ p2).reshape(x1.shape)
                d_x2 = (c.sum(0)[:, None] * p2 - c.T @ p1).reshape(x2.shape)
        return d_x1, d_x2, d_s, d_l


def _sum_to_param(t, param):
    """A gram-shaped cotangent summed to the shape of a scale or lengthscale
    tensor: per pair for (S,), to a scalar for a 0-d one."""
    return t.sum(dim=(-2, -1)).sum_to_size(param.shape)


def rbf(x1, x2, scale2=1.0, length_scale=1.0):
    """K(x,x') = scale2 * exp(-0.5 ||x-x'||^2 / length_scale^2); the inputs
    are divided by the length scale before the distance, as `create_RBF`
    does.  No diagonal jitter.  scale2 and length_scale are scalars (floats
    or 0-d tensors) or (S,) tensors of per-chain pairs, giving (S, N1, N2).
    Differentiable in every tensor argument (see `_RBF`); the CUDA kernel
    takes 1-D inputs."""
    return _RBF.apply(x1, x2, scale2, length_scale)


class _Gibbs(torch.autograd.Function):
    """The Gibbs gram by the kernel; the backward in closed form, with
    A = l1^2 + l2^2 and d^2 = sq_dist(x1, x2) (any input dimension):

      dk/dl1 = k (0.5 / l1 - l1 / A + 2 l1 d^2 / A^2)   (and l2 alike)
      dk/dx1 = k (-2 / A) (x1 - x2),   dk/dx2 = -dk/dx1,   dk/ds = k / s

    Lengthscale gradients are summed back to each lengthscale's shape (a
    side without the draw dimension is shared by the draws); an input that
    needs no gradient (x and Z are data) gets None.  A tensor passed as
    both sides gets the sum of both contributions from autograd."""

    @staticmethod
    def forward(ctx, x1, x2, ell1, ell2, scale2):
        K = cuda_kernels.pick("gibbs", x1, x2, ell1, ell2, scale2)(x1, x2, ell1, ell2, scale2)
        ctx.scale2 = scale2
        ctx.save_for_backward(x1, x2, ell1, ell2, K)
        return K

    @staticmethod
    def backward(ctx, g):
        x1, x2, ell1, ell2, K = ctx.saved_tensors
        need_x1, need_x2, need_l1, need_l2, need_s = ctx.needs_input_grad
        gK = g * K
        a = ell1[..., :, None]
        b = ell2[..., None, :]
        invA = 1.0 / (a * a + b * b)
        d2 = sq_dist(x1, x2)
        d_x1 = d_x2 = d_l1 = d_l2 = d_s = None
        if need_l1:
            d_l1 = torch.sum(gK * (0.5 / a - a * invA + 2.0 * a * d2 * invA * invA), dim=-1)
            d_l1 = d_l1.sum_to_size(ell1.shape)
        if need_l2:
            d_l2 = torch.sum(gK * (0.5 / b - b * invA + 2.0 * b * d2 * invA * invA), dim=-2)
            d_l2 = d_l2.sum_to_size(ell2.shape)
        if need_x1 or need_x2:
            c = (gK * (-2.0 * invA)).sum_to_size(d2.shape)  # the inputs are shared by draws
            p1, p2 = _as_points(x1), _as_points(x2)
            d_x1 = (c.sum(1)[:, None] * p1 - c @ p2).reshape(x1.shape)
            d_x2 = (c.sum(0)[:, None] * p2 - c.T @ p1).reshape(x2.shape)
        if need_s:
            d_s = torch.sum(gK) / ctx.scale2
        return d_x1, d_x2, d_l1, d_l2, d_s


def gibbs(x1, x2, ell1, ell2, scale2=1.0):
    """Gibbs nonstationary kernel with input-dependent lengthscale,

      k(x,x') = scale2 * sqrt(2 l(x) l(x') / (l(x)^2 + l(x')^2))
                       * exp(-||x-x'||^2 / (l(x)^2 + l(x')^2)).

    ell1 (N1,) or (S, N1) and ell2 (N2,) or (S, N2): a leading draw
    dimension S on either gives (S, N1, N2), one gram per draw sharing x.
    Differentiable in every argument (see `_Gibbs`).
    """
    return _Gibbs.apply(x1, x2, ell1, ell2, scale2)


def nonstationary_rbf(x1, x2=None, sigma1=None, ell1=None, sigma2=None, ell2=None):
    """Gibbs kernel with an input-dependent signal magnitude as well,

      k(x,x') = s(x) s(x') sqrt(2 l(x) l(x') / (l^2 + l'^2)) exp(-d^2 / (l^2 + l'^2)),

    the JAX `nonstationary_rbf` (ops/kernels.py:122-148; no diagonal jitter:
    the log-density callers add it).  sigma and ell may carry a leading
    chain axis, (C, N), giving (C, N1, N2); the Gibbs gram of all chains is
    one launch."""
    p1 = _as_points(x1)
    n1 = p1.shape[0]
    ones = lambda n: torch.ones(n, dtype=p1.dtype, device=p1.device)  # noqa: E731
    ell1 = ones(n1) if ell1 is None else ell1
    sigma1 = ones(n1) if sigma1 is None else sigma1
    if x2 is None:
        x2, sigma2, ell2 = x1, sigma1, ell1
    else:
        n2 = _as_points(x2).shape[0]
        ell2 = ones(n2) if ell2 is None else ell2
        sigma2 = ones(n2) if sigma2 is None else sigma2
    amp = sigma1[..., :, None] * sigma2[..., None, :]
    return amp * gibbs(x1, x2, ell1, ell2, 1.0)
