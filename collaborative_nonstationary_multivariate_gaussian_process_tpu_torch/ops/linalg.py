"""Linear-algebra primitives of the training, serving and fully-Bayesian
paths.

The JAX package's `ops/linalg.py`, every public function of it: the
vec <-> lower-triangle transforms of the flat parameter layouts, the batched
Cholesky (a `torch.autograd.Function` over the Cholesky kernel with the
Murray pullback), masks and regularized factors, reparameterized sampling from explicit standard-normal
tensors, sparse-GP conditioning, the fused Cholesky + triangular inverse and
the whitened forward substitution (each a `torch.autograd.Function` with the
JAX package's matmul-only backward), the whitened coefficient factors with
their KL pieces (a `torch.autograd.Function` over two kernels of the port's
own on the card, a composition of ops elsewhere), the whitened
marginal moments (whose quadratic form is a `torch.autograd.Function` over
the forward and backward quadform kernels), the Gaussian KLs, and the dense
conditioning of the
reference's MGP / JGP / CGP helpers (`mgp_mean_var`, `conditional_mean_cov`,
`joint_sample`, `joint_sample_full`, `conditional_sample`).  Every function
takes an optional leading draw dimension S where the JAX package vmaps over
draws, and a sampler its standard-normal noise as tensors where the JAX one
takes a key.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import DSVI_JITTER
from . import cuda_kernels
from .cuda_kernels import cholesky_nan

__all__ = [
    "add_jitter",
    "vec_to_tril",
    "tril_to_vec",
    "diag_indices_of_trilvec",
    "uvec_to_lvec",
    "lvec_to_uvec",
    "cholesky",
    "tril_mask",
    "tril_regularized",
    "regularized_diag",
    "chol_with_jitter",
    "psd_solve",
    "conditional_projection",
    "mgp_mean",
    "mgp_mean_var",
    "mgp_mean_var_tril",
    "conditional_mean_cov",
    "joint_sample",
    "joint_sample_full",
    "conditional_sample",
    "kl_gaussian",
    "kl_gaussian_chol",
    "sample_diag",
    "sample_full_cov",
    "chol_tri_inv",
    "chol_tri_inv_robust",
    "tri_solve_white",
    "WhitenedFactors",
    "whitened_factors",
    "whiten",
    "mgp_mean_var_white",
    "mgp_moments_white",
    "kl_gaussian_white",
    "kl_gaussian_white_parts",
    "kl_gaussian_ref_compat",
]


def _eye_like(X):
    return torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)


def add_jitter(K, jitter=DSVI_JITTER):
    """K + jitter I on the last two dims."""
    return K + jitter * _eye_like(K)


# ---------------------------------------------------------------------------
# vec <-> lower-triangular transforms (the flat layouts of the log-densities)
# ---------------------------------------------------------------------------


# Index tensors of the tril layout, built once per (n, length, device): a
# log-density evaluates them in every leapfrog, and building them from numpy
# each time would copy host to device each time.
_INDEX_CACHE = {}


def _cached_index(key, build):
    if key not in _INDEX_CACHE:
        _INDEX_CACHE[key] = build()
    return _INDEX_CACHE[key]


def _tril_idx(n, device, offset=0):
    """(rows, cols) of `np.tril_indices(n, offset)` on `device`, built once:
    a host-to-device copy inside a training step would wait on the host,
    and a CUDA graph of the step cannot hold one."""
    def build():
        rows, cols = np.tril_indices(n, offset)
        return torch.as_tensor(rows, device=device), torch.as_tensor(cols, device=device)

    return _cached_index(("tril", n, offset, str(device)), build)


def vec_to_tril(v, n):
    """Length n(n+1)/2 vector (..., T) -> (..., n, n) lower-triangular, in
    the row-major order (0,0), (1,0), (1,1), (2,0), ... (JAX `vec_to_tril`,
    reference `vec2lowtriangle`)."""
    rows, cols = _tril_idx(n, v.device)
    out = v.new_zeros(v.shape[:-1] + (n, n))
    out[..., rows, cols] = v
    return out


def tril_to_vec(L, n=None):
    """Inverse of `vec_to_tril`."""
    rows, cols = _tril_idx(L.shape[-1] if n is None else n, L.device)
    return L[..., rows, cols]


def diag_indices_of_trilvec(n):
    """Positions of the diagonal entries in the length-n(n+1)/2 tril vec
    (`np.cumsum(np.arange(1, n + 1)) - 1`, reference utils.py:12)."""
    return np.cumsum(np.arange(1, n + 1)) - 1


def _diag_mask(n, length, device):
    def build():
        mask = np.zeros(length, dtype=bool)
        mask[diag_indices_of_trilvec(n)] = True
        return torch.as_tensor(mask, device=device)

    return _cached_index(("diag", n, length, str(device)), build)


def uvec_to_lvec(uvec, n):
    """Unconstrained tril vec (..., T) -> constrained: exp on the diagonal
    entries (reference `uLvec2Lvec` / `uLvecs2Lvecs`)."""
    mask = _diag_mask(n, uvec.shape[-1], uvec.device)
    return torch.where(mask, torch.exp(uvec), uvec)


def lvec_to_uvec(lvec, n):
    """Inverse transform, log on the diagonal (reference `Lvec2uLvec`); the
    log is guarded on the off-diagonal lanes it does not use."""
    mask = _diag_mask(n, lvec.shape[-1], lvec.device)
    safe = torch.where(mask, torch.clamp(lvec, min=1e-300), torch.ones_like(lvec))
    return torch.where(mask, torch.log(safe), lvec)


# ---------------------------------------------------------------------------
# Batched Cholesky
# ---------------------------------------------------------------------------


class _Cholesky(torch.autograd.Function):
    """Lower Cholesky factor by the kernel; the backward is the Murray (2016)
    pullback of the JAX package's `_chol_bwd` (pallas_kernels.py:406-428),
    K̄ = L^-T sym(Φ) L^-1 with Φ = tril(L^T L̄), diagonal halved, by two
    triangular solves (plain jnp there, plain PyTorch here)."""

    @staticmethod
    def forward(ctx, K):
        L = cuda_kernels.pick("cholesky", K)(K)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        m = L.shape[-1]
        eye = torch.eye(m, dtype=L.dtype, device=L.device)
        phi = (L.transpose(-1, -2) @ Lbar) * (torch.ones_like(eye).tril() - 0.5 * eye)
        sym = 0.5 * (phi + phi.transpose(-1, -2))
        t1 = torch.linalg.solve_triangular(L.transpose(-1, -2), sym, upper=True)
        return torch.linalg.solve_triangular(L, t1, upper=False, left=False)


def cholesky(K):
    """Lower Cholesky factor of SPD K (..., M, M) through the Cholesky kernel
    (`cuda_kernels.cholesky_cuda`; the plain version off `use_kernel`'s
    rule: float64 or a CPU tensor), differentiable (Murray pullback).  A
    member that is not numerically positive-definite gets NaN in its lower
    triangle, as `jnp.linalg.cholesky` gives, instead of an error."""
    return _Cholesky.apply(K)


def tril_mask(X):
    """Zero out the strict upper triangle of the last two dims (by a
    multiply, as the JAX package does, so a non-finite entry stays so)."""
    n, m = X.shape[-2], X.shape[-1]
    return X * torch.ones((n, m), dtype=X.dtype, device=X.device).tril()


def tril_regularized(X, jitter=DSVI_JITTER):
    """Lower-triangular factor with a jitter-regularized diagonal:
    tril(X) with diag d -> sign(d) sqrt(d^2 + jitter), so the q covariance
    is exactly L L^T and |diag| >= sqrt(jitter)."""
    d = torch.diagonal(X, dim1=-2, dim2=-1)
    sign = torch.where(d >= 0, 1.0, -1.0).to(X.dtype)  # +-1 exact in any dtype
    d_reg = sign * torch.sqrt(d * d + jitter)
    eye = torch.eye(X.shape[-1], dtype=torch.bool, device=X.device)
    return torch.where(eye, d_reg[..., :, None] * eye, tril_mask(X))


def regularized_diag(X, jitter=DSVI_JITTER):
    """|diag| of `tril_regularized(X, jitter)`: sqrt(diag(X)^2 + jitter)."""
    d = torch.diagonal(X, dim1=-2, dim2=-1)
    return torch.sqrt(d * d + jitter)


def chol_with_jitter(K, jitter=DSVI_JITTER):
    """Lower Cholesky factor of K + jitter I.  A factor that fails gives NaN,
    as `jnp.linalg.cholesky` does, instead of an error."""
    return cholesky_nan(K + jitter * _eye_like(K))[0]


def psd_solve(K, B, jitter=DSVI_JITTER):
    """Solve (K + jitter I) X = B through a Cholesky factor (NaN where the
    factor fails, see `chol_with_jitter`)."""
    return torch.cholesky_solve(B, chol_with_jitter(K, jitter))


def conditional_projection(K12, K22, jitter=DSVI_JITTER):
    """P = K12 (K22 + jitter I)^{-1}, shape (N, M)."""
    return psd_solve(K22, K12.transpose(-1, -2), jitter).transpose(-1, -2)


def mgp_mean(P, mu):
    """Posterior mean P mu: P (N, M), mu (..., M) -> (..., N)."""
    return torch.einsum("nm,...m->...n", P, mu)


def mgp_mean_var(P, K12, d11, mu, Sigma):
    """Marginalized sparse-GP mean and variance from the projection P
    (reference `MGP_d` / `MGP_mu_sigma2`): mean = P mu, var = max(d11 -
    sum(P K12, -1), 0) + diag(P Sigma P^T).  P, K12 (N, M); d11 (N,); mu
    (..., M); Sigma (..., M, M).  Returns mean and var (..., N)."""
    mean = torch.einsum("nm,...m->...n", P, mu)
    base = torch.clamp(d11 - torch.sum(P * K12, dim=-1), min=0.0)
    corr = torch.einsum("nm,...mk,nk->...n", P, Sigma, P)
    return mean, base + corr


def mgp_mean_var_tril(P, K12, d11, mu, scale_tril):
    """`mgp_mean_var` from the factor L of Sigma = L L^T: diag(P Sigma P^T)
    as the rowwise ||P L||^2.  scale_tril (..., M, M) lower-triangular."""
    mean = torch.einsum("nm,...m->...n", P, mu)
    base = torch.clamp(d11 - torch.sum(P * K12, dim=-1), min=0.0)
    A = torch.einsum("nm,...mk->...nk", P, scale_tril)
    return mean, base + torch.sum(A * A, dim=-1)


def conditional_mean_cov(K12, K22, mu, Sigma, K11, jitter=DSVI_JITTER):
    """The full marginalized conditional (reference `MGP`): with P = K12
    (K22 + jitter I)^-1, mean = P mu and cov = K11 - P K12^T + P Sigma
    P^T.  mu (..., M), Sigma (..., M, M); returns mean (..., N), cov (...,
    N, N)."""
    P = conditional_projection(K12, K22, jitter)
    mean = torch.einsum("nm,...m->...n", P, mu)
    cov = K11 - P @ K12.transpose(-1, -2) + torch.einsum("nm,...mk,lk->...nl", P, Sigma, P)
    return mean, cov


def joint_sample(K12, K22, mu, scale_tril, K11_diag, z_v1, z_v2, z_f, jitter=DSVI_JITTER):
    """A joint draw (f(X), v) (reference `JGP_S`): v = `sample_full_cov(mu,
    scale_tril, z_v1, z_v2, jitter)`, then f | v from the diagonal
    conditional, mean P v and variance max(K11_diag - sum(P K12), 0), by
    `sample_diag` with z_f.  The JAX function splits its key into (k_v,
    k_f) and k_v into the halves of `sample_full_cov`.  z_v1, z_v2 (...,
    M) and z_f (..., N); returns (f (..., N), v (..., M))."""
    v = sample_full_cov(mu, scale_tril, z_v1, z_v2, jitter)
    P = conditional_projection(K12, K22, jitter)
    var = torch.clamp(K11_diag - torch.sum(P * K12, dim=-1), min=0.0)
    return sample_diag(mgp_mean(P, v), var, z_f, jitter), v


def joint_sample_full(K12, K22, K11, mu, scale_tril, z_v1, z_v2, z_f, jitter=DSVI_JITTER):
    """The full-covariance joint draw (reference `JGP`): v as in
    `joint_sample`, then f = P v + chol(B + jitter I) z_f with B = K11 - P
    K12^T symmetrized; one (N, N) factorization, not the (N + M)^2 joint.
    Noise and results as `joint_sample`."""
    v = sample_full_cov(mu, scale_tril, z_v1, z_v2, jitter)
    P = conditional_projection(K12, K22, jitter)
    B = K11 - P @ K12.transpose(-1, -2)
    Lb = chol_with_jitter(0.5 * (B + B.transpose(-1, -2)), jitter)
    return mgp_mean(P, v) + mgp_mean(Lb, z_f), v


def conditional_sample(K12, K22, v, K11_diag, z, jitter=DSVI_JITTER):
    """f | v from the diagonal conditional given fixed inducing values v
    (reference `CGP`), by `sample_diag` with z (..., N)."""
    P = conditional_projection(K12, K22, jitter)
    var = torch.clamp(K11_diag - torch.sum(P * K12, dim=-1), min=0.0)
    return sample_diag(mgp_mean(P, v), var, z, jitter)


def kl_gaussian(mu_q, scale_tril_q, mu_p, K_p, jitter=DSVI_JITTER):
    """KL(N(mu_q, Lq Lq^T + jitter I) || N(mu_p, K_p + jitter I)), batched
    over the leading dims of mu_q and scale_tril_q (reference
    `KL_Gaussian`, its jitter on both sides included).  Returns (...,)."""
    return kl_gaussian_chol(mu_q, scale_tril_q, mu_p, chol_with_jitter(K_p, jitter), jitter)


def kl_gaussian_chol(mu_q, scale_tril_q, mu_p, Lp, jitter=DSVI_JITTER, exact_logdet=True):
    """`kl_gaussian` from the prior's factor Lp = chol(K_p + jitter I).  The
    trace term is ||Lp^-1 Lq||_F^2 + jitter ||Lp^-1||_F^2.  `exact_logdet`
    takes logdet(Lq Lq^T + jitter I) from its Cholesky factor; False takes
    sum(log(diag(Lq)^2 + jitter)), exact only at jitter 0 (the JAX
    package's cheaper approximation, kept for its callers)."""
    m = mu_q.shape[-1]
    if exact_logdet:
        Lq = chol_with_jitter(scale_tril_q @ scale_tril_q.transpose(-1, -2), jitter)
        logdet_q = torch.sum(torch.log(torch.diagonal(Lq, dim1=-2, dim2=-1)), dim=-1)
    else:
        dq = torch.diagonal(scale_tril_q, dim1=-2, dim2=-1)
        logdet_q = 0.5 * torch.sum(torch.log(dq * dq + jitter), dim=-1)
    logdet_p = torch.sum(torch.log(torch.diagonal(Lp, dim1=-2, dim2=-1)), dim=-1)
    A = torch.linalg.solve_triangular(Lp, scale_tril_q, upper=False)
    Lp_inv = torch.linalg.solve_triangular(Lp, _eye_like(Lp), upper=False)
    trace_term = torch.sum(A * A, dim=(-2, -1)) + jitter * torch.sum(Lp_inv * Lp_inv)
    diff = (mu_p - mu_q)[..., None]
    sol = torch.linalg.solve_triangular(Lp, diff, upper=False)[..., 0]
    maha = torch.sum(sol * sol, dim=-1)
    return (logdet_p - logdet_q) + 0.5 * (trace_term + maha - m)


def sample_diag(mean, var, z, jitter=DSVI_JITTER):
    """mean + sqrt(var + jitter) * z, elementwise; z is standard normal of
    the broadcast shape (the JAX version draws it from a key)."""
    return mean + z * torch.sqrt(var + jitter)


def sample_full_cov(mean, scale_tril, z1, z2=None, jitter=DSVI_JITTER):
    """Draw from N(mean, L L^T + jitter I) as mean + L z1 + sqrt(jitter) z2.

    mean (M,), scale_tril (M, M), z1 and z2 (..., M) standard normal.  At
    `jitter == 0.0` (a float) z2 is not used and may be None, matching the
    JAX version, which skips that draw there.
    """
    out = mean + torch.matmul(scale_tril, z1[..., None])[..., 0]
    if isinstance(jitter, float) and jitter == 0.0:
        return out
    return out + math.sqrt(jitter) * z2


class _CholTriInv(torch.autograd.Function):
    """(L, L^-1) by the fused kernel; the backward is the JAX package's
    matmul-only `_chol_tri_inv_bwd` (ops/linalg.py:262-276): the inverse's
    pullback -L^-T Linvbar L^-T joins Lbar, then the Cholesky pullback
    K̄ = L^-T sym(Φ) L^-1 with Φ = tril(L^T L̄), diagonal halved."""

    @staticmethod
    def forward(ctx, K):
        L, Linv = cuda_kernels.pick("chol_inv", K)(K)
        ctx.save_for_backward(L, Linv)
        return L, Linv

    @staticmethod
    def backward(ctx, Lbar, Linvbar):
        L, Linv = ctx.saved_tensors
        LinvT = Linv.transpose(-1, -2)
        Lbar_total = Lbar - LinvT @ Linvbar @ LinvT
        P = L.transpose(-1, -2) @ Lbar_total
        m = L.shape[-1]
        eye = torch.eye(m, dtype=L.dtype, device=L.device)
        phi = P * (torch.ones_like(eye).tril() - 0.5 * eye)
        sym = 0.5 * (phi + phi.transpose(-1, -2))
        return LinvT @ sym @ Linv


def chol_tri_inv(K):
    """(L, L^{-1}) of SPD K (..., M, M), through the fused kernel
    (`cuda_kernels.chol_inv_cuda`; the plain version off `use_kernel`'s
    rule), differentiable with the matmul-only
    backward.  A float32 member whose float32 factorization fails is factored
    in float64 arithmetic (`chol_inv_plain`); a member that is not
    positive-definite even so gets NaN factors (and NaN gradients, which the
    training step zeroes).  The JAX `chol_tri_inv` gives NaN at the first
    float32 failure."""
    return _CholTriInv.apply(K)


def chol_tri_inv_robust(Ks, jitter, boost=100.0):
    """`chol_tri_inv` with a one-shot deterministic retry: members whose
    factor is not finite are refactored with `boost * jitter` more on the
    diagonal; the others are unchanged.  `Ks` already carries the base
    jitter.  Both factorizations always run (no host sync), as in JAX."""
    L, Linv = chol_tri_inv(Ks)
    bad = ~torch.isfinite(torch.sum(L, dim=(-2, -1), keepdim=True))
    K2 = Ks + (boost * jitter) * bad.to(Ks.dtype) * _eye_like(Ks)
    L2, Linv2 = chol_tri_inv(K2)
    return torch.where(bad, L2, L), torch.where(bad, Linv2, Linv)


class _TriSolveWhite(torch.autograd.Function):
    """A = L^-1 B by forward substitution; the backward is the JAX package's
    `_tsw_bwd` (ops/linalg.py:324-338): B̄ = L^-T Ā and L̄ = tril(-B̄ A^T),
    both matmuls against the given L^-1, which itself gets no cotangent."""

    @staticmethod
    def forward(ctx, L, Linv, B):
        A = torch.linalg.solve_triangular(L, B, upper=False)
        ctx.save_for_backward(Linv, A)
        return A

    @staticmethod
    def backward(ctx, Abar):
        Linv, A = ctx.saved_tensors
        Bbar = Linv.transpose(-1, -2) @ Abar
        Lbar = None
        if ctx.needs_input_grad[0]:
            Lbar = torch.tril(-Bbar @ A.transpose(-1, -2))  # L is triangular
        return Lbar, None, Bbar  # None: the value does not depend on Linv


def tri_solve_white(L, Linv, B):
    """A = L^{-1} B by forward substitution (backward-stable; an explicit
    inverse multiply loses accuracy in the ill-conditioned directions).
    `Linv` = L^{-1} serves the matmul-only backward only.  L (..., M, M);
    B (..., M, N), with the same leading dimensions."""
    return _TriSolveWhite.apply(L, Linv, B)


class WhitenedFactors(NamedTuple):
    """The whitened factors of a parameter's group sets, each field a tuple
    over the sets: W (S, n, M, M) = Lp^-1 @ tril_regularized(sqrt) of the
    set's groups, and the KL pieces trace (S, n) = ||W||_F^2 and logdet_q
    (n) = sum log |diag tril_regularized(sqrt)| (`kl_gaussian_white_parts`).
    The model's `kl_mode="ref_compat"`, whose KL reads neither, whitens the
    raw factors and leaves them None."""

    W: Tuple[torch.Tensor, ...]
    trace: Optional[Tuple[torch.Tensor, ...]]
    logdet_q: Optional[Tuple[torch.Tensor, ...]]


def whiten(T, Lp_invs, sizes):
    """W = Lp_inv[..., None, :, :] @ T[set] of each group set, T (G, M, M)
    cut into sets of `sizes` groups in order, each with its Lp_inv (S, M, M)
    or (M, M)."""
    Ws, start = [], 0
    for Lp_inv, n in zip(Lp_invs, sizes):
        Ws.append(torch.matmul(Lp_inv[..., None, :, :], T[start:start + n]))
        start += n
    return tuple(Ws)


class _WhitenedFactors(torch.autograd.Function):
    """(*Ws, *traces, *logdets) of `cuda_kernels.whitened_factors_cuda`: X
    read once, each W written once, the KL pieces in the same pass; the
    backward `whitened_factors_bwd_cuda` (X's gradient written once in its
    layout, each Lp_inv's summed over its groups in the kernel).  Each
    output's cotangent may be absent (a shard without the KL)."""

    @staticmethod
    def forward(ctx, X, jitter, sizes, *Lp_invs):
        Lp_invs = tuple(P.contiguous() for P in Lp_invs)  # once, for both passes
        Ws, traces, logdets = cuda_kernels.whitened_factors_cuda(X, Lp_invs, sizes, jitter)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(X, *Lp_invs, *Ws)
        ctx.jitter, ctx.sizes = jitter, sizes
        return (*Ws, *traces, *logdets)

    @staticmethod
    def backward(ctx, *grads):
        k = len(ctx.sizes)
        X, *saved = ctx.saved_tensors
        Lp_invs, Ws = saved[:k], saved[k:]
        if all(g is None for g in grads):
            return (None, None, None) + (None,) * k
        dX, dLp_invs = cuda_kernels.whitened_factors_bwd_cuda(
            X, Lp_invs, ctx.sizes, ctx.jitter, Ws, grads[:k], grads[k:2 * k], grads[2 * k:])
        return (dX, None, None, *dLp_invs)


def whitened_factors(X, Lp_invs, sizes, jitter=DSVI_JITTER) -> WhitenedFactors:
    """The whitened factors of a factor parameter X (G, M, M) whose groups
    fall into sets of `sizes` groups in order (sqrt_U's offdiagonal and
    diagonal groups, or sqrt_W's one set), each set with its prior inverse
    factor Lp_inv (S, M, M): W = Lp_inv @ tril_regularized(X[set]), with
    the KL pieces ||W||_F^2 and sum log |diag|.

    Where `cuda_kernels.use_kernel` holds, one `torch.autograd.Function`
    over the two kernels (`_WhitenedFactors`); elsewhere (float64, the CPU,
    larger M) their plain version under autograd, the composition of ops:
    `tril_regularized` on the whole X, its slices and one matmul a set."""
    sizes = tuple(int(n) for n in sizes)
    k = len(sizes)
    if cuda_kernels.use_kernel("whitened_factors", X, *Lp_invs):
        out = _WhitenedFactors.apply(X, jitter, sizes, *Lp_invs)
        return WhitenedFactors(out[:k], out[k:2 * k], out[2 * k:])
    return WhitenedFactors(*cuda_kernels.whitened_factors_plain(X, Lp_invs, sizes, jitter))


def mgp_mean_var_white(A, Lp_inv, d11, mu, scale_tril):
    """Whitened marginalized sparse-GP moments of G coefficient groups:

      mean = A^T (Lp_inv mu)
      var  = max(d11 - colsum(A^2), 0) + rowsum((A^T W)^2)
      W    = Lp_inv @ scale_tril

    A (M, N) or (S, M, N); Lp_inv (M, M) or (S, M, M); d11 scalar or
    broadcastable to (..., N); mu (G, M); scale_tril (G, M, M).  Returns
    mean and var (..., G, N) and W (..., G, M, M).  The variance's
    quadratic form runs in the quadform kernel.
    """
    (W,) = whiten(scale_tril, (Lp_inv,), (scale_tril.shape[0],))
    return (*mgp_moments_white(A, Lp_inv, d11, mu, W), W)


def mgp_moments_white(A, Lp_inv, d11, mu, W):
    """`mgp_mean_var_white`'s mean and var from the whitened factors W
    (..., G, M, M) = Lp_inv @ scale_tril, lower-triangular."""
    half_mu = torch.matmul(mu, Lp_inv.transpose(-1, -2))  # (..., G, M)
    mean = torch.matmul(half_mu, A)
    base = torch.clamp(d11 - torch.sum(A * A, dim=-2), min=0.0)
    return mean, base[..., None, :] + _quadform_diag(A, W)


class _QuadformDiag(torch.autograd.Function):
    """V = sum_k (A^T W_g)^2 by the forward quadform kernel.  The backward
    is the op "quadform_diag_bwd" where both gradients are needed (dA and
    dW's lower triangle, by the kernels `cuda_kernels.pick` chooses), and
    one gradient alone its own op.  Saves A and W, never C: the
    kernels recompute C tile by tile, as the JAX package's `_qf_bwd_rule`
    (pallas_kernels.py:636-684) does, so the (G, N, M) intermediate is
    never held."""

    @staticmethod
    def forward(ctx, A, W):
        ctx.save_for_backward(A, W)
        return cuda_kernels.pick("quadform_diag", A, W)(A, W)

    @staticmethod
    def backward(ctx, vbar):
        A, W = ctx.saved_tensors
        vbar = vbar.contiguous()  # it may arrive expanded
        dA = dW = None
        if ctx.needs_input_grad[0] and ctx.needs_input_grad[1]:
            return cuda_kernels.pick("quadform_diag_bwd", A, W, vbar)(A, W, vbar)
        if ctx.needs_input_grad[0]:
            dA = cuda_kernels.pick("quadform_diag_da", A, W, vbar)(A, W, vbar)
        if ctx.needs_input_grad[1]:
            dW = cuda_kernels.pick("quadform_diag_dw", A, W, vbar)(A, W, vbar)
        return dA, dW


def _quadform_diag(A, W):
    """sum_k (einsum("...mn,...gmk->...gnk", A, W))^2 -> (..., G, N).  W is
    lower-triangular (Lp_inv @ scale_tril), which the kernels rely on; the
    gradient of W is its lower triangle (see `quadform_diag_dw_cuda`)."""
    return _QuadformDiag.apply(A, W)


def kl_gaussian_white(mu_q, dq_reg, W, logdet_p, Lp_inv):
    """KL( N(mu_q, L̃ L̃^T) || N(0, K_p + jI) ) from whitened pieces, exact
    for the regularized factor family (JAX `kl_gaussian_white`,
    ops/linalg.py:493-509):

      KL = (logdet_p - logdet_q) + 0.5 (||W||_F^2 + ||Lp^-1 mu_q||^2 - M)

    `dq_reg` is the regularized factor diagonal (`regularized_diag`), W =
    Lp^-1 L̃ and `logdet_p` = sum log diag Lp.  Lp_inv and W may carry a
    leading draw dimension; `logdet_p` broadcasts against the result.
    """
    logdet_q = torch.sum(torch.log(torch.abs(dq_reg)), dim=-1)
    trace = torch.sum(W * W, dim=(-2, -1))
    return kl_gaussian_white_parts(mu_q, logdet_q, trace, logdet_p, Lp_inv)


def kl_gaussian_white_parts(mu_q, logdet_q, trace, logdet_p, Lp_inv):
    """`kl_gaussian_white` from logdet_q = sum log |dq_reg| and trace =
    ||W||_F^2, as `whitened_factors` gives them."""
    m = mu_q.shape[-1]
    sol = torch.matmul(mu_q, Lp_inv.transpose(-1, -2))
    maha = torch.sum(sol * sol, dim=-1)
    return (logdet_p - logdet_q) + 0.5 * (trace + maha - m)


def kl_gaussian_ref_compat(mu_q, scale_tril_q, Lp_diag, logdet_p, Lp_inv, jitter=DSVI_JITTER):
    """The reference's KL_Gaussian as it computes, quirk included (JAX
    `kl_gaussian_ref_compat`, ops/linalg.py:426-455): its trace term reads
    only the diagonal of the prior factor,

      KL_ref = (logdet_p - logdet_q)
               + 0.5 (sum_ij (Lq2_ij / diag(Lp)_i)^2 + ||Lp^-1 mu_q||^2 - M)

    with Lq2 = chol(Lq Lq^T + jI).  `Lp_diag` (..., M) broadcasts against
    Lq2's rows after a trailing axis is added."""
    m = mu_q.shape[-1]
    Sigma_q = scale_tril_q @ scale_tril_q.transpose(-1, -2)
    Lq2 = chol_with_jitter(Sigma_q, jitter)
    logdet_q = torch.sum(torch.log(torch.diagonal(Lq2, dim1=-2, dim2=-1)), dim=-1)
    X = Lq2 / Lp_diag[..., :, None]
    term2 = torch.sum(X * X, dim=(-2, -1))
    sol = torch.matmul(mu_q, Lp_inv.transpose(-1, -2))
    maha = torch.sum(sol * sol, dim=-1)
    return (logdet_p - logdet_q) + 0.5 * (term2 + maha - m)
