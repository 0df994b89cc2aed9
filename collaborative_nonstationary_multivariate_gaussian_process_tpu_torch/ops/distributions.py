"""Log-density primitives of the fully-Bayesian path.

The JAX package's `ops/distributions.py:40-144` (reference
`SIM_code/Utility/distributions.py`): Kronecker-structured and dense MVN
log-pdfs, inverse-gamma and gamma log-pdfs, and the scalar-Normal log-prob.
Each takes an optional leading chain axis: a covariance (C, n, n) and a
vector y (n,) shared by the chains, or (C, n), give (C,).  The dense
log-pdfs factor through `ops.linalg.chol_tri_inv` (the Cholesky-inverse
kernels), the Kronecker eigen route through `ops.kron.kron_mv` (the
Kronecker-matvec kernel).
"""

from __future__ import annotations

import math

import torch

from .kron import eigh, kron, kron_diag, kron_mv
from .linalg import chol_tri_inv

__all__ = [
    "KRON_DENSE_MAX_DIM",
    "normal_logprob_sum",
    "mvn_logpdf_kron",
    "mvn_logpdf_dense",
    "mvn_logpdf_prec",
    "mvn_logpdf_chol",
    "inverse_gamma_logpdf",
    "inverse_gamma_logpdf_u",
    "gamma_logpdf",
]

_LOG_2PI = math.log(2.0 * math.pi)

# Largest total dimension MN that `mvn_logpdf_kron` takes by a dense
# Cholesky of the assembled matrix; above it, the factor-eigh route.  1024
# is the JAX package's value, chosen from TPU timings (ops/distributions.py:
# 47-54), not from an H100 measurement; it is kept so that the port takes
# the same route as the JAX package at every size.  `chip_smoke.py` times
# both routes on the card.
KRON_DENSE_MAX_DIM = 1024


def _as_tensor(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def normal_logprob_sum(loc, scale, y):
    """Sum of elementwise Normal log-probs (reference code/utils.py:268-272)."""
    log_pdf = -((y - loc) ** 2) / (2.0 * scale**2) - torch.log(_as_tensor(scale, y)) - 0.5 * _LOG_2PI
    return torch.sum(log_pdf)


def mvn_logpdf_kron(y, mu, B, K, sigma2, jitter=0.0, dense_max_dim=None):
    """Un-normalized log N(y | mu, B kron K + sigma2 I): the reference's
    `multivariate_normal_logpdf0` (the -MN/2 log 2 pi constant dropped, as
    there).  `jitter` is added to both factor diagonals (the deterministic
    form of the reference's retry).  y is task-major, vec(Y^T) for Y (N, M);
    B (..., M, M) over tasks, K (..., N, N) over inputs, sigma2 a scalar or
    (...,).

    Route (static, on shapes, as in the JAX package): MN <= `dense_max_dim`
    (default `KRON_DENSE_MAX_DIM`) factors kron(B, K) + sigma2 I densely;
    larger systems take the factor-eigh route through `kron_mv`.
    """
    if jitter:
        B = B + jitter * torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
        K = K + jitter * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    if dense_max_dim is None:
        dense_max_dim = KRON_DENSE_MAX_DIM
    s2 = _as_tensor(sigma2, K)
    MN = B.shape[-1] * K.shape[-1]
    if MN <= dense_max_dim:
        eye = torch.eye(MN, dtype=K.dtype, device=K.device)
        return mvn_logpdf_dense(y, mu, kron(B, K) + s2[..., None, None] * eye)
    w_B, v_B = eigh(B)
    w_K, v_K = eigh(K)
    a = kron_mv(v_B.transpose(-1, -2), v_K.transpose(-1, -2), y - mu)
    t = kron_diag(w_B, w_K)
    w = 1.0 / (s2[..., None] + t)
    quad = torch.sum(a * w * a, dim=-1)
    logdet = torch.sum(torch.log(t + s2[..., None]), dim=-1)
    return -0.5 * logdet - 0.5 * quad


def mvn_logpdf_prec(y, mu, logdet_sigma, inv_sigma):
    """Un-normalized MVN log-pdf from a precomputed log-det and inverse
    (reference `multivariate_normal_logpdf`, its 2 pi constant dropped)."""
    yb = y - mu
    return -0.5 * logdet_sigma - 0.5 * torch.sum(yb * (inv_sigma @ yb[..., None])[..., 0], dim=-1)


def mvn_logpdf_dense(y, mu, Sigma):
    """Un-normalized dense MVN log-pdf through the fused Cholesky-inverse
    (`chol_tri_inv`, whose backward is matmuls only): -1/2 log det Sigma -
    1/2 |L^-1 (y - mu)|^2.  Sigma (..., n, n); y, mu (n,) or (..., n)."""
    L, Linv = chol_tri_inv(Sigma)
    sol = (Linv @ (y - mu)[..., None])[..., 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * logdet - 0.5 * torch.sum(sol * sol, dim=-1)


def mvn_logpdf_chol(y, mu, Sigma):
    """*Normalized* MVN log-pdf (the GP priors; the reference's
    `MultivariateNormal.log_prob`)."""
    return mvn_logpdf_dense(y, mu, Sigma) - 0.5 * y.shape[-1] * _LOG_2PI


def inverse_gamma_logpdf_u(x, alpha=1.0, beta=1.0):
    """Un-normalized inverse-gamma log-pdf (reference distributions.py:116-124)."""
    return (-alpha - 1.0) * torch.log(x) - beta / x


def inverse_gamma_logpdf(x, alpha=1.0, beta=1.0):
    """Normalized inverse-gamma log-pdf (reference distributions.py:126-134)."""
    a, b = _as_tensor(alpha, x), _as_tensor(beta, x)
    return (-a - 1.0) * torch.log(x) - b / x + a * torch.log(b) - torch.special.gammaln(a)


def gamma_logpdf(x, alpha=1.0, beta=1.0):
    """Normalized gamma log-pdf (reference distributions.py:136-137)."""
    a, b = _as_tensor(alpha, x), _as_tensor(beta, x)
    return (a - 1.0) * torch.log(x) - b * x + a * torch.log(b) - torch.special.gammaln(a)
