"""Fully-Bayesian log-posterior library (sampler-agnostic densities).

The JAX package's `models/logdensities.py` (reference
`SIM_code/Utility/logpos.py`), with the chains on a leading axis: every
density takes `pars` of shape (C, dim) (or (dim,), as one chain) in the JAX
package's flat layout and returns the log-posterior of each chain, (C,) (or
a scalar).  Gradients come from `torch.autograd.grad(lp.sum(), pars)`: the
chains are independent, so that is each chain's gradient.  A JAX init or
draw is a numpy vector in the same layout, which the port takes as it is.

Variants (reference logpos.py):
  SNMGP      separable nonstationary:  B_f kron K_x + s2 I       (:216-296)
  GNMGP/SVC  varying covariance:  (1 kron K_x) o K_i, K_i = L L^T (:299-380)
  LMC (S)    stationary:  scalar (l, sigma)                       (:383-462)
  Hadamard heterotopic versions of each                           (:465-716)
plus the whitened SVC and SNMGP.

Kernels on this path: the Gibbs gram of every chain (`nonstationary_rbf`),
the RBF grams of the priors and of `lmc_hadamard` (per-chain scale and
lengthscale in one launch), the dense log-pdfs through the Cholesky-inverse
kernel (`chol_tri_inv`), the prior Choleskys (`ops.linalg.cholesky`), and
the Kronecker eigen route through `kron_mv`.
"""

from __future__ import annotations

import math
from functools import wraps
from typing import NamedTuple

import numpy as np
import torch

from ..config import MCMC_JITTER, PRECISION
from ..ops.distributions import (
    inverse_gamma_logpdf,
    inverse_gamma_logpdf_u,
    mvn_logpdf_chol,
    mvn_logpdf_dense,
    mvn_logpdf_kron,
)
from ..ops.kernels import nonstationary_rbf, rbf
from ..ops.linalg import cholesky, uvec_to_lvec, vec_to_tril
from ..utils import profiling

__all__ = [
    "tri_size",
    "SNMGPPars",
    "SVCPars",
    "LMCPars",
    "snmgp_unflatten",
    "snmgp_flatten",
    "svc_unflatten",
    "svc_flatten",
    "lmc_unflatten",
    "svc_covariance",
    "snmgp_log_posterior",
    "svc_log_posterior",
    "lmc_log_posterior",
    "snmgp_hadamard_log_posterior",
    "svc_hadamard_log_posterior",
    "lmc_hadamard_log_posterior",
    "snmgp_deviance",
    "lmc_deviance",
    "svc_deviance",
    "snmgp_covs",
    "snmgp_hadamard_covs",
    "svc_whiten_chols",
    "svc_unwhiten",
    "svc_log_posterior_whitened",
    "snmgp_whiten_chols",
    "snmgp_unwhiten",
    "snmgp_log_posterior_whitened",
    "make_nlp",
    "DEFAULT_HYPERS",
    "SVC_DEFAULT_HYPERS",
]

DEFAULT_HYPERS = dict(
    mu_tilde_l=0.0,
    alpha_tilde_l=1.0,
    beta_tilde_l=1.0,
    mu_tilde_sigma=0.0,
    alpha_tilde_sigma=1.0,
    beta_tilde_sigma=1.0,
    a=1.0,
    b=1.0,
    c=10.0,
)  # (logpos.py:14)

SVC_DEFAULT_HYPERS = dict(
    mu_tilde_l=0.0,
    alpha_tilde_l=5.0,
    beta_tilde_l=1.0,
    mu_L=0.0,
    alpha_L=5.0,
    beta_L=1.0,
    a=1.0,
    b=1.0,
)  # (logpos.py:299)

_LOG_2PI = math.log(2.0 * math.pi)


def tri_size(m: int) -> int:
    return m * (m + 1) // 2


def _chains(fn):
    """Let a density written for (C, dim) pars take one chain's (dim,) too."""

    @wraps(fn)
    def wrapper(pars, *args, **kwargs):
        if pars.ndim == 1:
            return fn(pars[None], *args, **kwargs)[0]
        return fn(pars, *args, **kwargs)

    return wrapper


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _task_major(Y):
    """y = vec(Y^T) for Y (N, M), the reference's `Y.t().contiguous().view(-1)`."""
    return Y.T.reshape(-1)


# ---------------------------------------------------------------------------
# Flat-vector layouts (vec2pars* semantics); pars (..., dim)
# ---------------------------------------------------------------------------


class SNMGPPars(NamedTuple):
    tilde_l: torch.Tensor  # (..., N)
    tilde_sigma: torch.Tensor  # (..., N)
    uL_vec: torch.Tensor  # (..., T)
    tilde_sigma2_err: torch.Tensor  # (...,)


class SVCPars(NamedTuple):
    tilde_l: torch.Tensor  # (..., N)
    uL_vecs: torch.Tensor  # (..., N*T)
    tilde_sigma2_err: torch.Tensor  # (...,)


class LMCPars(NamedTuple):
    tilde_l: torch.Tensor  # (...,)
    tilde_sigma: torch.Tensor  # (...,)
    uL_vec: torch.Tensor  # (..., T)
    tilde_sigma2_err: torch.Tensor  # (...,)


def snmgp_unflatten(pars, N: int, M: int) -> SNMGPPars:
    """`vec2pars` (logpos.py:17-29)."""
    T = tri_size(M)
    return SNMGPPars(pars[..., :N], pars[..., N:2 * N], pars[..., 2 * N:2 * N + T], pars[..., -1])


def snmgp_flatten(p: SNMGPPars):
    return torch.cat([p.tilde_l, p.tilde_sigma, p.uL_vec, p.tilde_sigma2_err[..., None]], dim=-1)


def svc_unflatten(pars, N: int, M: int) -> SVCPars:
    """`vec2pars_SVC` (logpos.py:32-43)."""
    T = tri_size(M)
    return SVCPars(pars[..., :N], pars[..., N:N + N * T], pars[..., -1])


def svc_flatten(p: SVCPars):
    return torch.cat([p.tilde_l, p.uL_vecs, p.tilde_sigma2_err[..., None]], dim=-1)


def lmc_unflatten(pars, M: int) -> LMCPars:
    """`vec2pars_S` (logpos.py:46-57)."""
    T = tri_size(M)
    return LMCPars(pars[..., 0], pars[..., 1], pars[..., 2:2 + T], pars[..., -1])


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _kron_loglik_robust(y, B_f, K_x, sigma2_err, jitter=PRECISION):
    """Kronecker MVN log-lik with a deterministic factor jitter in float32
    only (the JAX `_kron_loglik_robust`: the reference's NaN-retry loop,
    logpos.py:267-268, made branchless); float64 needs none."""
    zero = torch.zeros_like(y)
    if torch.finfo(y.dtype).eps > 1e-10:
        return mvn_logpdf_kron(y, zero, B_f, K_x, sigma2_err, jitter=jitter)
    return mvn_logpdf_kron(y, zero, B_f, K_x, sigma2_err)


def _prior_jitter(dtype, alpha=1.0):
    """Diagonal jitter of the prior-covariance Choleskys: MCMC_JITTER, or
    400 machine epsilons in float32, times alpha^2 (the JAX `_prior_jitter`)."""
    eps = torch.finfo(dtype).eps
    return max(MCMC_JITTER, 400.0 * eps) * alpha**2


def _gp_prior(vals, x, mu, alpha, beta, jitter=None):
    """Normalized MVN GP prior with RBF covariance (logpos.py:271-279), of
    each chain's values (C, N) under one (N, N) covariance."""
    if jitter is None:
        jitter = _prior_jitter(x.dtype, alpha)
    S = rbf(x, x, alpha**2, beta) + jitter * _eye(x.shape[0], x)
    return mvn_logpdf_chol(vals, mu * torch.ones_like(vals), S)


def _normal_logpdf(v, mu, sigma):
    return -0.5 * ((v - mu) / sigma) ** 2 - math.log(sigma) - 0.5 * _LOG_2PI


def _Lf_stack(uL_vecs, N: int, M: int):
    """(..., N*T) unconstrained -> (..., N, M, M) per-point lower-Cholesky
    stack (`uLvecs2Lvecs` + `vec2lowtriangle`, logpos.py:339-341)."""
    u = uL_vecs.reshape(uL_vecs.shape[:-1] + (N, tri_size(M)))
    return vec_to_tril(uvec_to_lvec(u, M), M)


def _svc_assemble(K_x, L_f):
    """Task-major (..., MN, MN) K[(i,n),(j,m)] = K_x[n,m] <L_f[n,i,:], L_f[m,j,:]>:
    one matmul of the (i, n)-ordered rows of L_f, times K_x tiled M x M."""
    N, M = L_f.shape[-3], L_f.shape[-1]
    rows = L_f.transpose(-3, -2).reshape(L_f.shape[:-3] + (M * N, M))
    tiled = K_x.repeat((1,) * (K_x.ndim - 2) + (M, M))
    return (rows @ rows.transpose(-1, -2)) * tiled


def svc_covariance(tilde_l, uL_vecs, x, jitter=MCMC_JITTER):
    """Task-major (..., MN, MN) SVC covariance K = (1 kron K_x) o K_i, and
    the (..., N, M, M) Cholesky stack L_f (one einsum replaces the
    reference's generate_K_index_SVC + reorder, logpos.py:346-349)."""
    N = x.shape[0]
    M = int(np.sqrt(uL_vecs.shape[-1] // N * 2 + 0.25) - 0.5)  # T = M(M+1)/2
    L_f = _Lf_stack(uL_vecs, N, M)
    K_x = nonstationary_rbf(x, ell1=torch.exp(tilde_l)) + jitter * _eye(N, x)
    return _svc_assemble(K_x, L_f), L_f


def _inv_gamma_and_jacobian(p, sigma2_err, a, b):
    return inverse_gamma_logpdf(sigma2_err, alpha=a, beta=b) + p.tilde_sigma2_err


def _L_prior(U, x, mu_L, alpha_L, beta_L):
    """GP prior over each of the T unconstrained Cholesky-entry processes,
    U (C, N, T): one (N, N) RBF covariance factored by the Cholesky kernel."""
    N = x.shape[0]
    Sigma_L = rbf(x, x, alpha_L**2, beta_L) + _prior_jitter(x.dtype, alpha_L) * _eye(N, x)
    chol = cholesky(Sigma_L)
    sol = torch.linalg.solve_triangular(chol, U - mu_L, upper=False)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    per_entry = -0.5 * torch.sum(sol**2, dim=-2) - 0.5 * logdet - 0.5 * N * _LOG_2PI
    return torch.sum(per_entry, dim=-1)


# ---------------------------------------------------------------------------
# SNMGP (separable nonstationary)
# ---------------------------------------------------------------------------


@_chains
def snmgp_log_posterior(pars, Y, x, mu_tilde_l=0.0, alpha_tilde_l=1.0, beta_tilde_l=1.0,
                        mu_tilde_sigma=0.0, alpha_tilde_sigma=1.0, beta_tilde_sigma=1.0,
                        a=1.0, b=1.0, c=10.0, prior=True):
    """log p(pars | Y, x) for the SNMGP (reference `logpos`, logpos.py:237-296).
    Y: (N, M); x: (N,); pars: (C, dim) in the flat layout above."""
    N, M = Y.shape
    p = snmgp_unflatten(pars, N, M)
    L = vec_to_tril(uvec_to_lvec(p.uL_vec, M), M)
    B_f = L @ L.transpose(-1, -2)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    K_x = nonstationary_rbf(x, sigma1=torch.exp(p.tilde_sigma), ell1=torch.exp(p.tilde_l))
    K_x = K_x + MCMC_JITTER * _eye(N, x)
    res = _kron_loglik_robust(_task_major(Y), B_f, K_x, sigma2_err)
    if prior:
        res = res + _gp_prior(p.tilde_l, x, mu_tilde_l, alpha_tilde_l, beta_tilde_l)
        res = res + _gp_prior(p.tilde_sigma, x, mu_tilde_sigma, alpha_tilde_sigma, beta_tilde_sigma)
        res = res + torch.sum(_normal_logpdf(p.uL_vec, 0.0, c), dim=-1)
        res = res + _inv_gamma_and_jacobian(p, sigma2_err, a, b)
    return res


@_chains
def snmgp_deviance(pars, Y, x):
    """-2 loglik (reference `deviance`, logpos.py:189-213), on the
    *constrained* L_vec layout like the reference (no exp on the diagonal)."""
    N, M = Y.shape
    p = snmgp_unflatten(pars, N, M)
    L = vec_to_tril(p.uL_vec, M)
    B_f = L @ L.transpose(-1, -2)
    K_x = nonstationary_rbf(x, sigma1=torch.exp(p.tilde_sigma), ell1=torch.exp(p.tilde_l))
    K_x = K_x + MCMC_JITTER * _eye(N, x)
    y = _task_major(Y)
    return -2.0 * mvn_logpdf_kron(y, torch.zeros_like(y), B_f, K_x, torch.exp(p.tilde_sigma2_err))


def _lmc_grams(p, x, M, constrained):
    N = x.shape[0]
    L = vec_to_tril(p.uL_vec if constrained else uvec_to_lvec(p.uL_vec, M), M)
    B_f = L @ L.transpose(-1, -2)
    ones = torch.ones(N, dtype=x.dtype, device=x.device)
    l = torch.exp(p.tilde_l)[..., None] * ones
    sigma = torch.exp(p.tilde_sigma)[..., None] * ones
    K_x = nonstationary_rbf(x, sigma1=sigma, ell1=l) + MCMC_JITTER * _eye(N, x)
    return B_f, K_x


@_chains
def lmc_deviance(pars, Y, x):
    """-2 loglik for the stationary LMC (constrained L_vec layout,
    logpos.py:176-213)."""
    N, M = Y.shape
    p = lmc_unflatten(pars, M)
    B_f, K_x = _lmc_grams(p, x, M, constrained=True)
    y = _task_major(Y)
    return -2.0 * mvn_logpdf_kron(y, torch.zeros_like(y), B_f, K_x, torch.exp(p.tilde_sigma2_err))


@_chains
def svc_deviance(pars, Y, x):
    """-2 loglik for the SVC model (constrained L_vecs layout)."""
    N, M = Y.shape
    p = svc_unflatten(pars, N, M)
    L_f = vec_to_tril(p.uL_vecs.reshape(p.uL_vecs.shape[:-1] + (N, tri_size(M))), M)
    K_x = nonstationary_rbf(x, ell1=torch.exp(p.tilde_l)) + MCMC_JITTER * _eye(N, x)
    S = _svc_assemble(K_x, L_f)
    S = S + torch.exp(p.tilde_sigma2_err)[..., None, None] * _eye(N * M, x)
    y = _task_major(Y)
    return -2.0 * mvn_logpdf_dense(y, torch.zeros_like(y), S)


def snmgp_covs(pars, Y, x, verbose: bool = False):
    """Assembled covariance components (reference `show_covs`,
    logpos.py:140-158): dict(B_f, K_x, sigma2_err), the L_vec block used
    *raw* (no exp-diagonal) as the reference does.  pars (dim,) or (C, dim)."""
    N, M = Y.shape
    p = snmgp_unflatten(pars, N, M)
    L = vec_to_tril(p.uL_vec, M)
    B_f = L @ L.transpose(-1, -2)
    K_x = nonstationary_rbf(x, sigma1=torch.exp(p.tilde_sigma), ell1=torch.exp(p.tilde_l))
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    if verbose:
        print(f"B_f: {B_f}")
        print(f"K_x: {K_x}")
        print(f"sigma2_err: {sigma2_err}")
    return {"B_f": B_f, "K_x": K_x, "sigma2_err": sigma2_err}


def snmgp_hadamard_covs(pars, x, indx, verbose: bool = False):
    """Heterotopic variant (reference `show_covs_hadamard`, logpos.py:160-173):
    dict(B_f, sigma2_err); `indx` gives the task count."""
    N = x.shape[0]
    M = int(np.unique(np.asarray(indx.cpu() if isinstance(indx, torch.Tensor) else indx)).shape[0])
    p = snmgp_unflatten(pars, N, M)
    L = vec_to_tril(p.uL_vec, M)
    B_f = L @ L.transpose(-1, -2)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    if verbose:
        print(f"B_f: {B_f}")
        print(f"sigma2_err: {sigma2_err}")
    return {"B_f": B_f, "sigma2_err": sigma2_err}


# ---------------------------------------------------------------------------
# GNMGP / SVC (spatially varying covariance)
# ---------------------------------------------------------------------------


@_chains
def svc_log_posterior(pars, Y, x, mu_tilde_l=0.0, alpha_tilde_l=5.0, beta_tilde_l=1.0,
                      mu_L=0.0, alpha_L=5.0, beta_L=1.0, a=1.0, b=1.0, prior=True):
    """log p(pars | Y, x) for the SVC model (reference `logpos_SVC`,
    logpos.py:326-380)."""
    N, M = Y.shape
    p = svc_unflatten(pars, N, M)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    K, _ = svc_covariance(p.tilde_l, p.uL_vecs, x)
    S = K + sigma2_err[..., None, None] * _eye(N * M, x)
    y = _task_major(Y)
    res = mvn_logpdf_dense(y, torch.zeros_like(y), S)
    if prior:
        res = res + _gp_prior(p.tilde_l, x, mu_tilde_l, alpha_tilde_l, beta_tilde_l)
        U = p.uL_vecs.reshape(p.uL_vecs.shape[:-1] + (N, tri_size(M)))
        res = res + _L_prior(U, x, mu_L, alpha_L, beta_L)
        res = res + _inv_gamma_and_jacobian(p, sigma2_err, a, b)
    return res


# ---------------------------------------------------------------------------
# LMC / stationary
# ---------------------------------------------------------------------------


@_chains
def lmc_log_posterior(pars, Y, x, mu_tilde_l=0.0, sigma_tilde_l=1.0, a=1.0, b=1.0, c=10.0,
                      prior=True):
    """log p(pars | Y, x) for the stationary LMC (reference `logpos_S`,
    logpos.py:405-462): scalar (tilde_l, tilde_sigma) per chain."""
    N, M = Y.shape
    p = lmc_unflatten(pars, M)
    B_f, K_x = _lmc_grams(p, x, M, constrained=False)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    res = _kron_loglik_robust(_task_major(Y), B_f, K_x, sigma2_err)
    if prior:
        res = res + _normal_logpdf(p.tilde_l, mu_tilde_l, sigma_tilde_l)
        res = res + torch.sum(_normal_logpdf(p.uL_vec, 0.0, c), dim=-1)
        res = res + _inv_gamma_and_jacobian(p, sigma2_err, a, b)
    return res


# ---------------------------------------------------------------------------
# Hadamard (heterotopic) variants: flat (x, indx, y)
# ---------------------------------------------------------------------------


def _hadamard_loglik(K_x, K_i, y, sigma2_err):
    N = y.shape[0]
    S = K_x * K_i + sigma2_err[..., None, None] * _eye(N, y)
    return mvn_logpdf_dense(y, torch.zeros_like(y), S)


def _inv_gamma_u_and_jacobian(p, sigma2_err, a, b):
    return inverse_gamma_logpdf_u(sigma2_err, alpha=a, beta=b) + p.tilde_sigma2_err


@_chains
def snmgp_hadamard_log_posterior(pars, x, indx, y, num_tasks: int, mu_tilde_l=0.0,
                                 alpha_tilde_l=1.0, beta_tilde_l=1.0, mu_tilde_sigma=0.0,
                                 alpha_tilde_sigma=1.0, beta_tilde_sigma=1.0, a=1.0, b=1.0,
                                 c=10.0, prior=True):
    """Heterotopic SNMGP (reference `logpos_hadamard`, logpos.py:502-563):
    K = K_x o B_f[indx, indx'] on the N observed points.  Like the
    reference, the raw L_vec (no exp-diagonal) and an N(0, c) prior on it."""
    N, M = y.shape[0], num_tasks
    p = snmgp_unflatten(pars, N, M)
    L = vec_to_tril(p.uL_vec, M)
    B_f = L @ L.transpose(-1, -2)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    K_x = nonstationary_rbf(x, sigma1=torch.exp(p.tilde_sigma), ell1=torch.exp(p.tilde_l))
    K_x = K_x + MCMC_JITTER * _eye(N, x)
    K_i = B_f[..., indx[:, None], indx[None, :]]
    res = _hadamard_loglik(K_x, K_i, y, sigma2_err)
    if prior:
        res = res + _gp_prior(p.tilde_l, x, mu_tilde_l, alpha_tilde_l, beta_tilde_l)
        res = res + _gp_prior(p.tilde_sigma, x, mu_tilde_sigma, alpha_tilde_sigma, beta_tilde_sigma)
        res = res + torch.sum(_normal_logpdf(p.uL_vec, 0.0, c), dim=-1)
        res = res + _inv_gamma_u_and_jacobian(p, sigma2_err, a, b)
    return res


@_chains
def svc_hadamard_log_posterior(pars, x, indx, y, num_tasks: int, mu_tilde_l=0.0,
                               alpha_tilde_l=1.0, beta_tilde_l=1.0, mu_L=0.0, alpha_L=1.0,
                               beta_L=1.0, a=1.0, b=1.0, prior=True):
    """Heterotopic SVC (reference `logpos_hadamard_SVC`, logpos.py:588-659):
    K_i[n,m] = <L_f[n, indx[n], :], L_f[m, indx[m], :]> on observed points,
    the per-point Cholesky stack from the *raw* L_vecs as in the reference."""
    N, M = y.shape[0], num_tasks
    T = tri_size(M)
    p = svc_unflatten(pars, N, M)
    U = p.uL_vecs.reshape(p.uL_vecs.shape[:-1] + (N, T))
    L_f = vec_to_tril(U, M)  # (C, N, M, M) raw
    rows = L_f[:, torch.arange(N, device=x.device), indx, :]  # (C, N, M)
    K_i = rows @ rows.transpose(-1, -2)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    K_x = nonstationary_rbf(x, ell1=torch.exp(p.tilde_l)) + MCMC_JITTER * _eye(N, x)
    res = _hadamard_loglik(K_x, K_i, y, sigma2_err)
    if prior:
        res = res + _gp_prior(p.tilde_l, x, mu_tilde_l, alpha_tilde_l, beta_tilde_l)
        res = res + _L_prior(U, x, mu_L, alpha_L, beta_L)
        res = res + _inv_gamma_u_and_jacobian(p, sigma2_err, a, b)
    return res


@_chains
def lmc_hadamard_log_posterior(pars, x, indx, y, num_tasks: int, mu_tilde_l=0.0,
                               sigma_tilde_l=1.0, a=1.0, b=1.0, c=10.0, prior=True):
    """Heterotopic stationary LMC (reference `logpos_hadamard_S`,
    logpos.py:676-716): K = RBF(sigma, l) o B_f gather, the RBF grams of
    all chains' (sigma^2, l) pairs in one launch."""
    N, M = y.shape[0], num_tasks
    p = lmc_unflatten(pars, M)
    L = vec_to_tril(p.uL_vec, M)
    B_f = L @ L.transpose(-1, -2)
    sigma = torch.exp(p.tilde_sigma)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    K_x = rbf(x, x, sigma**2, torch.exp(p.tilde_l)) + MCMC_JITTER * _eye(N, x)
    K_i = B_f[..., indx[:, None], indx[None, :]]
    res = _hadamard_loglik(K_x, K_i, y, sigma2_err)
    if prior:
        res = res + _normal_logpdf(p.tilde_l, mu_tilde_l, sigma_tilde_l)
        res = res + torch.sum(_normal_logpdf(p.uL_vec, 0.0, c), dim=-1)
        res = res + _inv_gamma_u_and_jacobian(p, sigma2_err, a, b)
    return res


# ---------------------------------------------------------------------------
# Whitened (non-centered) parameterizations
# ---------------------------------------------------------------------------
#
# tilde_l = mu + L_prior eta with L_prior = chol(K_RBF(alpha, beta) +
# jitter) and eta ~ N(0, I): the GP prior becomes a standard normal on eta,
# and the samplers see a near-isotropic space.


def _prior_chols(x, pairs):
    """Lower Choleskys of the RBF prior covariances of (alpha, beta) pairs:
    the grams of all pairs in one launch of the RBF kernel, the factors in
    one launch of the Cholesky kernel."""
    N = x.shape[0]
    t = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)  # noqa: E731
    jitter = t([_prior_jitter(x.dtype, a) for a, _ in pairs])
    S = rbf(x, x, t([a**2 for a, _ in pairs]), t([b for _, b in pairs]))
    return tuple(cholesky(S + jitter[:, None, None] * _eye(N, x)))


def svc_whiten_chols(x, alpha_tilde_l, beta_tilde_l, alpha_L, beta_L):
    """Prior Choleskys of the whitened SVC parameterization, (chol_l, chol_L)."""
    return _prior_chols(x, ((alpha_tilde_l, beta_tilde_l), (alpha_L, beta_L)))


def svc_unwhiten(pars_white, x, mu_tilde_l, mu_L, chol_l, chol_L, M: int):
    """eta-space flat vectors (..., dim) -> centered SVCPars."""
    N = x.shape[0]
    T = tri_size(M)
    p = svc_unflatten(pars_white, N, M)
    tilde_l = mu_tilde_l + p.tilde_l @ chol_l.T
    eta_U = p.uL_vecs.reshape(p.uL_vecs.shape[:-1] + (N, T))
    U = mu_L + chol_L @ eta_U
    return SVCPars(tilde_l, U.reshape(U.shape[:-2] + (N * T,)), p.tilde_sigma2_err)


@_chains
def svc_log_posterior_whitened(pars_white, Y, x, chol_l, chol_L, mu_tilde_l=0.0, mu_L=0.0,
                               a=1.0, b=1.0):
    """Whitened SVC log posterior: the posterior of `svc_log_posterior`
    under `svc_unwhiten`, with N(0, I) priors on the etas.  Its stages are
    the spans `logdensity.svc_covariance` (unwhitening and the covariance)
    and `logdensity.svc_mvn` (the dense log-pdf, the priors)."""
    N, M = Y.shape
    with profiling.span("logdensity.svc_covariance"):
        p = svc_unwhiten(pars_white, x, mu_tilde_l, mu_L, chol_l, chol_L, M)
        sigma2_err = torch.exp(p.tilde_sigma2_err)
        K, _ = svc_covariance(p.tilde_l, p.uL_vecs, x)
        S = K + sigma2_err[..., None, None] * _eye(N * M, x)
    with profiling.span("logdensity.svc_mvn"):
        y = _task_major(Y)
        res = mvn_logpdf_dense(y, torch.zeros_like(y), S)
        eta = pars_white[..., :-1]
        res = res - 0.5 * torch.sum(eta**2, dim=-1)
        return res + _inv_gamma_and_jacobian(p, sigma2_err, a, b)


def snmgp_whiten_chols(x, alpha_tilde_l, beta_tilde_l, alpha_tilde_sigma, beta_tilde_sigma):
    """Prior Choleskys of the whitened SNMGP parameterization, (chol_l, chol_s)."""
    return _prior_chols(x, ((alpha_tilde_l, beta_tilde_l), (alpha_tilde_sigma, beta_tilde_sigma)))


def snmgp_unwhiten(pars_white, x, mu_tilde_l, mu_tilde_sigma, chol_l, chol_s, M: int):
    N = x.shape[0]
    p = snmgp_unflatten(pars_white, N, M)
    return SNMGPPars(
        mu_tilde_l + p.tilde_l @ chol_l.T,
        mu_tilde_sigma + p.tilde_sigma @ chol_s.T,
        p.uL_vec,
        p.tilde_sigma2_err,
    )


@_chains
def snmgp_log_posterior_whitened(pars_white, Y, x, chol_l, chol_s, mu_tilde_l=0.0,
                                 mu_tilde_sigma=0.0, a=1.0, b=1.0, c=10.0):
    """Whitened SNMGP log posterior (non-centered tilde_l, tilde_sigma)."""
    N, M = Y.shape
    p = snmgp_unwhiten(pars_white, x, mu_tilde_l, mu_tilde_sigma, chol_l, chol_s, M)
    L = vec_to_tril(uvec_to_lvec(p.uL_vec, M), M)
    B_f = L @ L.transpose(-1, -2)
    K_x = nonstationary_rbf(x, sigma1=torch.exp(p.tilde_sigma), ell1=torch.exp(p.tilde_l))
    K_x = K_x + MCMC_JITTER * _eye(N, x)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    res = _kron_loglik_robust(_task_major(Y), B_f, K_x, sigma2_err)
    pw = snmgp_unflatten(pars_white, N, M)
    res = res - 0.5 * torch.sum(pw.tilde_l**2, dim=-1) - 0.5 * torch.sum(pw.tilde_sigma**2, dim=-1)
    res = res + torch.sum(_normal_logpdf(p.uL_vec, 0.0, c), dim=-1)
    return res + _inv_gamma_and_jacobian(p, sigma2_err, a, b)


def make_nlp(log_posterior, *args, **kwargs):
    """Negative-log-posterior closure (the `nlogpos_obj*` family,
    logpos.py:216-234) for optimizers and samplers."""

    def nlp(pars):
        return -log_posterior(pars, *args, **kwargs)

    return nlp
