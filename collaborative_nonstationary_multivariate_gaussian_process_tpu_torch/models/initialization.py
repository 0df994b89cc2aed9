"""DSVI initialization: local Kronecker-MLE pre-estimation.

The port's own NumPy/SciPy copy of the JAX package's
`models/initialization.py` (the reference's `pre_nmgp.py:9-125`, which is
NumPy/SciPy itself; importing the JAX module would run the JAX package's
`__init__`).  For each inducing point, (log sigma2_err, log ell) is fitted
by local maximum likelihood on the P nearest observations under a separable
kron(K_RBF, B) model, the output-covariance Cholesky L either fixed from the
global sample covariance ("partial") or free ("all").  The (v, U,
sigma2_err_log) arrays they return initialize the variational parameters
(`inference(mu_v=..., mu_U=..., sqrt_*=...)`), as the reference's scripts
use them.  Also `pre_initialization`, the identity-sqrt variational init
(nmgp_dsvi.py:737-742).  All of it runs on the host; the neighbour search
goes through `utils.native`, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize
from scipy.stats import multivariate_normal

from ..utils import native

__all__ = [
    "pre_estimation_partial",
    "pre_estimation_all",
    "pre_initialization",
    "search_nearest_neighborhood",
]

_JITTER = 1e-6


def search_nearest_neighborhood(x, Y, z_m, P=10):
    """The P nearest observations (x, Y rows) to the inducing location z_m
    (pre_nmgp.py:9-12), by `utils.native.knn_1d`, as the JAX package finds
    them: nearest first, ties by index."""
    indices = native.knn_1d(np.asarray(x), np.asarray([z_m]), P)[0]
    return x[indices], Y[indices]


def _rbf_np(x, length_scale):
    length_scale = max(length_scale, 1e-8)
    d = (x[:, None] - x[None, :]) / length_scale
    return np.exp(-0.5 * d * d)


def _loglik_part(pars, x, Y, L):
    """Local MVN log-likelihood with a fixed output Cholesky
    (pre_nmgp.py:48-56)."""
    N, D = Y.shape
    log_s2e, log_ell = pars
    K = _rbf_np(x, np.exp(log_ell))
    C = np.kron(K, L @ L.T) + np.eye(N * D) * np.exp(log_s2e)
    return multivariate_normal.logpdf(Y.reshape(-1), cov=C, allow_singular=True)


def _loglik_all(pars, x, Y):
    """Local MVN log-likelihood, the output Cholesky free
    (pre_nmgp.py:35-46)."""
    N, D = Y.shape
    log_s2e, log_ell = pars[0], pars[1]
    L = np.zeros((D, D))
    L[np.tril_indices(D)] = pars[2:]
    K = _rbf_np(x, np.exp(log_ell))
    C = np.kron(K, L @ L.T) + np.eye(N * D) * np.exp(log_s2e)
    return multivariate_normal.logpdf(Y.reshape(-1), cov=C, allow_singular=True)


def pre_estimation_partial(x, Y, z, P=10):
    """Per-inducing-point (sigma2_err, ell) MLE with L fixed to the global
    sample Cholesky (pre_nmgp.py:102-125).  Returns (v (M,) the log
    lengthscales, U (D, D, M) the Cholesky at each point, sigma2_err_log
    (M,))."""
    N, D = Y.shape
    L_global = np.linalg.cholesky(Y.T @ Y / (N - 1) + _JITTER * np.eye(D))
    L_tensor = np.stack([L_global for _ in range(z.shape[0])], axis=-1)
    s2e_logs, ells = [], []
    for m, z_m in enumerate(z):
        x_loc, Y_loc = search_nearest_neighborhood(x, Y, z_m, P=P)
        res = minimize(lambda p: -_loglik_part(p, x_loc, Y_loc, L_tensor[:, :, m]),
                       np.array([-6.0, -6.0]))
        s2e_logs.append(res.x[0])
        ells.append(np.exp(res.x[1]))
    return np.log(np.array(ells)), L_tensor, np.array(s2e_logs)


def pre_estimation_all(x, Y, z, P=10):
    """Fully free local MLE per inducing point (pre_nmgp.py:64-100): the
    output Cholesky too, started from the local sample Cholesky (the
    random start of the other entries drawn from default_rng(0), as in the
    JAX package).  Returns as `pre_estimation_partial`."""
    N, D = Y.shape
    s2e_logs, ells, Ls = [], [], []
    rng = np.random.default_rng(0)
    for z_m in z:
        x_loc, Y_loc = search_nearest_neighborhood(x, Y, z_m, P=P)
        est_L = np.linalg.cholesky(Y_loc.T @ Y_loc / (max(P, 2) - 1) + _JITTER * np.eye(D))
        p0 = rng.standard_normal(D * (D + 1) // 2 + 2)
        p0[0] = -6.0
        p0[1] = -6.0
        p0[2:] = est_L[np.tril_indices(D)]
        res = minimize(lambda p: -_loglik_all(p, x_loc, Y_loc), p0)
        s2e_logs.append(res.x[0])
        ells.append(np.exp(res.x[1]))
        L = np.zeros((D, D))
        L[np.tril_indices(D)] = res.x[2:]
        Ls.append(np.linalg.cholesky(L @ L.T + np.eye(D) * _JITTER))
    return np.log(np.array(ells)), np.stack(Ls, axis=-1), np.array(s2e_logs)


def pre_initialization(M, D, factor=1e-2):
    """The identity-sqrt variational init (nmgp_dsvi.py:737-742): (mu_W (D,
    M) zeros, sqrt_v (M, M), sqrt_W (D, M, M), sqrt_U (D(D+1)/2, M, M) in
    the packed layout of `models.cnmgp.CNMGPParams`), each factor * I."""
    mu_W = np.zeros([D, M])
    sqrt_v = np.eye(M) * factor
    sqrt_W = np.stack([np.eye(M) for _ in range(D)]) * factor
    sqrt_U = np.stack([np.eye(M) for _ in range(D * (D + 1) // 2)]) * factor
    return mu_W, sqrt_v, sqrt_W, sqrt_U
