"""Posterior-sample analysis in NumPy: history unpackers, cov -> corr and
the correlation processes of the Cholesky vecs, quantile summaries.

The port's own copy of the JAX package's `utils/posterior_analysis.py:167-245`
(reference `SIM_code/Utility/posterior_analysis.py`): importing that module
would run the JAX package's `__init__`.  Its plots are not ported yet.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "unpack_hist_snmgp",
    "unpack_hist_svc",
    "unpack_hist_lmc",
    "unpack_est_snmgp",
    "unpack_est_svc",
    "unpack_est_lmc",
    "cov2cor",
    "samples2quantiles",
    "lvecs_to_corr",
]


def _tri_size(m):
    return m * (m + 1) // 2


def _lvec_to_tril_np(v, m):
    L = np.zeros(v.shape[:-1] + (m, m))
    r, c = np.tril_indices(m)
    L[..., r, c] = v
    return L


def _uvec_to_lvec_np(u, m):
    """exp on the diagonal entries of a tril vec (`ops.linalg.uvec_to_lvec`)."""
    mask = np.zeros(u.shape[-1], dtype=bool)
    mask[np.cumsum(np.arange(1, m + 1)) - 1] = True
    return np.where(mask, np.exp(u), u)


def unpack_hist_snmgp(pars_hist, N, M):
    """(S, dim) -> (tilde_l (S, N), tilde_sigma (S, N), uL_vec (S, T),
    tilde_sigma2_err (S,)) (reference `vec2pars`, posterior_analysis.py:59-68)."""
    pars_hist = np.asarray(pars_hist)
    T = _tri_size(M)
    return (pars_hist[:, :N], pars_hist[:, N:2 * N], pars_hist[:, 2 * N:2 * N + T],
            pars_hist[:, -1])


def unpack_hist_svc(pars_hist, N, M):
    """Reference `vec2pars_SVC` (posterior_analysis.py:70-77)."""
    pars_hist = np.asarray(pars_hist)
    T = _tri_size(M)
    return pars_hist[:, :N], pars_hist[:, N:N + N * T], pars_hist[:, -1]


def unpack_hist_lmc(pars_hist, M):
    """Reference `vec2pars_S` (posterior_analysis.py:79-88)."""
    pars_hist = np.asarray(pars_hist)
    T = _tri_size(M)
    return pars_hist[:, 0], pars_hist[:, 1], pars_hist[:, 2:2 + T], pars_hist[:, -1]


def unpack_est_snmgp(pars, N, M):
    """Point-estimate unpacker (posterior_analysis.py:15-24)."""
    return unpack_hist_snmgp(np.asarray(pars)[None], N, M)


def unpack_est_svc(pars, N, M):
    return unpack_hist_svc(np.asarray(pars)[None], N, M)


def unpack_est_lmc(pars, M):
    return unpack_hist_lmc(np.asarray(pars)[None], M)


def cov2cor(S):
    """Covariance -> correlation (posterior_analysis.py:47-56), batched."""
    S = np.asarray(S)
    d = 1.0 / np.sqrt(np.diagonal(S, axis1=-2, axis2=-1))
    return S * d[..., :, None] * d[..., None, :]


def lvecs_to_corr(uL_vecs, N, M, constrained=False):
    """Per-point (unconstrained, unless `constrained`) Cholesky vecs
    (..., N*T) -> (..., N, M, M) correlation matrices (the
    correlation-process recovery of synthetic_plot.py:101-142)."""
    T = _tri_size(M)
    u = np.asarray(uL_vecs).reshape(np.shape(uL_vecs)[:-1] + (N, T))
    lv = u if constrained else _uvec_to_lvec_np(u, M)
    L = _lvec_to_tril_np(lv, M)
    return cov2cor(L @ np.swapaxes(L, -1, -2))


def samples2quantiles(pos_sample, percentiles=(2.5, 50.0, 97.5)):
    """(S, ...) -> (len(percentiles), ...) (posterior_analysis.py:90-98)."""
    return np.percentile(np.asarray(pos_sample), q=list(percentiles), axis=0)
