"""Empirical (variogram-based) parameter estimation for MCMC initialization.

The port's own NumPy/SciPy copy of the JAX package's `utils/empirical.py:
31-219` (reference `SIM_code/Utility/empirical_estimation.py:35-140`):
sliding-window Gaussian variogram fits for the local (sigma, ell), windowed
sample covariances for the local Cholesky process, a moving-average
smoother, and the reference's `empirical_est.pickle` I/O and diagnostic
figures (`:116-219`; a file either package writes, the other loads).  The
pair loops go through `utils.native`, where the JAX package sends them: the
repository's C++ host library, or that module's NumPy versions of the same
loops, in the same pair order, where no compiler is present.  Importing the
JAX module would run the JAX package's `__init__`.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import curve_fit

from ..config import PRECISION
from . import native
from .visualization import _plt

__all__ = [
    "semivariogram",
    "variogram_gaussian",
    "global_estimation",
    "local_estimation",
    "smooth",
    "save_estimates",
    "load_estimates",
    "plot_estimates",
]


def semivariogram(x, Y, indx):
    """Experimental semivariogram of output `indx` over all lags
    (empirical_estimation.py:35-56): (lag, sv)."""
    return native.semivariogram(np.asarray(x), np.asarray(Y)[:, indx])


def variogram_gaussian(s, sigma, l):
    """Gaussian variogram model (empirical_estimation.py:59-60)."""
    return sigma**2 * (1 - np.exp(-0.5 * s**2 / l**2))


def global_estimation(x, Y):
    """Global covariance Cholesky (empirical_estimation.py:63-68)."""
    M = Y.shape[1]
    S = np.cov(Y.T)
    L_f = np.linalg.cholesky(S + PRECISION * np.eye(M))
    return S, L_f[np.tril_indices(M)]


def local_estimation(x, Y, window_size: int = 30):
    """Sliding-window local parameter estimation
    (empirical_estimation.py:71-140).  Returns a dict of per-point arrays:
    sigmas (N,), ls (N,), L_vecs (N, M(M+1)/2), stds (N, M), R (N, M, M)
    local correlations, B (N, M, M) covariances."""
    x = np.asarray(x, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    N, M = Y.shape
    sigmas, ls, L_vecs, stds, Rs, Bs = [], [], [], [], [], []
    S_all = native.windowed_scatter_cov(Y, window_size)
    for n in range(N):
        start = max(0, n - window_size)
        end = min(n + window_size, N - 1)
        x_seg, Y_seg = x[start:end], Y[start:end]
        lag, sv_all = native.semivariogram_multi(x_seg, Y_seg)
        cofs = []
        for m in range(M):
            try:
                cof, _ = curve_fit(variogram_gaussian, lag, sv_all[m], maxfev=2000)
            except RuntimeError:
                cof = np.array([np.std(Y_seg[:, m]), np.ptp(x_seg) / 2 + 1e-6])
            cofs.append(np.abs(cof))
        cof = np.mean(np.stack(cofs), axis=0)
        sigmas.append(cof[0])
        ls.append(cof[1])
        S = S_all[n]
        try:
            L_f = np.linalg.cholesky(S)
        except np.linalg.LinAlgError:
            S = S + PRECISION * np.eye(M)
            L_f = np.linalg.cholesky(S)
        Bs.append(S)
        L_vecs.append(L_f[np.tril_indices(M)])
        D = np.sqrt(np.diag(S))
        stds.append(D)
        Rs.append(np.diag(1.0 / D) @ S @ np.diag(1.0 / D))
    return dict(sigmas=np.array(sigmas), ls=np.array(ls), L_vecs=np.stack(L_vecs),
                stds=np.stack(stds), R=np.stack(Rs), B=np.stack(Bs))


def smooth(a, window: int = 10):
    """Centred moving-average smoother (the reference smooths its local
    estimates before initializing samplers)."""
    a = np.asarray(a, dtype=float)
    kernel = np.ones(window) / window
    pad = window // 2
    padded = np.pad(a, ((pad, window - 1 - pad),) + ((0, 0),) * (a.ndim - 1), mode="edge")
    out = np.apply_along_axis(lambda v: np.convolve(v, kernel, mode="valid"), 0, padded)
    return out[: a.shape[0]]


def save_estimates(path, est):
    """Persist empirical estimates in the reference's `empirical_est.pickle`
    format: `[log(est_ls), log(smooth_ls), est_L_vecs, est_tilde_sigma2_err]`
    (`save_res`, empirical_estimation.py:185-190).  `est` is the dict from
    `local_estimation` (an `ls_smooth` key is used if present, else
    `smooth(ls)`); `tilde_sigma2_err` defaults to the reference's constant
    -4 (empirical_estimation.py:124)."""
    import pickle

    ls = np.asarray(est["ls"], dtype=float)
    smooth_ls = np.asarray(est.get("ls_smooth", smooth(ls)), dtype=float)
    ts2e = float(est.get("tilde_sigma2_err", -4.0))
    with open(path, "wb") as f:
        pickle.dump(
            [np.log(ls), np.log(smooth_ls), np.asarray(est["L_vecs"]).ravel(), ts2e],
            f,
        )
    return path


def load_estimates(path):
    """Inverse of `save_estimates`: returns
    (tilde_ls, smooth_tilde_ls, L_vecs_flat, tilde_sigma2_err) — the log-
    space arrays the reference's sampler drivers consume
    (synthetic_plot.py:16-30 loads this exact layout).  Unpickling runs
    code from the file: load only files this program wrote."""
    import pickle

    with open(path, "rb") as f:
        tilde_ls, smooth_tilde_ls, L_vecs, ts2e = pickle.load(f)
    return (
        np.asarray(tilde_ls),
        np.asarray(smooth_tilde_ls),
        np.asarray(L_vecs),
        float(ts2e),
    )


def plot_estimates(x, Y, est, save_dir, attributes=None, prefix="empirical"):
    """Diagnostic plots of the local estimates (`visualization`,
    empirical_estimation.py:136-182): log-lengthscale (raw + smoothed),
    per-dim local stds, pairwise local correlations, and the local Cholesky
    entries.  Writes PNGs under `save_dir`, returns their paths."""
    import os

    plt = _plt()
    x = np.asarray(x).reshape(-1)
    Y = np.asarray(Y)
    M = Y.shape[1]
    if attributes is None:
        attributes = [f"Dim {m + 1}" for m in range(M)]
    ls = np.asarray(est["ls"], dtype=float)
    smooth_ls = np.asarray(est.get("ls_smooth", smooth(ls)), dtype=float)
    os.makedirs(save_dir, exist_ok=True)
    paths = []

    fig = plt.figure()
    plt.plot(x, np.log(ls), label="local")
    plt.plot(x, np.log(smooth_ls), label="smoothed")
    plt.ylabel("log lengthscale")
    plt.legend()
    p = os.path.join(save_dir, f"{prefix}_log_l.png")
    plt.savefig(p)
    plt.close(fig)
    paths.append(p)

    fig = plt.figure()
    for m in range(M):
        plt.plot(x, est["stds"][:, m], label=attributes[m])
    plt.ylabel("local std")
    plt.legend()
    p = os.path.join(save_dir, f"{prefix}_std.png")
    plt.savefig(p)
    plt.close(fig)
    paths.append(p)

    fig = plt.figure()
    for i in range(M):
        for j in range(i + 1, M):
            plt.plot(x, est["R"][:, i, j], label=f"{attributes[i]}~{attributes[j]}")
    plt.ylabel("local correlation")
    plt.legend()
    p = os.path.join(save_dir, f"{prefix}_R.png")
    plt.savefig(p)
    plt.close(fig)
    paths.append(p)

    fig = plt.figure()
    L_f = np.asarray(est["L_vecs"])
    k = 0
    for i in range(M):
        for j in range(i + 1):
            plt.plot(x, L_f[:, k], label=f"L_{attributes[i]}_{attributes[j]}")
            k += 1
    plt.ylabel("local Cholesky entries")
    plt.legend()
    p = os.path.join(save_dir, f"{prefix}_L.png")
    plt.savefig(p)
    plt.close(fig)
    paths.append(p)
    return paths
