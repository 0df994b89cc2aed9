"""Baseline GP models: independent GPR (IGPR) and the intrinsic
coregionalization model (ICM), exact inference, and their sparse forms
(SGPR, SICM) by the Titsias collapsed bound.

The JAX package's `models/baselines.py:38-399`.  The reference benchmarks
CNMGP against GPy baselines in notebooks (code/notebook/IGPR.ipynb, an
independent `GPRegression` per output with an Exponential kernel; ICM.ipynb,
`GPCoregionalizedRegression`; baseline_{PM25,HCP,ECoG}.ipynb, the sparse
`SparseGPRegression` / `SparseGPCoregionalizedRegression` with 100 inducing
points): marginal-likelihood hyperparameters fitted by Adam on the log
parameters.

Every factorization goes through `ops.linalg.cholesky` (the Cholesky kernel
with its Murray backward for float32 on the card, the plain `cholesky_ex`
version elsewhere) and every triangular solve is
`torch.linalg.solve_triangular`.  `kernel="rbf"` is `ops.kernels.rbf` (the
RBF kernel for float32 on the card); the exponential kernel is plain torch,
as the JAX package computes it in jnp.  The fits are Adam with non-finite
gradients zeroed (`infer.map.run_map`: `torch.optim.Adam`, the formula of
`optax.adam`), an eager loop of `steps` steps on the device.  `fit_*` run
on the first CUDA card unless `device` names another, in `dtype`; the
`predict_*` run where the model lies and return NumPy arrays, as the JAX
functions do.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device
from ..infer.map import run_map
from ..ops.kernels import rbf, sq_dist
from ..ops.linalg import cholesky

__all__ = [
    "ICMModel",
    "SGPRModel",
    "SICMModel",
    "exponential_kernel",
    "fit_igpr",
    "predict_igpr",
    "fit_icm",
    "predict_icm",
    "fit_sgpr",
    "predict_sgpr",
    "fit_sicm",
    "predict_sicm",
    "baselines_from_numpy",
]

_LOG_2PI = math.log(2 * math.pi)


def exponential_kernel(x1, x2, scale2, length_scale):
    """Exponential (Matern-1/2) kernel, GPy's `Exponential`, the kernel the
    reference's IGPR baseline uses (IGPR.ipynb)."""
    r = torch.sqrt(sq_dist(x1, x2) + 1e-12) / length_scale
    return scale2 * torch.exp(-r)


_KERNELS = {"exponential": exponential_kernel, "rbf": rbf}


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _lower_solve(L, b):
    """L^-1 b for lower-triangular L and b (n,) or (n, k)."""
    if b.ndim == 1:
        return torch.linalg.solve_triangular(L, b[:, None], upper=False)[:, 0]
    return torch.linalg.solve_triangular(L, b, upper=False)


def _cho_solve(L, b):
    """(L L^T)^-1 b for a vector b (`jax.scipy.linalg.cho_solve`)."""
    z = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L.mT, z, upper=True)[:, 0]


def _exact_parts(K, y):
    """(L, alpha = K^-1 y, negative log marginal likelihood) of exact GPR."""
    L = cholesky(K)
    alpha = _cho_solve(L, y)
    nlml = (0.5 * torch.dot(y, alpha) + torch.sum(torch.log(torch.diagonal(L)))
            + 0.5 * y.shape[0] * _LOG_2PI)
    return L, alpha, nlml


def _nlml(theta, x, y, kernel_fn):
    """Negative log marginal likelihood of exact GPR."""
    s2, ls, noise = torch.exp(theta)
    K = kernel_fn(x, x, s2, ls) + (noise + 1e-6) * _eye(x.shape[0], x)
    return _exact_parts(K, y)[2]


def _vector(v, device, dtype):
    return torch.as_tensor(np.asarray(v).reshape(-1), dtype=dtype, device=device)


def _stacked(X_list, Y_list, device, dtype):
    """The output lists as flat (x, y, output index) tensors."""
    x = _vector(np.concatenate([np.asarray(v).reshape(-1) for v in X_list]), device, dtype)
    y = _vector(np.concatenate([np.asarray(v).reshape(-1) for v in Y_list]), device, dtype)
    idx = np.concatenate([np.full(np.asarray(v).size, d) for d, v in enumerate(X_list)])
    return x, y, torch.as_tensor(idx, dtype=torch.int64, device=device)


def _numpy(t):
    return t.detach().cpu().numpy()


def fit_igpr(X_list, Y_list, kernel="exponential", steps=500, lr=0.05, device=None,
             dtype=DEFAULT_DTYPE):
    """Independent exact GP per output (reference IGPR baseline).

    Returns a list of (theta, x, y) model tuples of tensors."""
    kernel_fn = _KERNELS[kernel]
    device = resolve_device(device)
    models = []
    for x, y in zip(X_list, Y_list):
        x, y = _vector(x, device, dtype), _vector(y, device, dtype)
        theta0 = torch.zeros(3, dtype=dtype, device=device)
        theta, _ = run_map(lambda th: _nlml(th, x, y, kernel_fn), theta0, steps, lr)
        models.append((theta, x, y))
    return models


def predict_igpr(models, X_star_list, kernel="exponential"):
    """Predictive mean/std per output at new inputs, as NumPy arrays."""
    kernel_fn = _KERNELS[kernel]
    means, stds = [], []
    for (theta, x, y), xs in zip(models, X_star_list):
        xs = _vector(xs, x.device, x.dtype)
        s2, ls, noise = torch.exp(theta)
        K = kernel_fn(x, x, s2, ls) + (noise + 1e-6) * _eye(x.shape[0], x)
        L, alpha, _ = _exact_parts(K, y)
        ks = kernel_fn(x, xs, s2, ls)
        v = _lower_solve(L, ks)
        var = s2 - torch.sum(v * v, dim=0) + noise
        means.append(_numpy(ks.T @ alpha))
        stds.append(_numpy(torch.sqrt(torch.clamp(var, min=1e-10))))
    return means, stds


class ICMModel(NamedTuple):
    theta: torch.Tensor  # [log s2, log ls, log noise, W_vec (D*rank), log kappa (D)]
    x: torch.Tensor
    y: torch.Tensor
    idx: torch.Tensor
    D: int
    rank: int
    kernel: str


def _coregionalization(theta, D, rank):
    """(W (D, rank), kappa (D,)) of B = W W^T + diag(kappa)."""
    W = theta[3:3 + D * rank].reshape(D, rank)
    return W, torch.exp(theta[3 + D * rank:3 + D * rank + D])


def _icm_cov(theta, x1, idx1, x2, idx2, D, rank, kernel_fn):
    W, kappa = _coregionalization(theta, D, rank)
    B = W @ W.T + torch.diag(kappa)
    Kx = kernel_fn(x1, x2, torch.exp(theta[0]), torch.exp(theta[1]))
    return Kx * B[idx1[:, None], idx2[None, :]]


def _icm_train_parts(theta, x, y, idx, D, rank, kernel_fn):
    noise = torch.exp(theta[2])
    K = _icm_cov(theta, x, idx, x, idx, D, rank, kernel_fn) + (noise + 1e-6) * _eye(x.shape[0], x)
    return _exact_parts(K, y)


def fit_icm(X_list, Y_list, rank=1, kernel="exponential", steps=500, lr=0.05, device=None,
            dtype=DEFAULT_DTYPE):
    """Intrinsic coregionalization model, exact inference (reference ICM
    baseline, `GPCoregionalizedRegression`)."""
    kernel_fn = _KERNELS[kernel]
    device = resolve_device(device)
    D = len(X_list)
    x, y, idx = _stacked(X_list, Y_list, device, dtype)
    theta0 = torch.cat([torch.zeros(3), torch.full((D * rank,), 0.5), torch.full((D,), -1.0)])
    theta, _ = run_map(lambda th: _icm_train_parts(th, x, y, idx, D, rank, kernel_fn)[2],
                       theta0.to(dtype=dtype, device=device), steps, lr)
    return ICMModel(theta, x, y, idx, D, rank, kernel)


def predict_icm(model: ICMModel, X_star_list: Sequence):
    """Predictive mean/std per output, as NumPy arrays."""
    kernel_fn = _KERNELS[model.kernel]
    theta, x = model.theta, model.x
    noise = torch.exp(theta[2])
    L, alpha, _ = _icm_train_parts(theta, x, model.y, model.idx, model.D, model.rank, kernel_fn)
    means, stds = [], []
    for d, xs in enumerate(X_star_list):
        xs = _vector(xs, x.device, x.dtype)
        idxs = torch.full((xs.shape[0],), d, dtype=torch.int64, device=x.device)
        ks = _icm_cov(theta, x, model.idx, xs, idxs, model.D, model.rank, kernel_fn)
        v = _lower_solve(L, ks)
        prior = _icm_cov(theta, xs, idxs, xs, idxs, model.D, model.rank, kernel_fn)
        var = torch.diagonal(prior) - torch.sum(v * v, dim=0) + noise
        means.append(_numpy(ks.T @ alpha))
        stds.append(_numpy(torch.sqrt(torch.clamp(var, min=1e-10))))
    return means, stds


# ---------------------------------------------------------------------------
# Sparse baselines (Titsias collapsed bound).  The reference's real-data
# baselines are GPy `SparseGPRegression` / `SparseGPCoregionalizedRegression`
# with 100 inducing points (code/notebook/baseline_{PM25,HCP,ECoG}.ipynb).
# ---------------------------------------------------------------------------


def _titsias_parts(Kuu, Kuf, kff_diag, y, noise, jitter=1e-4):
    """Shared Titsias-bound factorization.

    Returns (nbound, Luu, LB, c) with c = LB^{-1} A y / sigma, so both the
    collapsed negative bound and the predictive reuse one factorization.
    The 1e-4 jitter keeps the f32 Cholesky of Kuu finite when trainable
    inducing inputs drift together (1e-6 is below f32 rounding at M=100).
    """
    M, n = Kuu.shape[0], y.shape[0]
    sigma = torch.sqrt(noise)
    Luu = cholesky(Kuu + jitter * _eye(M, Kuu))
    A = _lower_solve(Luu, Kuf) / sigma  # (M, n)
    LB = cholesky(_eye(M, Kuu) + A @ A.T)
    c = _lower_solve(LB, A @ y) / sigma
    nbound = (
        0.5 * n * torch.log(2 * math.pi * noise)
        + torch.sum(torch.log(torch.diagonal(LB)))
        + 0.5 * (torch.dot(y, y) / noise - torch.dot(c, c))
        + 0.5 / noise * (torch.sum(kff_diag) - noise * torch.sum(A * A))
    )
    return nbound, Luu, LB, c


def _titsias_predict(Luu, LB, c, Kus, kss_diag, noise):
    """SGPR predictive mean/var at test points given the shared factors."""
    w = _lower_solve(Luu, Kus)  # (M, n*)
    w2 = _lower_solve(LB, w)
    var = kss_diag - torch.sum(w * w, dim=0) + torch.sum(w2 * w2, dim=0) + noise
    return w2.T @ c, torch.clamp(var, min=1e-10)


def _inducing_init(x, m):
    """Quantile-spread inducing inputs over the data range (NumPy float64).

    A tiny arithmetic spread breaks exact ties (duplicate observed inputs
    would otherwise produce duplicate inducing points and a singular Kuu).
    """
    x = np.asarray(x, dtype=np.float64)
    qs = np.quantile(x, np.linspace(0.0, 1.0, m))
    span = max(float(x.max() - x.min()), 1.0)
    return qs + 1e-5 * span * np.arange(m)


class SGPRModel(NamedTuple):
    theta: torch.Tensor  # [log s2, log ls, log noise]
    Z: torch.Tensor  # (m,) inducing inputs
    x: torch.Tensor
    y: torch.Tensor
    kernel: str


def _sgpr_parts(theta, Z, x, y, kernel_fn):
    s2, ls, noise = torch.exp(theta)
    kff = s2 * torch.ones_like(x)
    noise = noise + 1e-6
    return _titsias_parts(kernel_fn(Z, Z, s2, ls), kernel_fn(Z, x, s2, ls), kff, y, noise), noise


def fit_sgpr(X_list, Y_list, num_inducing=100, kernel="exponential", steps=500, lr=0.05,
             device=None, dtype=DEFAULT_DTYPE):
    """Independent sparse GP per output (reference `SparseGPRegression`
    baseline): Titsias collapsed bound, trainable inducing inputs.

    Returns a list of `SGPRModel`s."""
    kernel_fn = _KERNELS[kernel]
    device = resolve_device(device)
    models = []
    for x, y in zip(X_list, Y_list):
        x, y = _vector(x, device, dtype), _vector(y, device, dtype)
        m = min(num_inducing, x.shape[0])
        pars0 = torch.cat([torch.zeros(3, dtype=dtype, device=device),
                           _vector(_inducing_init(_numpy(x), m), device, dtype)])
        pars, _ = run_map(lambda p: _sgpr_parts(p[:3], p[3:], x, y, kernel_fn)[0][0], pars0,
                          steps, lr)
        models.append(SGPRModel(pars[:3], pars[3:], x, y, kernel))
    return models


def predict_sgpr(models, X_star_list, kernel=None):
    """Predictive mean/std per output for `fit_sgpr` models, as NumPy arrays.

    The kernel is taken from each fitted model; the `kernel` argument only
    overrides for legacy (theta, Z, x, y) tuples without one.
    """
    means, stds = [], []
    for model, xs in zip(models, X_star_list):
        theta, Z, x, y = model[:4]
        kname = model.kernel if isinstance(model, SGPRModel) else (kernel or "exponential")
        kernel_fn = _KERNELS[kname]
        xs = _vector(xs, x.device, x.dtype)
        (_, Luu, LB, c), noise = _sgpr_parts(theta, Z, x, y, kernel_fn)
        s2, ls = torch.exp(theta[0]), torch.exp(theta[1])
        mu, var = _titsias_predict(Luu, LB, c, kernel_fn(Z, xs, s2, ls), s2 * torch.ones_like(xs),
                                   noise)
        means.append(_numpy(mu))
        stds.append(_numpy(torch.sqrt(var)))
    return means, stds


class SICMModel(NamedTuple):
    theta: torch.Tensor  # [log s2, log ls, log noise, W_vec, log kappa]
    Z: torch.Tensor  # (M,) inducing inputs
    zidx: torch.Tensor  # (M,) inducing task indices
    x: torch.Tensor
    y: torch.Tensor
    idx: torch.Tensor
    D: int
    rank: int
    kernel: str


def _icm_diag(theta, idx, D, rank):
    """Diagonal of the ICM kernel at (x, idx) in O(N): Kx(x,x)=s2 and the
    coregionalization factor gathers as B[idx, idx]."""
    W, kappa = _coregionalization(theta, D, rank)
    b_diag = torch.sum(W * W, dim=1) + kappa  # diag(W W^T + diag(kappa))
    return torch.exp(theta[0]) * b_diag[idx]


def _sicm_parts(theta, Z, zidx, x, y, idx, D, rank, kernel_fn):
    noise = torch.exp(theta[2]) + 1e-6
    Kuu = _icm_cov(theta, Z, zidx, Z, zidx, D, rank, kernel_fn)
    Kuf = _icm_cov(theta, Z, zidx, x, idx, D, rank, kernel_fn)
    kff = _icm_diag(theta, idx, D, rank)  # O(N), never forms the N x N gram
    return _titsias_parts(Kuu, Kuf, kff, y, noise), noise


def fit_sicm(X_list, Y_list, num_inducing=100, rank=1, kernel="exponential", steps=500, lr=0.05,
             device=None, dtype=DEFAULT_DTYPE):
    """Sparse coregionalized GP (reference `SparseGPCoregionalizedRegression`
    baseline): ICM kernel on the joint (x, task) space, inducing points
    spread over x with round-robin task assignment, Titsias collapsed bound
    with trainable inducing inputs."""
    kernel_fn = _KERNELS[kernel]
    device = resolve_device(device)
    D = len(X_list)
    x, y, idx = _stacked(X_list, Y_list, device, dtype)
    m = min(num_inducing, x.shape[0])
    zidx = torch.arange(m, device=device) % D
    n_hyp = 3 + D * rank + D
    pars0 = torch.cat([torch.zeros(3), torch.full((D * rank,), 0.5), torch.full((D,), -1.0)])
    pars0 = torch.cat([pars0.to(dtype=dtype, device=device),
                       _vector(_inducing_init(_numpy(x), m), device, dtype)])

    def loss(pars):
        return _sicm_parts(pars[:n_hyp], pars[n_hyp:], zidx, x, y, idx, D, rank, kernel_fn)[0][0]

    pars, _ = run_map(loss, pars0, steps, lr)
    return SICMModel(pars[:n_hyp], pars[n_hyp:], zidx, x, y, idx, D, rank, kernel)


def predict_sicm(model: SICMModel, X_star_list: Sequence):
    """Predictive mean/std per output for `fit_sicm` models, as NumPy arrays."""
    kernel_fn = _KERNELS[model.kernel]
    theta, Z, zidx, D, rank = model.theta, model.Z, model.zidx, model.D, model.rank
    (_, Luu, LB, c), noise = _sicm_parts(theta, Z, zidx, model.x, model.y, model.idx, D, rank,
                                         kernel_fn)
    means, stds = [], []
    for d, xs in enumerate(X_star_list):
        xs = _vector(xs, Z.device, Z.dtype)
        idxs = torch.full((xs.shape[0],), d, dtype=torch.int64, device=Z.device)
        Kus = _icm_cov(theta, Z, zidx, xs, idxs, D, rank, kernel_fn)
        mu, var = _titsias_predict(Luu, LB, c, Kus, _icm_diag(theta, idxs, D, rank), noise)
        means.append(_numpy(mu))
        stds.append(_numpy(torch.sqrt(var)))
    return means, stds


_MODELS = {frozenset(cls._fields): cls for cls in (ICMModel, SGPRModel, SICMModel)}


def baselines_from_numpy(model, device=None, dtype=torch.float64):
    """A fit of the JAX package (or of this module) with its arrays as NumPy
    (or any array type) -> the same model of this module on `device`: an
    IGPR list of (theta, x, y), an `ICMModel`, a list of `SGPRModel`s or an
    `SICMModel`, told apart by their fields.  Float arrays become `dtype`
    tensors, the output indices int64; D, rank and the kernel name are
    kept (as Python values, also when given as 0-d arrays)."""
    device = resolve_device(device)
    if isinstance(model, list):
        return [baselines_from_numpy(m, device, dtype) for m in model]

    def tensor(a):
        a = np.asarray(a)
        kind = torch.int64 if np.issubdtype(a.dtype, np.integer) else dtype
        return torch.tensor(a, dtype=kind, device=device)  # a copy: JAX arrays are read-only

    fields = getattr(model, "_fields", None)
    if fields is None:  # IGPR's (theta, x, y)
        return tuple(tensor(a) for a in model)
    cls = _MODELS[frozenset(fields)]
    kept = {"D": int, "rank": int, "kernel": str}
    return cls(**{f: kept[f](getattr(model, f)) if f in kept else tensor(getattr(model, f))
                  for f in cls._fields})
