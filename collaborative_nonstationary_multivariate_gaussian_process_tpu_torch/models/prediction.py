"""Posterior prediction from MCMC draws and MAP estimates.

The JAX package's `models/prediction.py`, every public function (the
reference's `SIM_code/Utility/prediction.py` families): isotopic SNMGP, SVC
and LMC predictive draws and plug-in MAP bands, conditional draws of the
latent processes, the heterotopic (hadamard) families and their
indexed-point wrappers.  The JAX functions vmap a computation at one scalar
x* over the grid, then over the S draws; here each call is one batched
computation with a leading draw dimension S and a grid dimension G:

  - a latent-prior gram depends only on x and its hyperparameters, not on
    the draw or the point, so both latent priors of a family are factored
    once per call (one `rbf` launch for their grams and cross columns, one
    `cholesky` launch), solved for all G points at once, and the
    conditional means of every draw (and, for SVC, every Cholesky-entry
    process) are one matrix product;
  - each draw's train covariance (Kronecker eigenpairs for SNMGP and LMC, a
    dense factor for SVC and the hadamard families) is batched over the
    draws, and the cross-covariances of every (draw, point) pair are one
    Gibbs (or, for the stationary hadamard LMC, RBF) gram;
  - the solves take every point and output as right-hand sides, and a
    predictive variance needs only the diagonal of prior - V^T V, a sum of
    squares.

Kernels on this path, through `ops/`: the Gibbs gram (`nonstationary_rbf`),
the RBF gram (`rbf`) and the batched Cholesky (`ops.linalg.cholesky`, where
the JAX package calls `jnp.linalg.cholesky`).  `torch.linalg.eigh`, the
triangular solves and the products are library calls, as the JAX package
computes them outside Pallas.

Every `*_predsample` takes its standard-normal draws as `noise`, a
NamedTuple of tensors whose fields mirror the JAX function's key tree
(`SNMGPNoise`, `SVCNoise`, `LMCNoise`), or draws them from a generator on
the device seeded by `seed` (the same seed gives other draws than the JAX
function).  Draws are taken DRAWS_PER_CHUNK at a time.  `hists` and
`map_draw` are tuples of NumPy arrays or tensors in the JAX package's
layout, so draws from either package predict in the other.  The entry
points run on the first CUDA card unless `device` names another, in `dtype`
(float32, the kernels; float64 takes the plain versions), and return
tensors on the device.  Variances are floored at PRECISION, as the
reference clips them (prediction.py:59-60,121).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import DEFAULT_DTYPE, MCMC_JITTER, PRECISION, resolve_device
from ..ops.kernels import nonstationary_rbf, rbf
from ..ops.linalg import cholesky, uvec_to_lvec, vec_to_tril
from .logdensities import _prior_jitter, svc_covariance, tri_size

__all__ = [
    "DRAWS_PER_CHUNK",
    "SNMGPNoise",
    "SVCNoise",
    "LMCNoise",
    "snmgp_predsample",
    "snmgp_predmap",
    "snmgp_predmap_sampling",
    "svc_predsample",
    "svc_predmap",
    "svc_predmap_sampling",
    "lmc_predsample",
    "lmc_predmap",
    "snmgp_latent_predsample",
    "svc_latent_predsample",
    "snmgp_hadamard_predsample",
    "snmgp_hadamard_predmap",
    "lmc_hadamard_predsample",
    "lmc_hadamard_predmap",
    "svc_hadamard_predsample",
    "svc_hadamard_predmap",
    "snmgp_hadamard_indexedpoint_predsample",
    "snmgp_hadamard_indexedpoint_predmap",
    "svc_hadamard_indexedpoint_predmap",
    "lmc_hadamard_indexedpoint_predmap",
    "svc_hadamard_indexedpoint_predsample",
    "lmc_hadamard_indexedpoint_predsample",
]

# Draws computed together.  The largest operand of a chunk is SVC's (S, MN,
# G M) cross-covariance: ~77 MB in float32 at 256 draws, N = 100, M = 2 and
# G = 200, and the (S, MN, MN) factors beside it.
DRAWS_PER_CHUNK = 256


class SNMGPNoise(NamedTuple):
    """Standard-normal draws of the SNMGP families: the two latent
    processes at each (draw, point), and y* (None for the latent draws)."""

    tilde_l: torch.Tensor  # (S, G)
    tilde_sigma: torch.Tensor  # (S, G)
    y: Optional[torch.Tensor] = None  # (S, G, M)


class SVCNoise(NamedTuple):
    """Standard-normal draws of the SVC families: the lengthscale process
    and the T Cholesky-entry processes at each (draw, point), and y* (None
    for the latent draws)."""

    tilde_l: torch.Tensor  # (S, G)
    L: torch.Tensor  # (S, G, T)
    y: Optional[torch.Tensor] = None  # (S, G, M)


class LMCNoise(NamedTuple):
    """Standard-normal draws of the stationary LMC families: y* only."""

    y: torch.Tensor  # (S, G, M)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


class _Inputs:
    """Converts NumPy arrays, tensors and Python numbers to tensors of one
    dtype on one device."""

    def __init__(self, device, dtype):
        self.device = resolve_device(device)
        self.dtype = dtype

    def __call__(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def index(self, a):
        return torch.as_tensor(a, device=self.device).reshape(-1).long()

    def hists(self, hists, n_sample=None):
        """The draws of `hists` (each (S, ...)), the last `n_sample` kept."""
        out = tuple(self(h) for h in hists)
        return out if n_sample is None else tuple(h[-n_sample:] for h in out)

    def map_draw(self, map_draw):
        """A MAP estimate as one draw, (1, ...) each."""
        return tuple(self(v)[None] for v in map_draw)

    def noise(self, cls, noise, seed, **shapes):
        """`noise` checked against `shapes` and moved here, or fresh draws
        from a generator seeded by `seed`, one field after another."""
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return cls(**{name: torch.randn(shape, generator=gen, dtype=self.dtype,
                                            device=self.device)
                          for name, shape in shapes.items()})
        out = {}
        for name, shape in shapes.items():
            z = getattr(noise, name)
            if z is None or tuple(z.shape) != shape:
                got = None if z is None else tuple(z.shape)
                raise ValueError(f"noise.{name}: expected shape {shape}, got {got}")
            out[name] = z.to(device=self.device, dtype=self.dtype)
        return cls(**out)


def _by_draws(fn, n):
    """fn(slice) over the draws DRAWS_PER_CHUNK at a time, its outputs (a
    tensor or a tuple of them, draws first) concatenated."""
    parts = [fn(slice(i, min(i + DRAWS_PER_CHUNK, n))) for i in range(0, n, DRAWS_PER_CHUNK)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _on_device(values, like):
    """Python numbers as a tensor on `like`'s device, filled there: a copy
    from the host would wait for the device, and a call given device
    tensors makes none."""
    return torch.stack([like.new_full((), v) for v in values])


def _chol_solve(chol, B):
    """(L L^T)^-1 B by two triangular solves, as `cho_solve` does;
    torch.cholesky_solve may read its status on the host."""
    return torch.linalg.solve_triangular(
        chol.mT, torch.linalg.solve_triangular(chol, B, upper=False), upper=True)


class _LatentPriors(NamedTuple):
    """The conditionals at x* of latent GPs under stationary RBF priors,
    given their values at x: W = (K + jitter I)^-1 k* (P, N, G) and the
    conditional variances (P, G), one row per prior (`_cond_gp_moments`,
    prediction.py:52-71 idiom)."""

    W: torch.Tensor
    var: torch.Tensor
    mu: tuple


def _latent_priors(x, x_stars, *priors):
    """`_LatentPriors` of the (mu, alpha, beta) priors: their grams and
    cross columns in one `rbf` launch, their factors in one `cholesky`
    launch, every grid point solved at once.  The jitter is the JAX
    package's `_prior_jitter(dtype, alpha)`; each variance is floored at
    PRECISION."""
    N = x.shape[0]
    mu, alpha, beta = zip(*priors)
    jitter = [_prior_jitter(x.dtype, v) for v in alpha]
    a, b, jitter = (_on_device(v, x) for v in (alpha, beta, jitter))
    K = rbf(x, torch.cat([x, x_stars]), a**2, b)  # (P, N, N + G)
    k = K[..., N:]
    W = _chol_solve(cholesky(K[..., :N] + jitter[:, None, None] * _eye(N, x)), k)
    var = torch.clamp(a[:, None] ** 2 - torch.sum(W * k, dim=-2), min=PRECISION)
    return _LatentPriors(W, var, mu)


def _cond_means(priors, p, vals):
    """Conditional means at x* under prior p given each draw's values at x:
    mu + (vals - mu) W_p, vals (S, N) -> (S, G), or the T Cholesky-entry
    processes (S, N, T) -> (S, G, T)."""
    mu = priors.mu[p]
    return mu + torch.einsum("sn...,ng->sg...", vals - mu, priors.W[p])


def _cond_draws(priors, p, vals, z):
    """Conditional draws: the means + sqrt(var) z, z shaped as the means."""
    sd = torch.sqrt(priors.var[p])
    return _cond_means(priors, p, vals) + sd.reshape(sd.shape + (1,) * (z.ndim - 2)) * z


def _percentiles(mu_f, sigma2_y):
    """[mu - 1.96 sd, mu, mu + 1.96 sd] stacked first, the reference's
    `percentile_y` (prediction.py:405-407)."""
    sd = torch.sqrt(sigma2_y)
    return torch.stack([mu_f - 1.96 * sd, mu_f, mu_f + 1.96 * sd])


# ---------------------------------------------------------------------------
# SNMGP (separable): Kronecker eigenpairs of each draw
# ---------------------------------------------------------------------------


class _SNMGPCache(NamedTuple):
    B_f: torch.Tensor  # (S, M, M)
    v_B: torch.Tensor  # (S, M, M)
    v_K: torch.Tensor  # (S, N, N)
    wt: torch.Tensor  # 1 / (sigma2_err + w_B w_K), (S, M, N)
    b: torch.Tensor  # (v_B kron v_K)^T y, (S, M, N)
    sigma2_err: torch.Tensor  # (S,)
    l: torch.Tensor  # (S, N)
    sigma: torch.Tensor  # (S, N)


def _snmgp_precompute(draw, Y, x, M) -> _SNMGPCache:
    """Each draw's factorization (the eigh + U^T y of prediction.py:86-97):
    draw = (tilde_l (S, N), tilde_sigma (S, N), uL_vec (S, T), tilde_s2e
    (S,)), the Cholesky vector unconstrained (exp on the diagonal)."""
    tilde_l, tilde_sigma, uL_vec, tilde_s2e = draw
    L = vec_to_tril(uvec_to_lvec(uL_vec, M), M)
    B_f = L @ L.mT
    l, sigma, sigma2_err = torch.exp(tilde_l), torch.exp(tilde_sigma), torch.exp(tilde_s2e)
    K_x = nonstationary_rbf(x, sigma1=sigma, ell1=l) + MCMC_JITTER * _eye(x.shape[0], x)
    w_B, v_B = torch.linalg.eigh(B_f)
    w_K, v_K = torch.linalg.eigh(K_x)
    wt = 1.0 / (sigma2_err[:, None, None] + w_B[:, :, None] * w_K[:, None, :])
    b = v_B.mT @ Y.T @ v_K
    return _SNMGPCache(B_f, v_B, v_K, wt, b, sigma2_err, l, sigma)


def _snmgp_ystar_moments(cache: _SNMGPCache, x, x_stars, l_star, s_star):
    """Predictive (mu_y, sigma2_y), each (S, G, M), at every x* given the
    latent values (l_star, s_star) (S, G) there (prediction.py:84-122
    math).  In the eigenbasis A[m; a, k] = C[a, m] kv[k] with C = v_B^T
    B_f and kv = v_K^T k_x, so its products with b wt and wt reduce to
    matrix products over k."""
    k_x = nonstationary_rbf(x, x_stars, sigma1=cache.sigma, ell1=cache.l, sigma2=s_star,
                            ell2=l_star)  # (S, N, G)
    kv = cache.v_K.mT @ k_x
    C = cache.v_B.mT @ cache.B_f
    mu_f = torch.einsum("sam,sag->sgm", C, (cache.b * cache.wt) @ kv)
    reduction = torch.einsum("sam,sag->sgm", C * C, cache.wt @ (kv * kv))
    B_diag = torch.diagonal(cache.B_f, dim1=-2, dim2=-1)
    prior_var = B_diag[:, None, :] * (s_star * s_star)[..., None]
    sigma2_y = torch.clamp(prior_var - reduction + cache.sigma2_err[:, None, None], min=PRECISION)
    return mu_f, sigma2_y


def snmgp_predsample(
    hists,
    Y,
    x,
    x_stars,
    mu_tilde_l=0.0,
    alpha_tilde_l=1.0,
    beta_tilde_l=1.0,
    mu_tilde_sigma=0.0,
    alpha_tilde_sigma=1.0,
    beta_tilde_sigma=1.0,
    n_sample=None,
    seed=0,
    noise: Optional[SNMGPNoise] = None,
    device=None,
    dtype=DEFAULT_DTYPE,
):
    """Posterior predictive draws at x_stars from an MCMC history.

    hists: (tilde_l (S, N), tilde_sigma (S, N), uL_vec (S, T),
    tilde_sigma2_err (S,)).  Returns (n_grid, S, M) like the reference
    `pointwise_predsample` (prediction.py:133-157).  `noise`: SNMGPNoise
    with tilde_l, tilde_sigma (S, G) and y (S, G, M).
    """
    t = _Inputs(device, dtype)
    Y, x, x_stars = t(Y), t(x), t(x_stars).reshape(-1)
    hists = t.hists(hists, n_sample)
    S, G, M = hists[0].shape[0], x_stars.shape[0], Y.shape[1]
    z = t.noise(SNMGPNoise, noise, seed, tilde_l=(S, G), tilde_sigma=(S, G), y=(S, G, M))
    priors = _latent_priors(x, x_stars, (mu_tilde_l, alpha_tilde_l, beta_tilde_l),
                            (mu_tilde_sigma, alpha_tilde_sigma, beta_tilde_sigma))

    def run(d):
        draw = tuple(h[d] for h in hists)
        cache = _snmgp_precompute(draw, Y, x, M)
        tl = _cond_draws(priors, 0, draw[0], z.tilde_l[d])
        ts = _cond_draws(priors, 1, draw[1], z.tilde_sigma[d])
        mu_f, sigma2_y = _snmgp_ystar_moments(cache, x, x_stars, torch.exp(tl), torch.exp(ts))
        return mu_f + torch.sqrt(sigma2_y) * z.y[d]

    return _by_draws(run, S).transpose(0, 1)


def _repeat_map(n_sample, map_draw):
    """A MAP estimate as n_sample equal draws (a view); NumPy arrays and
    Python numbers stay in float64 until the entry point converts them."""
    out = []
    for v in map_draw:
        t = v if torch.is_tensor(v) else torch.as_tensor(v, dtype=torch.float64)
        out.append(t.expand(n_sample, *t.shape))
    return tuple(out)


def snmgp_predmap_sampling(n_sample, map_draw, Y, x, x_stars, seed=0, noise=None, device=None,
                           dtype=DEFAULT_DTYPE, **hyper_kwargs):
    """MAP + conditional-sampling prediction (`point_predmap_sampling`,
    prediction.py:189-262): the MAP estimate repeated n_sample times."""
    return snmgp_predsample(_repeat_map(n_sample, map_draw), Y, x, x_stars, seed=seed,
                            noise=noise, device=device, dtype=dtype, **hyper_kwargs)


def snmgp_predmap(
    map_draw,
    Y,
    x,
    x_stars,
    mu_tilde_l=0.0,
    alpha_tilde_l=1.0,
    beta_tilde_l=1.0,
    mu_tilde_sigma=0.0,
    alpha_tilde_sigma=1.0,
    beta_tilde_sigma=1.0,
    device=None,
    dtype=DEFAULT_DTYPE,
):
    """Analytic plug-in MAP prediction (`point_predmap`/`pointwise_predmap`/
    `test_predmap`, prediction.py:337-459): the latent processes at x* set to
    their conditional means, the predictive y* moments in closed form.
    Returns (3, n_grid, M): [mu - 1.96 sigma, mu, mu + 1.96 sigma]."""
    t = _Inputs(device, dtype)
    Y, x, x_stars = t(Y), t(x), t(x_stars).reshape(-1)
    draw = t.map_draw(map_draw)
    priors = _latent_priors(x, x_stars, (mu_tilde_l, alpha_tilde_l, beta_tilde_l),
                            (mu_tilde_sigma, alpha_tilde_sigma, beta_tilde_sigma))
    cache = _snmgp_precompute(draw, Y, x, Y.shape[1])
    l_star = torch.exp(_cond_means(priors, 0, draw[0]))
    s_star = torch.exp(_cond_means(priors, 1, draw[1]))
    return _percentiles(*(v[0] for v in _snmgp_ystar_moments(cache, x, x_stars, l_star, s_star)))


# ---------------------------------------------------------------------------
# SVC (varying covariance): a dense factor of each draw's covariance
# ---------------------------------------------------------------------------


class _SVCCache(NamedTuple):
    L_f: torch.Tensor  # (S, N, M, M)
    chol_S: torch.Tensor  # (S, MN, MN)
    alpha: torch.Tensor  # S^-1 y, (S, MN)
    sigma2_err: torch.Tensor  # (S,)
    l: torch.Tensor  # (S, N)


def _train_solve(Sigma, y):
    """The factor of each train covariance Sigma (S, n, n) by the Cholesky
    kernel and Sigma^-1 y (S, n), for y (n,)."""
    chol = cholesky(Sigma)
    return chol, _chol_solve(chol, y.expand(Sigma.shape[:-1])[..., None])[..., 0]


def _svc_precompute(draw, Y, x) -> _SVCCache:
    tilde_l, uL_vecs, tilde_s2e = draw
    sigma2_err = torch.exp(tilde_s2e)
    K, L_f = svc_covariance(tilde_l, uL_vecs, x)
    Sigma = K + sigma2_err[:, None, None] * _eye(K.shape[-1], K)
    chol_S, alpha = _train_solve(Sigma, Y.T.reshape(-1))
    return _SVCCache(L_f, chol_S, alpha, sigma2_err, torch.exp(tilde_l))


def _svc_ystar_moments(cache: _SVCCache, x, x_stars, l_star, L_star):
    """Predictive (mu_y, sigma2_y), each (S, G, M), at every x* given the
    latent values l_star (S, G) and L_star (S, G, M, M) there
    (prediction.py:1285-1312 math): the cross-covariance k[(i, n), (g, j)]
    = k_x(x_n, x*_g) <L_f[n, i, :], L_star[g, j, :]>, every (g, j) a
    right-hand side of one triangular solve."""
    S, N, M, _ = cache.L_f.shape
    G = x_stars.shape[0]
    k_x = nonstationary_rbf(x, x_stars, ell1=cache.l, ell2=l_star)  # (S, N, G)
    k_f = torch.einsum("sng,snia,sgja->singj", k_x, cache.L_f, L_star).reshape(S, M * N, G * M)
    mu_f = (cache.alpha[:, None, :] @ k_f)[:, 0].reshape(S, G, M)
    V = torch.linalg.solve_triangular(cache.chol_S, k_f, upper=False)
    # the Gibbs kernel is 1 at (x*, x*): the prior is L* L*^T, its diagonal
    prior_var = torch.sum(L_star * L_star, dim=-1)
    reduction = torch.sum(V * V, dim=-2).reshape(S, G, M)
    sigma2_y = torch.clamp(prior_var - reduction + cache.sigma2_err[:, None, None], min=PRECISION)
    return mu_f, sigma2_y


def _svc_dims(hists_uL, N):
    T = hists_uL.shape[-1] // N
    return T, int(round((math.sqrt(8 * T + 1) - 1) / 2))


def svc_predsample(
    hists,
    Y,
    x,
    x_stars,
    mu_tilde_l=0.0,
    alpha_tilde_l=5.0,
    beta_tilde_l=1.0,
    mu_L=0.0,
    alpha_L=5.0,
    beta_L=1.0,
    n_sample=None,
    seed=0,
    noise: Optional[SVCNoise] = None,
    device=None,
    dtype=DEFAULT_DTYPE,
):
    """SVC posterior predictive over a grid: returns (n_grid, S, M).

    hists: (tilde_l (S, N), uL_vecs (S, N*T), tilde_s2e (S,)), the Cholesky
    entries unconstrained.  `noise`: SVCNoise with tilde_l (S, G), L (S, G,
    T) and y (S, G, M).
    """
    t = _Inputs(device, dtype)
    Y, x, x_stars = t(Y), t(x), t(x_stars).reshape(-1)
    hists = t.hists(hists, n_sample)
    N, M = Y.shape
    S, G, T = hists[0].shape[0], x_stars.shape[0], tri_size(M)
    z = t.noise(SVCNoise, noise, seed, tilde_l=(S, G), L=(S, G, T), y=(S, G, M))
    priors = _latent_priors(x, x_stars, (mu_tilde_l, alpha_tilde_l, beta_tilde_l),
                            (mu_L, alpha_L, beta_L))

    def run(d):
        draw = tuple(h[d] for h in hists)
        cache = _svc_precompute(draw, Y, x)
        tl = _cond_draws(priors, 0, draw[0], z.tilde_l[d])
        u = _cond_draws(priors, 1, draw[1].reshape(-1, N, T), z.L[d])
        L_star = vec_to_tril(uvec_to_lvec(u, M), M)
        mu_f, sigma2_y = _svc_ystar_moments(cache, x, x_stars, torch.exp(tl), L_star)
        return mu_f + torch.sqrt(sigma2_y) * z.y[d]

    return _by_draws(run, S).transpose(0, 1)


def svc_predmap_sampling(n_sample, map_draw, Y, x, x_stars, seed=0, noise=None, device=None,
                         dtype=DEFAULT_DTYPE, **kw):
    """The SVC MAP estimate repeated n_sample times through `svc_predsample`."""
    return svc_predsample(_repeat_map(n_sample, map_draw), Y, x, x_stars, seed=seed, noise=noise,
                          device=device, dtype=dtype, **kw)


def svc_predmap(
    map_draw,
    Y,
    x,
    x_stars,
    mu_tilde_l=0.0,
    alpha_tilde_l=5.0,
    beta_tilde_l=1.0,
    mu_L=0.0,
    alpha_L=5.0,
    beta_L=1.0,
    device=None,
    dtype=DEFAULT_DTYPE,
):
    """Analytic plug-in SVC MAP prediction (`point_predmap_inhomogeneous`,
    prediction.py:912-1036): conditional means of tilde_l* and of every
    unconstrained Cholesky-entry process at x*, closed-form y* moments.
    Returns (3, n_grid, M): [mu - 1.96 sigma, mu, mu + 1.96 sigma]."""
    t = _Inputs(device, dtype)
    Y, x, x_stars = t(Y), t(x), t(x_stars).reshape(-1)
    draw = t.map_draw(map_draw)
    N, M = Y.shape
    priors = _latent_priors(x, x_stars, (mu_tilde_l, alpha_tilde_l, beta_tilde_l),
                            (mu_L, alpha_L, beta_L))
    cache = _svc_precompute(draw, Y, x)
    l_star = torch.exp(_cond_means(priors, 0, draw[0]))
    u = _cond_means(priors, 1, draw[1].reshape(1, N, tri_size(M)))
    L_star = vec_to_tril(uvec_to_lvec(u, M), M)
    return _percentiles(*(v[0] for v in _svc_ystar_moments(cache, x, x_stars, l_star, L_star)))


# ---------------------------------------------------------------------------
# LMC (stationary): the SNMGP machinery with constant latent processes
# ---------------------------------------------------------------------------


def _lmc_draw(draw, N):
    """(tilde_l, tilde_sigma, uL_vec, tilde_s2e) with scalar latents (S,) as
    the SNMGP draw of constant latent processes (S, N)."""
    tl, ts, uL, ts2e = draw
    return tl[:, None].expand(-1, N), ts[:, None].expand(-1, N), uL, ts2e


def lmc_predsample(hists, Y, x, x_stars, n_sample=None, seed=0, noise: Optional[LMCNoise] = None,
                   device=None, dtype=DEFAULT_DTYPE):
    """Stationary LMC predictive (`prediction.py` *_S family): the scalar
    (tilde_l, tilde_sigma) of each draw hold at x* too, so no conditional
    draw is made.  hists: (tilde_l (S,), tilde_sigma (S,), uL_vec (S, T),
    tilde_s2e (S,)).  Returns (n_grid, S, M); `noise`: LMCNoise, y (S, G,
    M)."""
    t = _Inputs(device, dtype)
    Y, x, x_stars = t(Y), t(x), t(x_stars).reshape(-1)
    hists = t.hists(hists, n_sample)
    N, M = Y.shape
    S, G = hists[0].shape[0], x_stars.shape[0]
    z = t.noise(LMCNoise, noise, seed, y=(S, G, M))

    def run(d):
        draw = _lmc_draw(tuple(h[d] for h in hists), N)
        cache = _snmgp_precompute(draw, Y, x, M)
        l_star, s_star = (torch.exp(v[:, :1]).expand(-1, G) for v in draw[:2])
        mu_f, sigma2_y = _snmgp_ystar_moments(cache, x, x_stars, l_star, s_star)
        return mu_f + torch.sqrt(sigma2_y) * z.y[d]

    return _by_draws(run, S).transpose(0, 1)


def lmc_predmap(map_draw, Y, x, x_stars, device=None, dtype=DEFAULT_DTYPE):
    """Analytic plug-in stationary-LMC MAP prediction
    (`pointwise_predmap_S`/`test_predmap_S`, prediction.py:1532-1604).
    map_draw: (tilde_l, tilde_sigma, uL_vec, tilde_sigma2_err).  Returns
    (3, n_grid, M): [mu - 1.96 sigma, mu, mu + 1.96 sigma]."""
    t = _Inputs(device, dtype)
    Y, x, x_stars = t(Y), t(x), t(x_stars).reshape(-1)
    N, M = Y.shape
    draw = _lmc_draw(t.map_draw(map_draw), N)
    cache = _snmgp_precompute(draw, Y, x, M)
    l_star, s_star = (torch.exp(v[:, :1]).expand(-1, x_stars.shape[0]) for v in draw[:2])
    return _percentiles(*(v[0] for v in _snmgp_ystar_moments(cache, x, x_stars, l_star, s_star)))


# ---------------------------------------------------------------------------
# Latent-process prediction (the reference's `pred_smoothness` / `pred_cov`
# modes of point_predmap_inhomogeneous_sampling, prediction.py:1038-1160)
# ---------------------------------------------------------------------------


def snmgp_latent_predsample(
    hists,
    x,
    x_stars,
    mu_tilde_l=0.0,
    alpha_tilde_l=1.0,
    beta_tilde_l=1.0,
    mu_tilde_sigma=0.0,
    alpha_tilde_sigma=1.0,
    beta_tilde_sigma=1.0,
    n_sample=None,
    seed=0,
    noise: Optional[SNMGPNoise] = None,
    device=None,
    dtype=DEFAULT_DTYPE,
):
    """Conditional draws of the SNMGP latent processes at x_stars.

    hists: (tilde_l (S, N), tilde_sigma (S, N), ...): further entries are
    ignored.  Returns (tilde_l_stars, tilde_sigma_stars), each (S, n_grid).
    `noise`: SNMGPNoise with tilde_l and tilde_sigma (S, G), y None.
    """
    t = _Inputs(device, dtype)
    x, x_stars = t(x), t(x_stars).reshape(-1)
    tl_h, ts_h = t.hists(hists[:2], n_sample)
    S, G = tl_h.shape[0], x_stars.shape[0]
    z = t.noise(SNMGPNoise, noise, seed, tilde_l=(S, G), tilde_sigma=(S, G))
    priors = _latent_priors(x, x_stars, (mu_tilde_l, alpha_tilde_l, beta_tilde_l),
                            (mu_tilde_sigma, alpha_tilde_sigma, beta_tilde_sigma))
    return _cond_draws(priors, 0, tl_h, z.tilde_l), _cond_draws(priors, 1, ts_h, z.tilde_sigma)


def svc_latent_predsample(
    hists,
    x,
    x_stars,
    mu_tilde_l=0.0,
    alpha_tilde_l=5.0,
    beta_tilde_l=1.0,
    mu_L=0.0,
    alpha_L=5.0,
    beta_L=1.0,
    n_sample=None,
    seed=0,
    noise: Optional[SVCNoise] = None,
    device=None,
    dtype=DEFAULT_DTYPE,
):
    """Conditional draws of the SVC latent processes at x_stars
    (`pred_smoothness`/`pred_cov`, prediction.py:1057-1104).

    hists: (tilde_l (S, N), uL_vecs (S, N*T), ...).  Returns (tilde_l_stars
    (S, n_grid), L_f_stars (S, n_grid, M, M)) with the exp-diagonal
    transform applied (covariance process B* = L* L*^T).  `noise`: SVCNoise
    with tilde_l (S, G) and L (S, G, T), y None.
    """
    t = _Inputs(device, dtype)
    x, x_stars = t(x), t(x_stars).reshape(-1)
    tl_h, uL_h = t.hists(hists[:2], n_sample)
    N = x.shape[0]
    T, M = _svc_dims(uL_h, N)
    S, G = tl_h.shape[0], x_stars.shape[0]
    z = t.noise(SVCNoise, noise, seed, tilde_l=(S, G), L=(S, G, T))
    priors = _latent_priors(x, x_stars, (mu_tilde_l, alpha_tilde_l, beta_tilde_l),
                            (mu_L, alpha_L, beta_L))
    u = _cond_draws(priors, 1, uL_h.reshape(S, N, T), z.L)
    return _cond_draws(priors, 0, tl_h, z.tilde_l), vec_to_tril(uvec_to_lvec(u, M), M)


# ---------------------------------------------------------------------------
# Hadamard (heterotopic) variants: flat (x, indx, y) training data, a dense
# N x N train covariance K_x o K_i of each draw
# ---------------------------------------------------------------------------


def _hadamard_moments(chol_S, alpha, cross, prior_var, sigma2_err):
    """Predictive (mu_y, sigma2_y), each (S, G, M), from the train factor
    chol_S (S, N, N), alpha = Sigma^-1 y (S, N), the cross-covariances
    (S, N, G, M) and the prior variances (S, G, M) at x* (the JAX package's
    `_hadamard_predict_factory`, prediction.py:702-716)."""
    S, N, G, M = cross.shape
    k = cross.reshape(S, N, G * M)
    mu_f = (alpha[:, None, :] @ k)[:, 0].reshape(S, G, M)
    V = torch.linalg.solve_triangular(chol_S, k, upper=False)
    reduction = torch.sum(V * V, dim=-2).reshape(S, G, M)
    sigma2_y = torch.clamp(prior_var - reduction + sigma2_err[:, None, None], min=PRECISION)
    return mu_f, sigma2_y


def _hadamard_inputs(t, x, indx, y, x_stars):
    return t(x), t.index(indx), t(y), t(x_stars).reshape(-1)


def _snmgp_hadamard(draw, x, indx, y, M, x_stars, l_star_fn, s_star_fn):
    """(mu_y, sigma2_y) of the heterotopic SNMGP: draw = (tilde_l (S, N),
    tilde_sigma (S, N), L_vec (S, T) raw, as the reference's hadamard
    log-posterior takes it (logpos.py:517), tilde_s2e (S,)); the latent
    values at x* are l_star_fn(tilde_l), s_star_fn(tilde_sigma) (S, G)."""
    tilde_l, tilde_sigma, L_vec, ts2e = draw
    L = vec_to_tril(L_vec, M)
    B_f = L @ L.mT
    l, sig, s2e = torch.exp(tilde_l), torch.exp(tilde_sigma), torch.exp(ts2e)
    K_x = nonstationary_rbf(x, sigma1=sig, ell1=l) + MCMC_JITTER * _eye(x.shape[0], x)
    chol_S, alpha = _train_solve(K_x * B_f[:, indx[:, None], indx[None, :]]
                                 + s2e[:, None, None] * _eye(x.shape[0], x), y)
    l_star, s_star = l_star_fn(tilde_l), s_star_fn(tilde_sigma)
    k_x = nonstationary_rbf(x, x_stars, sigma1=sig, ell1=l, sigma2=s_star, ell2=l_star)
    cross = k_x[..., None] * B_f[:, indx, None, :]
    prior_var = torch.diagonal(B_f, dim1=-2, dim2=-1)[:, None, :] * (s_star * s_star)[..., None]
    return _hadamard_moments(chol_S, alpha, cross, prior_var, s2e)


def snmgp_hadamard_predsample(
    hists,
    x,
    indx,
    y,
    num_tasks,
    x_stars,
    mu_tilde_l=0.0,
    alpha_tilde_l=1.0,
    beta_tilde_l=1.0,
    mu_tilde_sigma=0.0,
    alpha_tilde_sigma=1.0,
    beta_tilde_sigma=1.0,
    n_sample=None,
    seed=0,
    noise: Optional[SNMGPNoise] = None,
    device=None,
    dtype=DEFAULT_DTYPE,
):
    """Heterotopic SNMGP predictive (prediction.py hadamard family): K =
    K_x o B_f[indx, indx'] on the observed points; returns (n_grid, S, M).
    `noise`: SNMGPNoise with tilde_l, tilde_sigma (S, G) and y (S, G, M)."""
    t = _Inputs(device, dtype)
    x, indx, y, x_stars = _hadamard_inputs(t, x, indx, y, x_stars)
    hists = t.hists(hists, n_sample)
    S, G, M = hists[0].shape[0], x_stars.shape[0], num_tasks
    z = t.noise(SNMGPNoise, noise, seed, tilde_l=(S, G), tilde_sigma=(S, G), y=(S, G, M))
    priors = _latent_priors(x, x_stars, (mu_tilde_l, alpha_tilde_l, beta_tilde_l),
                            (mu_tilde_sigma, alpha_tilde_sigma, beta_tilde_sigma))

    def run(d):
        mu_f, sigma2_y = _snmgp_hadamard(
            tuple(h[d] for h in hists), x, indx, y, M, x_stars,
            lambda v: torch.exp(_cond_draws(priors, 0, v, z.tilde_l[d])),
            lambda v: torch.exp(_cond_draws(priors, 1, v, z.tilde_sigma[d])))
        return mu_f + torch.sqrt(sigma2_y) * z.y[d]

    return _by_draws(run, S).transpose(0, 1)


def _lmc_hadamard(draw, x, indx, y, M, x_stars):
    """(mu_y, sigma2_y) of the heterotopic stationary LMC: draw = (tilde_l
    (S,), tilde_sigma (S,), L_vec (S, T) raw, tilde_s2e (S,)); the RBF grams
    of every draw's (scale, lengthscale) in one launch each."""
    tl, ts, L_vec, ts2e = draw
    L = vec_to_tril(L_vec, M)
    B_f = L @ L.mT
    l, sig, s2e = torch.exp(tl), torch.exp(ts), torch.exp(ts2e)
    N = x.shape[0]
    K_x = rbf(x, x, sig**2, l) + MCMC_JITTER * _eye(N, x)
    chol_S, alpha = _train_solve(K_x * B_f[:, indx[:, None], indx[None, :]]
                                 + s2e[:, None, None] * _eye(N, x), y)
    cross = rbf(x, x_stars, sig**2, l)[..., None] * B_f[:, indx, None, :]
    prior_var = torch.diagonal(B_f, dim1=-2, dim2=-1)[:, None, :] * (sig**2)[:, None, None]
    return _hadamard_moments(chol_S, alpha, cross, prior_var, s2e)


def lmc_hadamard_predsample(hists, x, indx, y, num_tasks, x_stars, n_sample=None, seed=0,
                            noise: Optional[LMCNoise] = None, device=None, dtype=DEFAULT_DTYPE):
    """Heterotopic stationary LMC predictive (prediction.py *_S hadamard):
    returns (n_grid, S, M); `noise`: LMCNoise, y (S, G, M)."""
    t = _Inputs(device, dtype)
    x, indx, y, x_stars = _hadamard_inputs(t, x, indx, y, x_stars)
    hists = t.hists(hists, n_sample)
    S, G, M = hists[0].shape[0], x_stars.shape[0], num_tasks
    z = t.noise(LMCNoise, noise, seed, y=(S, G, M))

    def run(d):
        mu_f, sigma2_y = _lmc_hadamard(tuple(h[d] for h in hists), x, indx, y, M, x_stars)
        return mu_f + torch.sqrt(sigma2_y) * z.y[d]

    return _by_draws(run, S).transpose(0, 1)


def _svc_hadamard(draw, x, indx, y, M, x_stars, l_star_fn, u_star_fn):
    """(mu_y, sigma2_y) of the heterotopic SVC: draw = (tilde_l (S, N),
    L_vecs (S, N*T) raw per-point Cholesky vectors, as the reference's
    `logpos_hadamard_SVC` takes them, tilde_s2e (S,)); the latent values at
    x* are l_star_fn(tilde_l) (S, G) and the raw u_star_fn(U) (S, G, T)."""
    tilde_l, L_vecs, ts2e = draw
    N, T = x.shape[0], tri_size(M)
    U = L_vecs.reshape(-1, N, T)
    rows = vec_to_tril(U, M)[:, torch.arange(N, device=x.device), indx, :]  # (S, N, M)
    l, s2e = torch.exp(tilde_l), torch.exp(ts2e)
    K_x = nonstationary_rbf(x, ell1=l) + MCMC_JITTER * _eye(N, x)
    chol_S, alpha = _train_solve(K_x * (rows @ rows.mT) + s2e[:, None, None] * _eye(N, x), y)
    l_star = l_star_fn(tilde_l)
    L_star = vec_to_tril(u_star_fn(U), M)  # raw
    k_x = nonstationary_rbf(x, x_stars, ell1=l, ell2=l_star)
    cross = k_x[..., None] * torch.einsum("sna,sgja->sngj", rows, L_star)
    # the Gibbs kernel is 1 at (x*, x*)
    prior_var = torch.sum(L_star * L_star, dim=-1)
    return _hadamard_moments(chol_S, alpha, cross, prior_var, s2e)


def svc_hadamard_predsample(
    hists,
    x,
    indx,
    y,
    num_tasks,
    x_stars,
    mu_tilde_l=0.0,
    alpha_tilde_l=1.0,
    beta_tilde_l=1.0,
    mu_L=0.0,
    alpha_L=1.0,
    beta_L=1.0,
    n_sample=None,
    seed=0,
    noise: Optional[SVCNoise] = None,
    device=None,
    dtype=DEFAULT_DTYPE,
):
    """Heterotopic SVC predictive (`*_inhomogeneous` family,
    prediction.py:1231-1325), raw per-point Cholesky vectors (no exp on the
    diagonal), as logpos_hadamard_SVC takes them.  Returns (n_grid, S, M);
    `noise`: SVCNoise with tilde_l (S, G), L (S, G, T) and y (S, G, M)."""
    t = _Inputs(device, dtype)
    x, indx, y, x_stars = _hadamard_inputs(t, x, indx, y, x_stars)
    hists = t.hists(hists, n_sample)
    S, G, M = hists[0].shape[0], x_stars.shape[0], num_tasks
    z = t.noise(SVCNoise, noise, seed, tilde_l=(S, G), L=(S, G, tri_size(M)), y=(S, G, M))
    priors = _latent_priors(x, x_stars, (mu_tilde_l, alpha_tilde_l, beta_tilde_l),
                            (mu_L, alpha_L, beta_L))

    def run(d):
        mu_f, sigma2_y = _svc_hadamard(
            tuple(h[d] for h in hists), x, indx, y, M, x_stars,
            lambda v: torch.exp(_cond_draws(priors, 0, v, z.tilde_l[d])),
            lambda U: _cond_draws(priors, 1, U, z.L[d]))
        return mu_f + torch.sqrt(sigma2_y) * z.y[d]

    return _by_draws(run, S).transpose(0, 1)


# ---------------------------------------------------------------------------
# Hadamard plug-in MAP prediction (analytic, conditional-mean latents):
# point_predmap_hadamard (prediction.py:710-786), point_predmap_S_hadamard
# (:1661-1744), point_predmap_SVC_hadamard (:1367-1530).  Column m of the
# all-task output is the reference's `indexedpoint_*` result for task m.
# ---------------------------------------------------------------------------


def snmgp_hadamard_predmap(
    map_draw,
    x,
    indx,
    y,
    num_tasks,
    x_stars,
    mu_tilde_l=0.0,
    alpha_tilde_l=1.0,
    beta_tilde_l=1.0,
    mu_tilde_sigma=0.0,
    alpha_tilde_sigma=1.0,
    beta_tilde_sigma=1.0,
    device=None,
    dtype=DEFAULT_DTYPE,
):
    """Heterotopic SNMGP plug-in MAP prediction (`point_predmap_hadamard`,
    prediction.py:710-786).  Returns (3, n_grid, M)."""
    t = _Inputs(device, dtype)
    x, indx, y, x_stars = _hadamard_inputs(t, x, indx, y, x_stars)
    priors = _latent_priors(x, x_stars, (mu_tilde_l, alpha_tilde_l, beta_tilde_l),
                            (mu_tilde_sigma, alpha_tilde_sigma, beta_tilde_sigma))
    moments = _snmgp_hadamard(t.map_draw(map_draw), x, indx, y, num_tasks, x_stars,
                              lambda v: torch.exp(_cond_means(priors, 0, v)),
                              lambda v: torch.exp(_cond_means(priors, 1, v)))
    return _percentiles(*(v[0] for v in moments))


def lmc_hadamard_predmap(map_draw, x, indx, y, num_tasks, x_stars, device=None,
                         dtype=DEFAULT_DTYPE):
    """Heterotopic stationary-LMC plug-in MAP prediction
    (`point_predmap_S_hadamard`, prediction.py:1661-1744).
    Returns (3, n_grid, M)."""
    t = _Inputs(device, dtype)
    x, indx, y, x_stars = _hadamard_inputs(t, x, indx, y, x_stars)
    moments = _lmc_hadamard(t.map_draw(map_draw), x, indx, y, num_tasks, x_stars)
    return _percentiles(*(v[0] for v in moments))


def svc_hadamard_predmap(
    map_draw,
    x,
    indx,
    y,
    num_tasks,
    x_stars,
    mu_tilde_l=0.0,
    alpha_tilde_l=1.0,
    beta_tilde_l=1.0,
    mu_L=0.0,
    alpha_L=1.0,
    beta_L=1.0,
    device=None,
    dtype=DEFAULT_DTYPE,
):
    """Heterotopic SVC plug-in MAP prediction (`point_predmap_SVC_hadamard`,
    prediction.py:1367-1530), raw per-point Cholesky vectors.  Returns (3,
    n_grid, M)."""
    t = _Inputs(device, dtype)
    x, indx, y, x_stars = _hadamard_inputs(t, x, indx, y, x_stars)
    priors = _latent_priors(x, x_stars, (mu_tilde_l, alpha_tilde_l, beta_tilde_l),
                            (mu_L, alpha_L, beta_L))
    moments = _svc_hadamard(t.map_draw(map_draw), x, indx, y, num_tasks, x_stars,
                            lambda v: torch.exp(_cond_means(priors, 0, v)),
                            lambda U: _cond_means(priors, 1, U))
    return _percentiles(*(v[0] for v in moments))


# ---------------------------------------------------------------------------
# Indexed-point variants: a single task per test location.  The per-task
# predictive moments are marginal, so task column m of the all-task
# prediction is the reference's `indexedpoint_*` result for indx_star = m
# (`indexedpoint_predsample_hadamard` prediction.py:585,
# `indexedpoint_predmap_hadamard` :810, `indexedpoint_predmap_SVC_hadamard`
# :1446, `indexedpoint_predmap_S_hadamard` :1708).
# ---------------------------------------------------------------------------


def _gather_task_sample(out, indx_stars):
    # out: (n_grid, S, M) -> (n_grid, S)
    idx = torch.as_tensor(indx_stars, device=out.device).reshape(-1).long()
    return out[torch.arange(out.shape[0], device=out.device), :, idx]


def _gather_task_map(out, indx_stars):
    # out: (3, n_grid, M) -> (3, n_grid)
    idx = torch.as_tensor(indx_stars, device=out.device).reshape(-1).long()
    return out[:, torch.arange(out.shape[1], device=out.device), idx]


def snmgp_hadamard_indexedpoint_predsample(
    hists, x, indx, y, num_tasks, x_stars, indx_stars, **kw
):
    """Per-(x*, task*) SNMGP hadamard draws (`indexedpoint_predsample_hadamard`,
    prediction.py:585-677).  Returns (n_grid, S)."""
    out = snmgp_hadamard_predsample(hists, x, indx, y, num_tasks, x_stars, **kw)
    return _gather_task_sample(out, indx_stars)


def snmgp_hadamard_indexedpoint_predmap(
    map_draw, x, indx, y, num_tasks, x_stars, indx_stars, **kw
):
    """Per-(x*, task*) SNMGP hadamard plug-in MAP percentiles
    (`indexedpoint_predmap_hadamard`, prediction.py:810-886).
    Returns (3, n_grid)."""
    out = snmgp_hadamard_predmap(map_draw, x, indx, y, num_tasks, x_stars, **kw)
    return _gather_task_map(out, indx_stars)


def svc_hadamard_indexedpoint_predmap(
    map_draw, x, indx, y, num_tasks, x_stars, indx_stars, **kw
):
    """Per-(x*, task*) SVC hadamard plug-in MAP percentiles
    (`indexedpoint_predmap_SVC_hadamard`, prediction.py:1446-1514).
    Returns (3, n_grid)."""
    out = svc_hadamard_predmap(map_draw, x, indx, y, num_tasks, x_stars, **kw)
    return _gather_task_map(out, indx_stars)


def lmc_hadamard_indexedpoint_predmap(
    map_draw, x, indx, y, num_tasks, x_stars, indx_stars, device=None, dtype=DEFAULT_DTYPE
):
    """Per-(x*, task*) stationary-LMC hadamard plug-in MAP percentiles
    (`indexedpoint_predmap_S_hadamard`, prediction.py:1708-1745).
    Returns (3, n_grid)."""
    out = lmc_hadamard_predmap(map_draw, x, indx, y, num_tasks, x_stars, device=device,
                               dtype=dtype)
    return _gather_task_map(out, indx_stars)


def svc_hadamard_indexedpoint_predsample(
    hists, x, indx, y, num_tasks, x_stars, indx_stars, **kw
):
    """Per-(x*, task*) SVC hadamard posterior draws: the reference ships
    only the predmap form of this variant (prediction.py:1446-1514); the
    column gather completes the {SNMGP, SVC, LMC} x {predsample, predmap}
    grid, as the JAX package does.  Returns (n_grid, S)."""
    out = svc_hadamard_predsample(hists, x, indx, y, num_tasks, x_stars, **kw)
    return _gather_task_sample(out, indx_stars)


def lmc_hadamard_indexedpoint_predsample(
    hists, x, indx, y, num_tasks, x_stars, indx_stars, **kw
):
    """Per-(x*, task*) stationary-LMC hadamard posterior draws (no
    reference counterpart; see `svc_hadamard_indexedpoint_predsample`).
    Returns (n_grid, S)."""
    out = lmc_hadamard_predsample(hists, x, indx, y, num_tasks, x_stars, **kw)
    return _gather_task_sample(out, indx_stars)
