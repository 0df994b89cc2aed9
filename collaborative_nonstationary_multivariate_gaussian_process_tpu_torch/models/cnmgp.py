"""CNMGP in PyTorch: the stochastic ELBO and posterior prediction.

The JAX package's `models/cnmgp.py`: the parameter tuple and its packing,
the conditioning of every latent process at a batch of inputs, the negative
stochastic ELBO that DSVI minimizes (reconstruction and the whitened KLs),
its Monte-Carlo estimate, and one posterior-predictive draw per leading row
of noise.  Where the JAX package vmaps one draw over keys, the functions
here carry a leading draw dimension S and take their standard-normal noise
as explicit tensors (`CNMGPNoise`), so a test can feed both packages the
same numbers.

Spans (`utils.profiling.span`, recorded while a profiler records):
`cnmgp.noise` (`draw_noise`), `cnmgp.sample_y`, `cnmgp.sample_fy`,
`cnmgp.predict_mean`, and the stages of a draw and of the mean, each named
after the step it covers: in a draw `cnmgp.prior_grams` (the stationary
grams, the inducing draw), `cnmgp.gibbs_prior` (the Gibbs gram of Z),
`cnmgp.prior_chol_inv` (the prior stack's Cholesky-inverse),
`cnmgp.cross_solve` (the cross grams' whitened solves),
`cnmgp.lengthscale`, `cnmgp.coef_diag` and `cnmgp.coef_off` (the
coefficient groups' moments, the variance quadform), `cnmgp.gibbs_cross`
(the cross Gibbs gram and its solve), `cnmgp.g_moments` and
`cnmgp.combine`; in the mean `cnmgp.mean_lengthscale`,
`cnmgp.mean_projections`, `cnmgp.mean_coef`, `cnmgp.mean_gibbs`,
`cnmgp.mean_g` and `cnmgp.combine`.  Each holds at most a few hundred
host operations of its own, so that a profiler's idle gap inside one is
named after it.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Mapping, NamedTuple, Optional, Union

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, DSVI_JITTER, resolve_device
from ..ops.kernels import gibbs, rbf, sq_dist
from ..ops.linalg import (
    WhitenedFactors,
    _tril_idx,
    chol_tri_inv,
    chol_tri_inv_robust,
    conditional_projection,
    kl_gaussian_ref_compat,
    kl_gaussian_white,
    kl_gaussian_white_parts,
    mgp_mean,
    mgp_moments_white,
    regularized_diag,
    sample_diag,
    sample_full_cov,
    tri_solve_white,
    tril_mask,
    tril_regularized,
    whiten,
    whitened_factors,
)
from ..utils import profiling

__all__ = [
    "CNMGPParams",
    "CNMGPNoise",
    "init_params",
    "params_from_numpy",
    "params_to_numpy",
    "params_to",
    "packed_U_indices",
    "pack_U",
    "unpack_U",
    "draw_noise",
    "draw_train_noise",
    "negative_selbo",
    "elbo_estimate",
    "sample_y_once",
    "sample_fy_once",
    "predict_y_mean",
]


class CNMGPParams(NamedTuple):
    """Variational parameters + log hyperparameters, the fields and order of
    the JAX package's `CNMGPParams`.  mu_U / sqrt_U are PACKED offdiag-first
    (see `packed_U_indices`)."""

    mu_v: torch.Tensor  # (M,)
    sqrt_v: torch.Tensor  # (M, M), lower triangle used
    mu_W: torch.Tensor  # (D, M)
    sqrt_W: torch.Tensor  # (D, M, M)
    mu_U: torch.Tensor  # (D(D+1)/2, M), offdiag entries first, then diag
    sqrt_U: torch.Tensor  # (D(D+1)/2, M, M), same packing
    sigma2_tildeell_log: torch.Tensor  # ()
    length_scales_tildeell_log: torch.Tensor  # ()
    sigma2_L0_log: torch.Tensor  # ()
    length_scales_L0_log: torch.Tensor  # ()
    sigma2_L1_log: torch.Tensor  # ()
    length_scales_L1_log: torch.Tensor  # ()
    sigma2_err_log: torch.Tensor  # ()

    @property
    def num_inducing(self) -> int:
        return self.mu_v.shape[-1]

    @property
    def num_outputs(self) -> int:
        return self.mu_W.shape[-2]


def init_params(
    generator: torch.Generator,
    dim_outputs: int,
    num_inducing: int,
    dtype=DEFAULT_DTYPE,
    device=None,
    mu_v=None,
    mu_W=None,
    mu_U=None,
    sqrt_v=None,
    sqrt_W=None,
    sqrt_U=None,
    sqrt_scale: float = 0.1,
) -> CNMGPParams:
    """Random initialization with the reference's defaults (nmgp_dsvi.py:
    115-155): 0.1-scaled Gaussian means, `sqrt_scale`-scaled factors, mu_v =
    -4, hyper logs (0, -4, 0, -4, 0, -4, -2).  Each of mu_v, mu_W, mu_U,
    sqrt_v, sqrt_W, sqrt_U may be given instead (an array or tensor); mu_U
    and sqrt_U in the packed (G, ...) layout or as a dense (D, D, ...) table,
    which is packed.  Draws on the generator's device, always all five
    arrays in the same order; the same seed gives other numbers than the
    JAX `init_params`."""
    device = resolve_device(device)
    D, M = dim_outputs, num_inducing
    G = D * (D + 1) // 2

    def normal(*shape):
        z = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
        return z.to(device)

    def given(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def given_U(a, packed_ndim):
        a = given(a)
        return pack_U(a) if a.ndim == packed_ndim + 1 else a

    draws = dict(
        mu_W=0.1 * normal(D, M),
        sqrt_W=sqrt_scale * normal(D, M, M),
        sqrt_v=sqrt_scale * normal(M, M),
        mu_U=0.1 * normal(G, M),
        sqrt_U=sqrt_scale * normal(G, M, M),
    )
    z = partial(torch.tensor, dtype=dtype, device=device)
    return CNMGPParams(
        mu_v=given(mu_v) if mu_v is not None else torch.full((M,), -4.0, dtype=dtype, device=device),
        sqrt_v=given(sqrt_v) if sqrt_v is not None else draws["sqrt_v"],
        mu_W=given(mu_W) if mu_W is not None else draws["mu_W"],
        sqrt_W=given(sqrt_W) if sqrt_W is not None else draws["sqrt_W"],
        mu_U=given_U(mu_U, 2) if mu_U is not None else draws["mu_U"],
        sqrt_U=given_U(sqrt_U, 3) if sqrt_U is not None else draws["sqrt_U"],
        sigma2_tildeell_log=z(0.0),
        length_scales_tildeell_log=z(-4.0),
        sigma2_L0_log=z(0.0),
        length_scales_L0_log=z(-4.0),
        sigma2_L1_log=z(0.0),
        length_scales_L1_log=z(-4.0),
        sigma2_err_log=z(-2.0),
    )


def params_from_numpy(
    p: Union[CNMGPParams, Mapping[str, np.ndarray]], device=None, dtype=DEFAULT_DTYPE
) -> CNMGPParams:
    """Parameters given as numpy arrays (a `CNMGPParams` of arrays, e.g. the
    JAX package's params after `np.asarray`, or a dict keyed by field name)
    -> a `CNMGPParams` of tensors on `device`."""
    fields = p._asdict() if isinstance(p, tuple) else p
    device = resolve_device(device)
    return CNMGPParams(
        **{
            name: torch.as_tensor(np.array(fields[name]), dtype=dtype, device=device)
            for name in CNMGPParams._fields
        }
    )


def params_to_numpy(params: CNMGPParams) -> dict:
    """{field name: numpy array}, the inverse of `params_from_numpy`."""
    return {name: t.detach().cpu().numpy() for name, t in params._asdict().items()}


def params_to(params: CNMGPParams, device, dtype=None) -> CNMGPParams:
    """The same parameters on another device and/or dtype."""
    return CNMGPParams(*(t.to(device=device, dtype=dtype or t.dtype) for t in params))


def packed_U_indices(D: int):
    """(row, col) of each packed coefficient entry, as numpy arrays: the
    D(D-1)/2 strict-lower entries in `np.tril_indices(D, -1)` order, then the
    D diagonal entries, so the offdiag and diag groups are slices."""
    ii, jj = np.tril_indices(D, k=-1)
    rows = np.concatenate([ii, np.arange(D)])
    cols = np.concatenate([jj, np.arange(D)])
    return rows, cols


def pack_U(dense: torch.Tensor) -> torch.Tensor:
    """Dense (D, D, ...) coefficient table -> packed (D(D+1)/2, ...)."""
    rows, cols = packed_U_indices(dense.shape[0])
    return dense[torch.as_tensor(rows), torch.as_tensor(cols)]


def unpack_U(packed: torch.Tensor, D: int, fill=0.0) -> torch.Tensor:
    """Packed (D(D+1)/2, ...) -> dense (D, D, ...) lower-triangular table
    (upper triangle = `fill`); inverse of `pack_U`."""
    rows, cols = packed_U_indices(D)
    out = torch.full(
        (D, D) + tuple(packed.shape[1:]), fill, dtype=packed.dtype, device=packed.device
    )
    out[torch.as_tensor(rows), torch.as_tensor(cols)] = packed
    return out


class CNMGPNoise(NamedTuple):
    """The standard-normal tensors S predictive draws consume, leading dim S.

    In the JAX package one draw's key splits into (k_lat, k_g, k_y) and
    k_lat into (k_v, k_te, k_diag, k_off) (cnmgp.py:549, :254); k_v splits
    into the two halves of `sample_full_cov` (linalg.py:167).  A training
    step (`negative_selbo`) uses only the first five; z_g and z_y are None
    there (`draw_train_noise`).
    """

    z_v1: torch.Tensor  # (S, M)      inducing log-lengthscale draw, L z1
    z_v2: Optional[torch.Tensor]  # (S, M) its jitter term; unused at jitter 0
    z_te: torch.Tensor  # (S, B)      log-lengthscale process at x
    z_diag: torch.Tensor  # (S, D, B) log of the diagonal coefficients
    z_off: torch.Tensor  # (S, T0, B) offdiag coefficients, T0 = D(D-1)/2
    z_g: Optional[torch.Tensor]  # (S, D, B) latent functions g
    z_y: Optional[torch.Tensor]  # (S, B) for sample_y_once, (S, B, D) for sample_fy_once


def draw_train_noise(
    generator: torch.Generator,
    n_draws: int,
    num_inducing: int,
    n_points: int,
    dim_outputs: int,
    dtype=DEFAULT_DTYPE,
) -> CNMGPNoise:
    """The standard-normal noise of `n_draws` ELBO draws at `n_points`
    inputs (z_v1, z_v2, z_te, z_diag, z_off; z_g and z_y None), on the
    generator's device.  A training step takes n_draws = 1."""
    S, M, B, D = n_draws, num_inducing, n_points, dim_outputs

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)

    return CNMGPNoise(
        z_v1=normal(S, M),
        z_v2=normal(S, M),
        z_te=normal(S, B),
        z_diag=normal(S, D, B),
        z_off=normal(S, D * (D - 1) // 2, B),
        z_g=None,
        z_y=None,
    )


def draw_noise(
    generator: torch.Generator,
    n_draws: int,
    num_inducing: int,
    n_points: int,
    dim_outputs: int,
    all_outputs: bool = False,
    dtype=DEFAULT_DTYPE,
) -> CNMGPNoise:
    """Fresh standard-normal noise for `n_draws` predictive draws at
    `n_points` inputs, on the generator's device: `draw_train_noise`'s
    fields, then z_g and z_y.  `all_outputs` shapes z_y (S, B, D), as
    `sample_fy_once` needs, instead of (S, B)."""
    S, B, D = n_draws, n_points, dim_outputs
    with profiling.span("cnmgp.noise"):
        noise = draw_train_noise(generator, S, num_inducing, B, D, dtype)

        def normal(*shape):
            return torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)

        return noise._replace(z_g=normal(S, D, B),
                              z_y=normal(S, B, D) if all_outputs else normal(S, B))


class _Latents(NamedTuple):
    """The conditioned latents of S draws, the fields of the JAX `_Latents`
    with a leading S.  Prior order everywhere: [tildeell, L0, L1, G]."""

    L_full: torch.Tensor  # (S, B, D, D) sampled coefficient matrices
    mu_g: torch.Tensor  # (S, D, B)
    sigma2_g: torch.Tensor  # (S, D, B)
    tilde_ell: torch.Tensor  # (S, B)
    sampled_v: torch.Tensor  # (S, M)
    Lp_all: torch.Tensor  # (S, 4, M, M) chol of (K22 + jI)
    Lp_inv: torch.Tensor  # (S, 4, M, M) their triangular inverses
    Wh_v: torch.Tensor  # (S, M, M)      Lp_te^-1 tril(sqrt_v)
    Wh_U: WhitenedFactors  # sets (offdiag (S, T0, M, M), diag (S, D, M, M)): Lp_L0^-1, Lp_L1^-1
    Wh_W: WhitenedFactors  # one set (S, D, M, M): Lp_G^-1 tril(sqrt_W)


def _sample_latents(
    params: CNMGPParams, Z, x, noise: CNMGPNoise, jitter=DSVI_JITTER, sigma2_g=1.0,
    robust=False, kl_mode="true",
) -> _Latents:
    """S reparameterized draws of all latent processes at the inputs x (B,).

    The JAX `_sample_latents` (cnmgp.py:218-383) forward, batched over the
    leading dimension of `noise`:
      1. joint draw of (v, tilde_ell(x)) by the sparse-GP conditional;
      2. draw of every coefficient L_ij(x), batched over the offdiag (K_L0)
         and diag (K_L1, log-GP) groups;
      3. analytic marginal mean/variance of the shared latents g_d.
    The (S, 4, M, M) prior stack [tildeell, L0, L1, Gibbs] is factored in
    one batch by the fused Cholesky-inverse kernel, the whitened coefficient
    factors of sqrt_U's two group sets in one call and sqrt_W's in another
    (`whitened_factors`, with their KL pieces).  kl_mode "true" uses the
    regularized factors; "ref_compat" the raw tril factors with the
    reference's full-cov sampling jitter.
    """
    D = params.num_outputs
    dtype = x.dtype
    B = x.shape[0]
    M = Z.shape[0]
    S = noise.z_v1.shape[0]

    with profiling.span("cnmgp.prior_grams"):
        s2_te = torch.exp(params.sigma2_tildeell_log)
        ls_te = torch.exp(params.length_scales_tildeell_log)
        s2_L0 = torch.exp(params.sigma2_L0_log)
        ls_L0 = torch.exp(params.length_scales_L0_log)
        s2_L1 = torch.exp(params.sigma2_L1_log)
        ls_L1 = torch.exp(params.length_scales_L1_log)

        # one pairwise-distance computation feeds the three stationary kernels
        d2_xz = sq_dist(x, Z)  # (B, M)
        d2_zz = sq_dist(Z, Z)  # (M, M)

        def _rbf_pair(s2, ls):
            inv = 0.5 / (ls * ls)
            return s2 * torch.exp(-d2_xz * inv), s2 * torch.exp(-d2_zz * inv)

        K_te_12, K_te_22 = _rbf_pair(s2_te, ls_te)
        K_L0_12, K_L0_22 = _rbf_pair(s2_L0, ls_L0)
        K_L1_12, K_L1_22 = _rbf_pair(s2_L1, ls_L1)
        if kl_mode == "ref_compat":
            Lt_v = tril_mask(params.sqrt_v)
            sampled_v = sample_full_cov(params.mu_v, Lt_v, noise.z_v1, noise.z_v2, jitter)
        else:
            Lt_v = tril_regularized(params.sqrt_v, jitter)
            sampled_v = sample_full_cov(params.mu_v, Lt_v, noise.z_v1, None, 0.0)
        # f32 overflow guard on the log-lengthscales, as in the JAX package
        sampled_v = torch.clamp(sampled_v, -30.0, 30.0)  # (S, M)
        ell_Z = torch.exp(sampled_v)
    with profiling.span("cnmgp.gibbs_prior"):
        K_G_22 = gibbs(Z, Z, ell_Z, ell_Z, sigma2_g).to(dtype)  # (S, M, M)

    with profiling.span("cnmgp.prior_chol_inv"):
        eyeM = torch.eye(M, dtype=dtype, device=x.device)
        K_stat = torch.stack([K_te_22, K_L0_22, K_L1_22]).expand(S, 3, M, M)
        K_stack = torch.cat([K_stat, K_G_22[:, None]], dim=1) + jitter * eyeM
        if robust:
            Lp_all, Lp_inv = chol_tri_inv_robust(K_stack, jitter)
        else:
            Lp_all, Lp_inv = chol_tri_inv(K_stack)
    with profiling.span("cnmgp.cross_solve"):
        K12s = torch.stack([K_te_12, K_L0_12, K_L1_12]).transpose(-1, -2)  # (3, M, B)
        A_stat = tri_solve_white(Lp_all[:, :3], Lp_inv[:, :3], K12s.expand(S, 3, M, B))
        A_te, A_L0, A_L1 = A_stat[:, 0], A_stat[:, 1], A_stat[:, 2]  # (S, M, B)

    # --- (v, tilde_ell) joint draw ---------------------------------------
    with profiling.span("cnmgp.lengthscale"):
        proj_v = torch.matmul(Lp_inv[:, 0], sampled_v[..., None])  # (S, M, 1)
        mu_te = torch.matmul(A_te.transpose(-1, -2), proj_v)[..., 0]  # (S, B)
        # clamp the Nystrom residual: float32 cancellation at large M
        var_te = torch.clamp(s2_te - torch.sum(A_te * A_te, dim=-2), min=0.0)
        tilde_ell = torch.clamp(sample_diag(mu_te, var_te, noise.z_te, jitter), -30.0, 30.0)
        ell_X = torch.exp(tilde_ell)
        Wh_v = torch.matmul(Lp_inv[:, 0], Lt_v)  # (S, M, M)

    def whitened(sqrt, Ps, sizes):
        # the raw tril factors in ref_compat, else the regularized ones
        if kl_mode == "ref_compat":
            return WhitenedFactors(whiten(tril_mask(sqrt), Ps, sizes), None, None)
        return whitened_factors(sqrt, Ps, sizes, jitter)

    # --- coefficient matrix L(x); packed [:T0] offdiag, [T0:] diag --------
    with profiling.span("cnmgp.coef_diag"):
        T0 = D * (D - 1) // 2
        P_off, P_diag = Lp_inv[:, 1], Lp_inv[:, 2]
        Wh_U = whitened(params.sqrt_U, (P_off, P_diag), (T0, D))
        mean_d, var_d = mgp_moments_white(A_L1, P_diag, s2_L1, params.mu_U[T0:], Wh_U.W[1])
        L_diag = torch.exp(sample_diag(mean_d, var_d, noise.z_diag, jitter))  # (S, D, B)

    with profiling.span("cnmgp.coef_off"):
        L_full = torch.zeros((S, B, D, D), dtype=dtype, device=x.device)
        if D > 1:
            ii, jj = _tril_idx(D, x.device, -1)
            mean_o, var_o = mgp_moments_white(A_L0, P_off, s2_L0, params.mu_U[:T0], Wh_U.W[0])
            L_off = sample_diag(mean_o, var_o, noise.z_off, jitter)  # (S, T0, B)
            L_full[:, :, ii, jj] = L_off.transpose(-1, -2)
        dd = torch.arange(D, device=x.device)
        L_full[:, :, dd, dd] = L_diag.transpose(-1, -2)

    # --- shared latents g (analytic marginal stats) ----------------------
    with profiling.span("cnmgp.gibbs_cross"):
        K_G_12 = gibbs(x, Z, ell_X, ell_Z, sigma2_g)  # (S, B, M)
        A_G = tri_solve_white(Lp_all[:, 3], Lp_inv[:, 3], K_G_12.transpose(-1, -2))
    with profiling.span("cnmgp.g_moments"):
        P_G = Lp_inv[:, 3]
        Wh_W = whitened(params.sqrt_W, (P_G,), (D,))
        mu_g, s2_g = mgp_moments_white(A_G, P_G, sigma2_g, params.mu_W, Wh_W.W[0])
    return _Latents(
        L_full=L_full, mu_g=mu_g, sigma2_g=s2_g, tilde_ell=tilde_ell, sampled_v=sampled_v,
        Lp_all=Lp_all, Lp_inv=Lp_inv, Wh_v=Wh_v, Wh_U=Wh_U, Wh_W=Wh_W,
    )


def _kl_terms(params: CNMGPParams, lat: _Latents, jitter=DSVI_JITTER, kl_mode="true"):
    """The three KL groups (kl_W, kl_v, kl_U), each (S,), from the pieces
    `_sample_latents` computed (JAX `_kl_terms`, cnmgp.py:386-454).
    kl_mode "true": the exact KL of the regularized factor family, from the
    traces and log-determinants `whitened_factors` gave with the group sets'
    whitened factors (v's from its factor and regularized diagonal).
    "ref_compat": the reference's KL on raw tril factors, its diagonal-only
    trace included."""
    D = params.num_outputs
    T0 = D * (D - 1) // 2
    Lp_diag = torch.diagonal(lat.Lp_all, dim1=-2, dim2=-1)  # (S, 4, M)
    logdet_p = torch.sum(torch.log(Lp_diag), dim=-1)  # (S, 4)

    def kl(mu_q, sqrt_q, wh, prior, grouped, k=0):
        # a group of G factors broadcasts (S, 1) prior scalars against (S, G);
        # `wh` is v's whitened factor, or the group sets' `WhitenedFactors`
        # and k the set
        ld = logdet_p[:, prior, None] if grouped else logdet_p[:, prior]
        lp_inv = lat.Lp_inv[:, prior]
        if kl_mode == "ref_compat":
            lp_d = Lp_diag[:, prior, None, :] if grouped else Lp_diag[:, prior]
            out = kl_gaussian_ref_compat(mu_q, tril_mask(sqrt_q), lp_d, ld, lp_inv, jitter)
        elif grouped:
            out = kl_gaussian_white_parts(mu_q, wh.logdet_q[k], wh.trace[k], ld, lp_inv)
        else:
            out = kl_gaussian_white(mu_q, regularized_diag(sqrt_q, jitter), wh, ld, lp_inv)
        return torch.sum(out, dim=-1) if grouped else out

    kl_W = kl(params.mu_W, params.sqrt_W, lat.Wh_W, 3, True)
    kl_v = kl(params.mu_v, params.sqrt_v, lat.Wh_v, 0, False)
    kl_U = kl(params.mu_U[T0:], params.sqrt_U[T0:], lat.Wh_U, 2, True, 1)
    if D > 1:
        kl_U = kl_U + kl(params.mu_U[:T0], params.sqrt_U[:T0], lat.Wh_U, 1, True, 0)
    return kl_W, kl_v, kl_U


def _reconstruction(params: CNMGPParams, lat: _Latents, y, idx, weight):
    """Weighted reconstruction term of each draw, (S,) (JAX
    `_reconstruction`, cnmgp.py:457-479; nmgp_dsvi.py:255-258).  `weight` is
    the 0/1 mask of a padded batch."""
    rows = torch.arange(y.shape[0], device=y.device)
    sampled_l = lat.L_full[:, rows, idx, :]  # (S, B, D)
    s2_err = torch.exp(params.sigma2_err_log)
    F = torch.sum(sampled_l * lat.mu_g.transpose(-1, -2), dim=-1)  # (S, B)
    log_pdf = (
        -((y - F) ** 2) / (2.0 * s2_err)
        - 0.5 * params.sigma2_err_log
        - 0.5 * math.log(2.0 * math.pi)
    )
    recon = torch.sum(log_pdf * weight, dim=-1)
    correction = 0.5 / s2_err * torch.sum(
        sampled_l**2 * lat.sigma2_g.transpose(-1, -2) * weight[:, None], dim=(-2, -1)
    )
    return recon - correction


def negative_selbo(
    params: CNMGPParams, Z, x, y, idx, weight, n_total, noise: CNMGPNoise,
    jitter=DSVI_JITTER, kl_mode="true", batch_size=None, with_kl: bool = True,
):
    """-SELBO of one minibatch (JAX `negative_selbo`, cnmgp.py:482-506; the
    reference's `NMGP.forward`, nmgp_dsvi.py:157-301), a scalar tensor.

    x (B,) or (B, d) inputs; y (B,); idx (B,) output rows; weight (B,) 0/1
    mask of padding; n_total the number of observations.  `noise` comes
    from `draw_train_noise` with one draw (S = 1); with more, the estimate
    is their mean.

    A data-parallel shard passes its rows of the minibatch, `batch_size`
    the weight of the whole minibatch (default: these rows' own), and
    `with_kl=False` on every shard but one, so that the shards' terms sum
    to the minibatch's -SELBO with the KLs counted once.
    """
    lat = _sample_latents(params, Z, x, noise, jitter, kl_mode=kl_mode)
    if batch_size is None:
        batch_size = torch.sum(weight)
    recon = _reconstruction(params, lat, y, idx, weight)
    if with_kl:
        kl_W, kl_v, kl_U = _kl_terms(params, lat, jitter, kl_mode)
        selbo = n_total / batch_size * recon - kl_W - kl_v - kl_U
    else:
        selbo = n_total / batch_size * recon
    return -torch.mean(selbo)


def elbo_estimate(
    params: CNMGPParams, Z, x, y, idx, noise: CNMGPNoise, jitter=DSVI_JITTER,
    kl_mode="true", draws_per_chunk: int = 8,
):
    """Monte-Carlo ELBO over the full data (JAX `elbo_estimate`,
    cnmgp.py:509-531; reference `compute_ELBO`), one draw per leading row of
    `noise` (`draw_train_noise(gen, n_sample, ...)`), run `draws_per_chunk`
    draws at a time to bound device memory.  Returns mean(recon) - mean(KL)."""
    weight = torch.ones_like(y)
    recons, kls = [], []
    for start in range(0, noise.z_v1.shape[0], draws_per_chunk):
        chunk = CNMGPNoise(*(None if z is None else z[start:start + draws_per_chunk] for z in noise))
        lat = _sample_latents(params, Z, x, chunk, jitter, kl_mode=kl_mode)
        recons.append(_reconstruction(params, lat, y, idx, weight))
        kls.append(sum(_kl_terms(params, lat, jitter, kl_mode)))
    return torch.mean(torch.cat(recons)) - torch.mean(torch.cat(kls))


def sample_y_once(params: CNMGPParams, Z, x, idx, noise: CNMGPNoise, jitter=DSVI_JITTER,
                  kl_mode="true"):
    """Posterior-predictive draws at flat inputs x (B,) with output rows idx
    (B,), one per leading row of `noise` (the JAX `sample_y_once`, vmapped).

    g is drawn from its marginal.  Returns (y_star (S, B), l_star (S, B, D),
    g_star (S, D, B), tilde_ell (S, B)).  The prior factorization is the
    robust one.  `kl_mode` must match how the model was trained.
    """
    with profiling.span("cnmgp.sample_y"):
        lat = _sample_latents(params, Z, x, noise, jitter, robust=True, kl_mode=kl_mode)
        with profiling.span("cnmgp.combine"):
            g_star = sample_diag(lat.mu_g, lat.sigma2_g, noise.z_g, jitter)  # (S, D, B)
            rows = torch.arange(x.shape[0], device=x.device)
            l_star = lat.L_full[:, rows, idx, :]  # (S, B, D)
            F = torch.sum(l_star * g_star.transpose(-1, -2), dim=-1)  # (S, B)
            s2_err = torch.exp(params.sigma2_err_log)
            y_star = sample_diag(F, s2_err, noise.z_y, jitter)
        return y_star, l_star, g_star, lat.tilde_ell


def sample_fy_once(params: CNMGPParams, Z, x, noise: CNMGPNoise, jitter=DSVI_JITTER,
                   kl_mode="true"):
    """Draws of (tilde_ell (S, B), Y (S, B, D), corr (S, B, D, D)) at common
    inputs x, one per leading row of `noise` (the JAX `sample_fy_once`):
    all D outputs at every input and corr = Dg^-1 L L^T Dg^-1."""
    with profiling.span("cnmgp.sample_fy"):
        lat = _sample_latents(params, Z, x, noise, jitter, robust=True, kl_mode=kl_mode)
        with profiling.span("cnmgp.combine"):
            g_star = sample_diag(lat.mu_g, lat.sigma2_g, noise.z_g, jitter)  # (S, D, B)
            F = torch.einsum("sbij,sjb->sbi", lat.L_full, g_star)  # (S, B, D)
            s2_err = torch.exp(params.sigma2_err_log)
            Y = sample_diag(F, s2_err, noise.z_y, jitter)
            cov = torch.einsum("sbij,sbkj->sbik", lat.L_full, lat.L_full)
            inv_std = 1.0 / torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))
            corr = cov * inv_std[..., :, None] * inv_std[..., None, :]
        return lat.tilde_ell, Y, corr


def predict_y_mean(params: CNMGPParams, Z, x, idx, jitter=DSVI_JITTER, sigma2_g=1.0):
    """Plug-in posterior-mean prediction at flat inputs x (B,) with output
    rows idx (reference `predict_Y`, nmgp_dsvi.py:666-722): every latent at
    its posterior mean.  Returns (B,)."""
    with profiling.span("cnmgp.predict_mean"):
        D = params.num_outputs
        B = x.shape[0]
        with profiling.span("cnmgp.mean_lengthscale"):
            s2_te = torch.exp(params.sigma2_tildeell_log)
            ls_te = torch.exp(params.length_scales_tildeell_log)
            P_te = conditional_projection(rbf(x, Z, s2_te, ls_te), rbf(Z, Z, s2_te, ls_te), jitter)
            est_tilde_ell = mgp_mean(P_te, params.mu_v)
            ell_Z = torch.exp(params.mu_v)
            ell_X = torch.exp(est_tilde_ell)

        with profiling.span("cnmgp.mean_projections"):
            s2_L0 = torch.exp(params.sigma2_L0_log)
            ls_L0 = torch.exp(params.length_scales_L0_log)
            s2_L1 = torch.exp(params.sigma2_L1_log)
            ls_L1 = torch.exp(params.length_scales_L1_log)
            P0 = conditional_projection(rbf(x, Z, s2_L0, ls_L0), rbf(Z, Z, s2_L0, ls_L0), jitter)
            P1 = conditional_projection(rbf(x, Z, s2_L1, ls_L1), rbf(Z, Z, s2_L1, ls_L1), jitter)
        with profiling.span("cnmgp.mean_coef"):
            T0 = D * (D - 1) // 2
            L_full = torch.zeros((B, D, D), dtype=x.dtype, device=x.device)
            dd = torch.arange(D, device=x.device)
            L_full[:, dd, dd] = torch.exp(mgp_mean(P1, params.mu_U[T0:])).T
            if D > 1:
                ii, jj = _tril_idx(D, x.device, -1)
                L_full[:, ii, jj] = mgp_mean(P0, params.mu_U[:T0]).T

        with profiling.span("cnmgp.mean_gibbs"):
            K_G_12 = gibbs(x, Z, ell_X, ell_Z, sigma2_g)
            K_G_22 = gibbs(Z, Z, ell_Z, ell_Z, sigma2_g)
        with profiling.span("cnmgp.mean_g"):
            P_G = conditional_projection(K_G_12, K_G_22, jitter)
            est_g = mgp_mean(P_G, params.mu_W)  # (D, B)
        with profiling.span("cnmgp.combine"):
            est_Y = torch.einsum("bij,jb->bi", L_full, est_g)  # (B, D)
            return est_Y[torch.arange(B, device=x.device), idx]
