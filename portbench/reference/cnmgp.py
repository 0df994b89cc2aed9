"""CNMGP in plain PyTorch: the negative stochastic ELBO of one minibatch,
a posterior-predictive draw and the plug-in posterior mean.

Written from the model's equations as the reference study states them
(`code/nmgp_dsvi.py`: `NMGP.forward` 157-301, `sample_Y` 406-491,
`predict_Y` 666-722) in the "true" KL form (the exact KL of the
jitter-regularized factor family), with every Cholesky by
`torch.linalg.cholesky`, every triangular solve by
`torch.linalg.solve_triangular`, every gram and quadratic form as a plain
broadcast or einsum, and gradients by autograd.  It runs in any dtype; the
benchmark runs it in float64.

Parameters are a dict of tensors keyed by `FIELDS`; the draws a dict keyed
by `NOISE` (the standard normals of S draws, leading dim S).
"""

from __future__ import annotations

import math

import torch

FIELDS = (
    "mu_v", "sqrt_v", "mu_W", "sqrt_W", "mu_U", "sqrt_U",
    "sigma2_tildeell_log", "length_scales_tildeell_log", "sigma2_L0_log",
    "length_scales_L0_log", "sigma2_L1_log", "length_scales_L1_log", "sigma2_err_log",
)
# z_v1 (S, M), z_te (S, B), z_diag (S, D, B), z_off (S, D(D-1)/2, B); the
# predictive draws add z_g (S, D, B) and z_y (S, B)
NOISE = ("z_v1", "z_te", "z_diag", "z_off", "z_g", "z_y")


def sq_dist(a, b):
    """(N1,) x (N2,) -> (N1, N2) squared differences."""
    return (a[:, None] - b[None, :]) ** 2


def rbf(a, b, s2, ls):
    return s2 * torch.exp(-0.5 * sq_dist(a, b) / (ls * ls))


def gibbs(a, b, l1, l2, s2=1.0):
    """s2 sqrt(2 l1 l2 / (l1^2 + l2^2)) exp(-d^2 / (l1^2 + l2^2)); l1 (..., N1), l2 (..., N2)."""
    e1, e2 = l1[..., :, None], l2[..., None, :]
    den = e1 * e1 + e2 * e2
    return s2 * torch.sqrt(2.0 * e1 * e2 / den) * torch.exp(-sq_dist(a, b) / den)


def tril_regularized(X, jitter):
    """tril(X) with its diagonal d replaced by sign(d) sqrt(d^2 + jitter)."""
    d = torch.diagonal(X, dim1=-2, dim2=-1)
    sign = torch.where(d >= 0, 1.0, -1.0).to(X.dtype)
    d_reg = sign * torch.sqrt(d * d + jitter)
    return torch.tril(X, -1) + torch.diag_embed(d_reg)


def chol_inv(K, robust_jitter=None, boost=100.0):
    """(L, L^-1) of SPD K (..., M, M).  With `robust_jitter`, a member whose
    factor fails is factored again with boost * jitter more on its diagonal."""
    L, info = torch.linalg.cholesky_ex(K)
    if robust_jitter is not None and bool((info > 0).any()):
        bad = (info > 0).to(K.dtype)[..., None, None]
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        L, info = torch.linalg.cholesky_ex(K + boost * robust_jitter * bad * eye)
    if bool((info > 0).any()):
        raise FloatingPointError("reference Cholesky failed")
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return L, torch.linalg.solve_triangular(L, eye.expand_as(K), upper=False)


def moments_white(A, Lp_inv, d11, mu, scale_tril):
    """Whitened sparse-GP marginal moments of G groups: mean = A^T Lp^-1 mu,
    var = max(d11 - colsum(A^2), 0) + rowsum((A^T W)^2), W = Lp^-1 scale_tril."""
    mean = torch.matmul(torch.matmul(mu, Lp_inv.transpose(-1, -2)), A)
    base = torch.clamp(d11 - torch.sum(A * A, dim=-2), min=0.0)
    W = torch.matmul(Lp_inv[..., None, :, :], scale_tril)
    C = torch.einsum("...mn,...gmk->...gnk", A, W)
    return mean, base[..., None, :] + torch.sum(C * C, dim=-1), W


def latents(p, Z, x, nz, jitter, robust=False, sigma2_g=1.0):
    """S reparameterized draws of every latent process at inputs x (B,)."""
    D = p["mu_W"].shape[0]
    S, M, B = nz["z_v1"].shape[0], Z.shape[0], x.shape[0]
    e = {k: torch.exp(p[k]) for k in FIELDS[6:12]}

    def pair(s2, ls):
        return rbf(x, Z, s2, ls), rbf(Z, Z, s2, ls)

    K_te_12, K_te_22 = pair(e["sigma2_tildeell_log"], e["length_scales_tildeell_log"])
    K_L0_12, K_L0_22 = pair(e["sigma2_L0_log"], e["length_scales_L0_log"])
    K_L1_12, K_L1_22 = pair(e["sigma2_L1_log"], e["length_scales_L1_log"])
    Lt_v = tril_regularized(p["sqrt_v"], jitter)
    sampled_v = torch.clamp(p["mu_v"] + torch.matmul(Lt_v, nz["z_v1"][..., None])[..., 0],
                            -30.0, 30.0)
    ell_Z = torch.exp(sampled_v)
    eye = torch.eye(M, dtype=x.dtype, device=x.device)
    K_stack = torch.cat([torch.stack([K_te_22, K_L0_22, K_L1_22]).expand(S, 3, M, M),
                         gibbs(Z, Z, ell_Z, ell_Z, sigma2_g)[:, None]], dim=1) + jitter * eye
    Lp, Lp_inv = chol_inv(K_stack, jitter if robust else None)
    K12s = torch.stack([K_te_12, K_L0_12, K_L1_12]).transpose(-1, -2).expand(S, 3, M, B)
    A = torch.linalg.solve_triangular(Lp[:, :3], K12s, upper=False)
    A_te, A_L0, A_L1 = A[:, 0], A[:, 1], A[:, 2]

    mu_te = torch.matmul(A_te.transpose(-1, -2),
                         torch.matmul(Lp_inv[:, 0], sampled_v[..., None]))[..., 0]
    var_te = torch.clamp(e["sigma2_tildeell_log"] - torch.sum(A_te * A_te, dim=-2), min=0.0)
    tilde_ell = torch.clamp(mu_te + nz["z_te"] * torch.sqrt(var_te + jitter), -30.0, 30.0)
    Wh_v = torch.matmul(Lp_inv[:, 0], Lt_v)

    T0 = D * (D - 1) // 2
    SU = tril_regularized(p["sqrt_U"], jitter)
    mean_d, var_d, Wh_diag = moments_white(A_L1, Lp_inv[:, 2], e["sigma2_L1_log"],
                                           p["mu_U"][T0:], SU[T0:])
    mean_o, var_o, Wh_off = moments_white(A_L0, Lp_inv[:, 1], e["sigma2_L0_log"],
                                          p["mu_U"][:T0], SU[:T0])
    L_diag = torch.exp(mean_d + nz["z_diag"] * torch.sqrt(var_d + jitter))
    L_off = mean_o + nz["z_off"] * torch.sqrt(var_o + jitter)
    ii, jj = torch.tril_indices(D, D, -1, device=x.device)
    dd = torch.arange(D, device=x.device)
    L_full = torch.zeros((S, B, D, D), dtype=x.dtype, device=x.device)
    L_full[:, :, ii, jj] = L_off.transpose(-1, -2)
    L_full[:, :, dd, dd] = L_diag.transpose(-1, -2)

    K_G_12 = gibbs(x, Z, torch.exp(tilde_ell), ell_Z, sigma2_g)
    A_G = torch.linalg.solve_triangular(Lp[:, 3], K_G_12.transpose(-1, -2), upper=False)
    mu_g, s2_g, Wh_W = moments_white(A_G, Lp_inv[:, 3], sigma2_g, p["mu_W"],
                                     tril_regularized(p["sqrt_W"], jitter))
    return dict(L_full=L_full, mu_g=mu_g, s2_g=s2_g, tilde_ell=tilde_ell, Lp=Lp,
                Lp_inv=Lp_inv, Wh_v=Wh_v, Wh_off=Wh_off, Wh_diag=Wh_diag, Wh_W=Wh_W)


def _kl(mu_q, sqrt_q, Wh, logdet_p, Lp_inv, jitter):
    """KL(N(mu_q, L L^T) || N(0, Lp Lp^T)) from the whitened factor Wh = Lp^-1 L."""
    d = torch.diagonal(sqrt_q, dim1=-2, dim2=-1)
    logdet_q = torch.sum(torch.log(torch.sqrt(d * d + jitter)), dim=-1)
    sol = torch.matmul(mu_q, Lp_inv.transpose(-1, -2))
    return (logdet_p - logdet_q) + 0.5 * (torch.sum(Wh * Wh, dim=(-2, -1))
                                          + torch.sum(sol * sol, dim=-1) - mu_q.shape[-1])


def kl_total(p, lat, jitter):
    """kl_W + kl_v + kl_U of each draw, (S,)."""
    D = p["mu_W"].shape[0]
    T0 = D * (D - 1) // 2
    logdet = torch.sum(torch.log(torch.diagonal(lat["Lp"], dim1=-2, dim2=-1)), dim=-1)
    Li = lat["Lp_inv"]
    total = _kl(p["mu_v"], p["sqrt_v"], lat["Wh_v"], logdet[:, 0], Li[:, 0], jitter)
    for mu, sq, wh, k in ((p["mu_W"], p["sqrt_W"], lat["Wh_W"], 3),
                          (p["mu_U"][T0:], p["sqrt_U"][T0:], lat["Wh_diag"], 2),
                          (p["mu_U"][:T0], p["sqrt_U"][:T0], lat["Wh_off"], 1)):
        total = total + torch.sum(_kl(mu, sq, wh, logdet[:, k, None], Li[:, k], jitter), dim=-1)
    return total


def negative_selbo(p, Z, x, y, idx, weight, n_total, nz, jitter):
    """-SELBO of one minibatch: -(n_total / |batch| * reconstruction - KL), mean over draws."""
    lat = latents(p, Z, x, nz, jitter)
    rows = torch.arange(y.shape[0], device=y.device)
    l = lat["L_full"][:, rows, idx, :]
    s2e = torch.exp(p["sigma2_err_log"])
    F = torch.sum(l * lat["mu_g"].transpose(-1, -2), dim=-1)
    log_pdf = -((y - F) ** 2) / (2.0 * s2e) - 0.5 * p["sigma2_err_log"] - 0.5 * math.log(2 * math.pi)
    recon = torch.sum(log_pdf * weight, dim=-1) - 0.5 / s2e * torch.sum(
        l * l * lat["s2_g"].transpose(-1, -2) * weight[:, None], dim=(-2, -1))
    return -torch.mean(n_total / torch.sum(weight) * recon - kl_total(p, lat, jitter))


def sample_y(p, Z, x, idx, nz, jitter):
    """Posterior-predictive draws y (S, B) at inputs x with output rows idx."""
    lat = latents(p, Z, x, nz, jitter, robust=True)
    g = lat["mu_g"] + nz["z_g"] * torch.sqrt(lat["s2_g"] + jitter)
    rows = torch.arange(x.shape[0], device=x.device)
    F = torch.sum(lat["L_full"][:, rows, idx, :] * g.transpose(-1, -2), dim=-1)
    return F + nz["z_y"] * torch.sqrt(torch.exp(p["sigma2_err_log"]) + jitter)


def predict_y(p, Z, x, idx, jitter, sigma2_g=1.0):
    """The plug-in posterior mean (B,): every latent at its posterior mean."""
    D, B, M = p["mu_W"].shape[0], x.shape[0], Z.shape[0]
    e = {k: torch.exp(p[k]) for k in FIELDS[6:12]}
    eye = torch.eye(M, dtype=x.dtype, device=x.device)

    def projection(K12, K22):  # K12 (K22 + jitter I)^-1
        L = torch.linalg.cholesky(K22 + jitter * eye)
        return torch.cholesky_solve(K12.transpose(-1, -2), L).transpose(-1, -2)

    def stat(s2, ls):
        return projection(rbf(x, Z, s2, ls), rbf(Z, Z, s2, ls))

    tilde_ell = stat(e["sigma2_tildeell_log"], e["length_scales_tildeell_log"]) @ p["mu_v"]
    P0 = stat(e["sigma2_L0_log"], e["length_scales_L0_log"])
    P1 = stat(e["sigma2_L1_log"], e["length_scales_L1_log"])
    T0 = D * (D - 1) // 2
    L_full = torch.zeros((B, D, D), dtype=x.dtype, device=x.device)
    dd = torch.arange(D, device=x.device)
    ii, jj = torch.tril_indices(D, D, -1, device=x.device)
    L_full[:, dd, dd] = torch.exp(p["mu_U"][T0:] @ P1.T).T
    L_full[:, ii, jj] = (p["mu_U"][:T0] @ P0.T).T
    ell_Z, ell_X = torch.exp(p["mu_v"]), torch.exp(tilde_ell)
    P_G = projection(gibbs(x, Z, ell_X, ell_Z, sigma2_g), gibbs(Z, Z, ell_Z, ell_Z, sigma2_g))
    g = p["mu_W"] @ P_G.T  # (D, B)
    return torch.einsum("bij,jb->bi", L_full, g)[torch.arange(B, device=x.device), idx]
