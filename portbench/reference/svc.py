"""The whitened SVC log posterior and one ChEES-HMC transition in plain
PyTorch.

The model of the reference simulation study (`code/SIM_code/logpos.py`,
`logpos_SVC`): two outputs at N inputs, y = vec(Y^T) ~ N(0, K + s2e I) with
K[(i,n),(j,m)] = k_x(n, m) <L_f[n, i, :], L_f[m, j, :]>, k_x the Gibbs
kernel of the lengthscale process exp(tilde_l) plus `mcmc_jitter` on its
diagonal, L_f[n] the lower-triangular factor of the unconstrained vector
u_n (exp on its diagonal); tilde_l = mu_l + chol_l eta_l and u = mu_L +
chol_L eta_U (the whitened parameterization, eta ~ N(0, I)); s2e inverse
gamma, sampled as its log.  chol_l and chol_L are the Choleskys of the RBF
prior covariances plus a stated jitter, worked out here.

The ChEES transition (Hoffman, Radul & Sountsov 2021, as the reference
study's sampler runs it at fixed tuning): momentum p0 = z / sqrt(inv_mass),
n leapfrog steps of size eps, accept when u < exp(H0 - H1).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def prior_chols(x, pairs, jitters):
    """Lower Choleskys of alpha^2 exp(-d^2 / (2 beta^2)) + jitter I, one per pair."""
    d2 = (x[:, None] - x[None, :]) ** 2
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    return [torch.linalg.cholesky(a * a * torch.exp(-0.5 * d2 / (b * b)) + j * eye)
            for (a, b), j in zip(pairs, jitters)]


def log_posterior(q, Y, x, chol_l, chol_L, h, mcmc_jitter):
    """log p(eta, log s2e | Y) up to a constant, q (C, N + 3N + 1) -> (C,)."""
    N, M = Y.shape
    T = M * (M + 1) // 2
    eta_l, eta_U, log_s2e = q[:, :N], q[:, N:N + N * T], q[:, -1]
    tilde_l = h["mu_tilde_l"] + eta_l @ chol_l.T
    U = h["mu_L"] + chol_L @ eta_U.reshape(-1, N, T)  # (C, N, T)
    # u -> lower-triangular L_f with exp on the diagonal, row-major (0,0), (1,0), (1,1)
    L_f = torch.zeros(U.shape[:2] + (M, M), dtype=q.dtype, device=q.device)
    rows, cols = np.tril_indices(M)
    for t, (r, c) in enumerate(zip(rows, cols)):
        L_f[:, :, r, c] = torch.exp(U[:, :, t]) if r == c else U[:, :, t]
    ell = torch.exp(tilde_l)
    den = ell[:, :, None] ** 2 + ell[:, None, :] ** 2
    d2 = (x[:, None] - x[None, :]) ** 2
    eye_n = torch.eye(N, dtype=q.dtype, device=q.device)
    K_x = torch.sqrt(2.0 * ell[:, :, None] * ell[:, None, :] / den) * torch.exp(-d2 / den) \
        + mcmc_jitter * eye_n
    # task-major: row (i, n) holds L_f[n, i, :]
    R = L_f.transpose(1, 2).reshape(-1, M * N, M)
    s2e = torch.exp(log_s2e)
    S = (R @ R.transpose(-1, -2)) * K_x.repeat(1, M, M) \
        + s2e[:, None, None] * torch.eye(M * N, dtype=q.dtype, device=q.device)
    L, info = torch.linalg.cholesky_ex(S)
    y = Y.T.reshape(-1)
    sol = torch.linalg.solve_triangular(L, y.expand(q.shape[0], -1)[..., None], upper=False)[..., 0]
    lik = -torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1) - 0.5 * torch.sum(sol * sol, -1)
    # a chain whose covariance is not positive-definite (in a lower precision) has no density
    lik = torch.where(info == 0, lik, torch.full_like(lik, float("nan")))
    a, b = h["a"], h["b"]
    inv_gamma = (-a - 1.0) * log_s2e - b / s2e + a * math.log(b) - math.lgamma(a)
    return lik - 0.5 * torch.sum(q[:, :-1] ** 2, -1) + inv_gamma + log_s2e


def value_and_grad(lp, q):
    q = q.detach().requires_grad_(True)
    with torch.enable_grad():
        v = lp(q)
        (g,) = torch.autograd.grad(v.sum(), q)
    return v.detach(), g


def halton(n: int, offset: int = 0) -> np.ndarray:
    """Points offset..offset+n of the base-2 van der Corput sequence."""
    out = np.zeros(n)
    for i in range(n):
        f, r, k = 0.5, 0.0, offset + i + 1
        while k > 0:
            r += f * (k & 1)
            k >>= 1
            f *= 0.5
        out[i] = r
    return out


def transition(lp, q0, z, u, eps, inv_mass, num_steps):
    """One fixed-length HMC transition of every chain from q0 (C, dim) with
    standard-normal momentum draws z (C, dim) and uniforms u (C,).  Returns
    (the proposal, log_ratio (C,), the new position after the accept, lp at q0)."""
    lp0, g = value_and_grad(lp, q0)
    p0 = z / torch.sqrt(inv_mass)
    q, p = q0, p0
    for _ in range(num_steps):
        p_half = p + 0.5 * eps * g
        q = q + eps * (inv_mass * p_half)
        lp1, g = value_and_grad(lp, q)
        p = p_half + 0.5 * eps * g
    ke0 = 0.5 * torch.sum(inv_mass * p0 ** 2, -1)
    ke1 = 0.5 * torch.sum(inv_mass * p ** 2, -1)
    log_ratio = (lp1 - ke1) - (lp0 - ke0)
    log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio, -math.inf)
    accept = u < torch.clamp(torch.exp(log_ratio), max=1.0)
    return q, log_ratio, torch.where(accept[:, None], q, q0), lp0
