"""The work the port's kernels carry, priced from shapes alone.

Operations and bytes of each kernel call, the arithmetic of the port's
card check (`chip_smoke.py`: `bound_ms`, `qf_bound`, the backward
kernels', the Gibbs, RBF and Cholesky-inverse shapes), kept here so that a
change to the port cannot move it: inputs read once, of a triangular input
only its triangle, outputs written once, an FMA two operations.  A path's
calls are listed per unit of work (a DSVI step, one predictive draw, one
log-density gradient), at the shapes the configuration gives them; the
count is of the work the mathematics needs, not of how the port splits it
into launches.

A call's least time is the larger of its bytes over the HBM rate and its
operations over the dense TF32 tensor-core rate, the highest rate at which
a float32-accurate computation could run on the card.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, 700 W): HBM3 and TF32 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_PER_S = 495e12
F32 = 4


def quadform(S, G, M, N):
    """6a, V[s, g, n] = sum_k (A_s^T W_sg)[n, k]^2, W lower-triangular:
    M (M + 1) / 2 FMAs for C and M for its squares per (s, g, n)."""
    return S * G * N * (M * M + 3 * M), F32 * (S * M * N + S * G * M * (M + 1) // 2 + S * G * N)


def quadform_dw(G, M, N):
    """6b, dW_g = tril(A E_g), E_g = 2 vbar_g C_g: C, then the product."""
    return 2 * G * N * M * (M + 1), F32 * (M * N + G * N + G * M * M) + F32 * G * M * (M + 1) // 2


def quadform_da(G, M, N):
    """6c, dA = sum_g W_g E_g^T."""
    return 2 * G * N * M * (M + 1), F32 * (M * N + G * N + M * N) + F32 * G * M * (M + 1) // 2


def gibbs(S, N1, N2):
    """A Gibbs gram of S draws, ~15 operations an entry."""
    el = S * N1 * N2
    return 15 * el, F32 * (N1 + N2 + S * (N1 + N2) + el)


def rbf(S, N1, N2):
    """An RBF gram of S (scale, lengthscale) pairs, ~8 operations an entry."""
    el = S * N1 * N2
    return 8 * el, F32 * (N1 + N2 + 2 * S + el)


def chol_inv(S, M):
    """Cholesky factor and its triangular inverse of S SPD matrices."""
    return S * 2 * M**3 // 3, F32 * S * (M * (M + 1) // 2 + 2 * M * M)


def least_s(cost):
    ops, nbytes = cost
    return max(ops / PEAK_TF32_PER_S, nbytes / PEAK_BYTES_PER_S)


def total(calls):
    """(operations, least seconds) of a list of (ops, bytes) calls."""
    return sum(c[0] for c in calls), sum(least_s(c) for c in calls)


def _groups(D):
    return D * (D - 1) // 2, D  # offdiagonal and diagonal coefficient groups


def dsvi_step(D, M, B):
    """One DSVI step at minibatch B: the Gibbs grams (Z, Z) and (x, Z), the
    four-member prior Cholesky-inverse, the quadform of the three group
    sets (offdiagonal, diagonal, latent functions) and its two backward
    kernels."""
    off, diag = _groups(D)
    calls = [gibbs(1, M, M), gibbs(1, B, M), chol_inv(4, M)]
    for G in (off, diag, D):
        calls += [quadform(1, G, M, B), quadform_dw(G, M, B), quadform_da(G, M, B)]
    return calls


def predictive_draw(D, M, B):
    """One posterior-predictive draw at B points (`sample_Y`): the forward of
    a DSVI step."""
    off, diag = _groups(D)
    return [gibbs(1, M, M), gibbs(1, B, M), chol_inv(4, M)] + [
        quadform(1, G, M, B) for G in (off, diag, D)]


def posterior_mean(D, M, B):
    """One plug-in posterior mean at B points (`predict_Y`): the RBF grams of
    the three stationary processes at (x, Z) and (Z, Z), the Gibbs pair."""
    return [rbf(1, B, M), rbf(1, M, M)] * 3 + [gibbs(1, B, M), gibbs(1, M, M)]


def request(cfg, traffic, unit):
    """(operations, least seconds) of one served request (`dsvi_serve`'s
    unit record: its kind and B)."""
    if unit["kind"] == "predict":
        return total(posterior_mean(cfg["D"], cfg["M"], unit["b"]))
    ops, least = total(predictive_draw(cfg["D"], cfg["M"], unit["b"]))
    return traffic["sample_draws"] * ops, traffic["sample_draws"] * least


def svc_gradient(C, N, outputs):
    """One gradient of the SVC log density of C chains: the Gibbs gram of
    the lengthscale process and the Cholesky-inverse of the (C, MN, MN)
    covariance."""
    return [gibbs(C, N, N), chol_inv(C, N * outputs)]
