"""SMC model comparison: log marginal likelihoods across the model family
(the JAX package's `scripts/run_model_comparison.py`).

The reference compares models by AIC/BIC/DIC over sampler histories
(SIM_code/Utility/model_validation.py:9-51); adaptive-tempering SMC gives
the log marginal likelihood of each instead.  On the SIM_MNTS
nonstationary 2-output series it compares
  - LMC (stationary), which should lose on nonstationary data;
  - SNMGP (whitened): nonstationary lengthscale and signal-sd processes;
  - SVC / GNMGP (whitened): a fully varying covariance L(x);
and prints one JSON line: each model's log_z, stages and wall_s, the log
Bayes factors against LMC and the best model.

    python -m collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers.model_comparison \\
        [--N 48] [--particles 512] [--mutations 5] [--cpu]

Runs on the card unless `--cpu` is given.  Each closure maps (P, dim)
particles to (P,).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Callable, NamedTuple, Optional

import torch

from ..config import DEFAULT_DTYPE, resolve_device
from ..infer.smc import run_smc_staged
from ..models import logdensities as ld
from ..ops.distributions import inverse_gamma_logpdf, mvn_logpdf_dense, mvn_logpdf_kron
from ..ops.kernels import nonstationary_rbf
from ..ops.linalg import uvec_to_lvec, vec_to_tril
from ..utils.sim import sim_mnts

__all__ = ["MODELS", "SEEDS", "NUM_LEAPFROG", "Model", "parse_args", "make_models", "run", "main"]

MODELS = ("lmc", "snmgp", "svc")
# the generator seeds of each model's prior draws and of its SMC run (the
# JAX script's PRNGKey(1) ... PRNGKey(6))
SEEDS = {"lmc": (1, 2), "snmgp": (3, 4), "svc": (5, 6)}
NUM_LEAPFROG = 16
C_UL = 10.0  # prior scale of the unconstrained Cholesky entries
# whitened SNMGP and SVC hyperparameters (run_model_comparison.py:121-122)
HYPERS = dict(mu_tilde_l=-3.0, alpha_tilde_l=3.0, beta_tilde_l=0.4, mu_tilde_sigma=0.0,
              alpha_tilde_sigma=1.0, beta_tilde_sigma=1.0)
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--N", type=int, default=48)
    p.add_argument("--particles", type=int, default=512)
    p.add_argument("--mutations", type=int, default=5)
    p.add_argument("--out", default=None)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    return p.parse_args(argv)


class Model(NamedTuple):
    log_prior: Callable  # (P, dim) -> (P,)
    log_like: Callable  # (P, dim) -> (P,)
    prior_sampler: Callable  # (generator, n) -> (n, dim)
    dim: int
    chols: Optional[tuple]  # the whitening factors (None: LMC has none)


def _s2e_prior(q):
    """Inverse-gamma(1, 1) on sigma^2 = exp(q[..., -1]) with its log-Jacobian."""
    return inverse_gamma_logpdf(torch.exp(q[..., -1]), 1.0, 1.0) + q[..., -1]


def _std_normal(v):
    return torch.sum(-0.5 * v**2 - _HALF_LOG_2PI, dim=-1)


def _ul_prior(uL):
    return torch.sum(-0.5 * (uL / C_UL) ** 2 - math.log(C_UL) - _HALF_LOG_2PI, dim=-1)


def _log_inv_gamma_draws(gen, n, like):
    """log(1 / g) for g ~ Gamma(1, 1) = Exponential(1), as (n, 1)."""
    g = torch.empty(n, dtype=like.dtype, device=like.device).exponential_(generator=gen)
    return torch.log(1.0 / g)[:, None]


def _randn(gen, shape, like):
    return torch.randn(shape, generator=gen, dtype=like.dtype, device=like.device)


def make_models(x, Y, chols=None) -> dict:
    """The three models' closures on data x (N,), Y (N, M) tensors (their
    dtype and device), as run_model_comparison.py:84-230 writes them.
    `chols` = {"snmgp": (chol_l, chol_s), "svc": (chol_l, chol_L)}
    replaces the computed whitening factors (cast to x's dtype)."""
    N, M = Y.shape
    T = ld.tri_size(M)
    y = Y.T.reshape(-1)
    zero = torch.zeros_like(y)
    eye_n = torch.eye(N, dtype=x.dtype, device=x.device)
    chols = dict(chols or {})
    h = HYPERS

    def b_f(uL):
        L = vec_to_tril(uvec_to_lvec(uL, M), M)
        return L @ L.transpose(-1, -2)

    # ------------------------------------------------ LMC (stationary)
    # [tilde_l, tilde_sigma, uL (T), tilde_s2e]: N(0, 1), N(0, 1), N(0, c)^T,
    # inverse gamma through the log
    def lmc_log_prior(q):
        lp = -0.5 * q[:, 0] ** 2 - _HALF_LOG_2PI
        lp = lp + (-0.5 * q[:, 1] ** 2 - _HALF_LOG_2PI)
        return lp + _ul_prior(q[:, 2:2 + T]) + _s2e_prior(q)

    def lmc_log_like(q):
        p = ld.lmc_unflatten(q, M)
        ones = torch.ones(N, dtype=q.dtype, device=q.device)
        ell = torch.exp(p.tilde_l)[:, None] * ones
        sig = torch.exp(p.tilde_sigma)[:, None] * ones
        K_x = nonstationary_rbf(x, sigma1=sig, ell1=ell) + 1e-6 * eye_n
        return mvn_logpdf_kron(y, zero, b_f(p.uL_vec), K_x, torch.exp(p.tilde_sigma2_err))

    def lmc_prior_sampler(gen, n):
        scal = _randn(gen, (n, 2), x)
        uL = C_UL * _randn(gen, (n, T), x) * 0.1  # near 0 for stability
        return torch.cat([scal, uL, _log_inv_gamma_draws(gen, n, x)], dim=1)

    # ------------------------------------------------ SNMGP (whitened)
    if "snmgp" not in chols:
        chols["snmgp"] = ld.snmgp_whiten_chols(x, h["alpha_tilde_l"], h["beta_tilde_l"],
                                               h["alpha_tilde_sigma"], h["beta_tilde_sigma"])
    chol_l, chol_s = (c.to(x.dtype) for c in chols["snmgp"])

    def snmgp_log_prior(q):
        return _std_normal(q[:, :2 * N]) + _ul_prior(q[:, 2 * N:2 * N + T]) + _s2e_prior(q)

    def snmgp_log_like(q):
        p = ld.snmgp_unwhiten(q, x, h["mu_tilde_l"], h["mu_tilde_sigma"], chol_l, chol_s, M)
        K_x = nonstationary_rbf(x, sigma1=torch.exp(p.tilde_sigma),
                                ell1=torch.exp(p.tilde_l)) + 1e-6 * eye_n
        return mvn_logpdf_kron(y, zero, b_f(p.uL_vec), K_x, torch.exp(p.tilde_sigma2_err))

    def snmgp_prior_sampler(gen, n):
        eta = _randn(gen, (n, 2 * N), x)
        uL = C_UL * _randn(gen, (n, T), x) * 0.1
        return torch.cat([eta, uL, _log_inv_gamma_draws(gen, n, x)], dim=1)

    # ------------------------------------------------ SVC / GNMGP (whitened)
    # every GP block whitened by its prior Cholesky (svc_unwhiten): N(0, I)
    # on the etas, inverse gamma through the log on sigma^2
    if "svc" not in chols:
        chols["svc"] = ld.svc_whiten_chols(x, h["alpha_tilde_l"], h["beta_tilde_l"], 1.0, 1.0)
    chol_l_svc, chol_L_svc = (c.to(x.dtype) for c in chols["svc"])
    dim_svc = N + N * T + 1
    eye_nm = torch.eye(N * M, dtype=x.dtype, device=x.device)

    def svc_log_prior(q):
        return _std_normal(q[:, :-1]) + _s2e_prior(q)

    def svc_log_like(q):
        p = ld.svc_unwhiten(q, x, h["mu_tilde_l"], 0.0, chol_l_svc, chol_L_svc, M)
        K, _ = ld.svc_covariance(p.tilde_l, p.uL_vecs, x)
        S = K + torch.exp(p.tilde_sigma2_err)[:, None, None] * eye_nm
        return mvn_logpdf_dense(y, zero, S)

    def svc_prior_sampler(gen, n):
        eta = _randn(gen, (n, dim_svc - 1), x)
        return torch.cat([eta, _log_inv_gamma_draws(gen, n, x)], dim=1)

    return {
        "lmc": Model(lmc_log_prior, lmc_log_like, lmc_prior_sampler, 2 + T + 1, None),
        "snmgp": Model(snmgp_log_prior, snmgp_log_like, snmgp_prior_sampler, 2 * N + T + 1,
                       (chol_l, chol_s)),
        "svc": Model(svc_log_prior, svc_log_like, svc_prior_sampler, dim_svc,
                     (chol_l_svc, chol_L_svc)),
    }


def run(args, device=None, dtype=DEFAULT_DTYPE) -> dict:
    """The comparison of `args` (a Namespace of `parse_args`, or its argv
    list): the JSON dict of the JAX script, and under "betas" each model's
    inverse temperatures (a list, not in the JAX output)."""
    if not isinstance(args, argparse.Namespace):
        args = parse_args(args)
    dev = resolve_device("cpu" if args.cpu and device is None else device)
    # dense-Cholesky likelihoods: float32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    x_np, _, _, _, Y_np = sim_mnts(M=2, N=args.N, seed=0)
    x = torch.as_tensor(x_np, dtype=dtype, device=dev)
    Y = torch.as_tensor(Y_np, dtype=dtype, device=dev)
    models = make_models(x, Y)
    P = args.particles
    results, betas = {}, {}
    for name in MODELS:
        m = models[name]
        s_init, s_smc = SEEDS[name]
        t0 = time.perf_counter()
        init = m.prior_sampler(torch.Generator(device=dev).manual_seed(s_init), P)
        # the script prints each stage above 512 particles (its staged run)
        _, info = run_smc_staged(m.log_prior, m.log_like, init,
                                 torch.Generator(device=dev).manual_seed(s_smc),
                                 num_mutations=args.mutations, num_leapfrog=NUM_LEAPFROG,
                                 progress=P > 512)
        results[name] = dict(log_z=float(info["log_z"]), stages=info["num_stages"],
                             wall_s=time.perf_counter() - t0)  # the float() waits for the card
        betas[name] = [float(b) for b in info["betas"]]
    results["log_bayes_factor_snmgp_vs_lmc"] = results["snmgp"]["log_z"] - results["lmc"]["log_z"]
    results["log_bayes_factor_svc_vs_lmc"] = results["svc"]["log_z"] - results["lmc"]["log_z"]
    results["best_model"] = max(MODELS, key=lambda n: results[n]["log_z"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f)
    return {**results, "betas": betas}


def main(argv: Optional[list] = None) -> None:
    out = run(argv)
    out.pop("betas")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
