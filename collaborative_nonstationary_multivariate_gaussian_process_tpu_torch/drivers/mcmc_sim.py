"""Fully-Bayesian synthetic-truth recovery: NUTS, HMC or ChEES-HMC on the
SVC density (the JAX package's `scripts/run_mcmc_sim.py`).

Generates the nonstationary 2-output series with known truth
(`utils.sim.sim_mnts`: tilde_l = 3(x-1)^3 - 3, stds 1+x^2 / 2-x^2,
correlation cos(pi x)), starts from the empirical variogram fit, samples
the whitened (default) or centered SVC posterior, and reports the recovery
of the lengthscale and correlation processes, R-hat, ESS and rates as one
JSON line with the JAX script's keys.

    python -m collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers.mcmc_sim \\
        [--N 100] [--chains 4] [--warmup 400] [--samples 400] [--sampler nuts|hmc|chees] [--cpu]

Runs on the card unless `--cpu` is given.  The JAX script's
`--segment-iters` (its TPU worker's dispatch budget) has no counterpart.
`--plots-dir` (matplotlib needed) writes the true-vs-inferred overlays of
the lengthscale and correlation processes.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device
from ..infer.chees import chees_sample, chees_warmup
from ..infer.hmc import run_hmc
from ..infer.nuts import run_nuts
from ..models import logdensities as ld
from ..ops.linalg import lvec_to_uvec
from ..parallel.sharded_mcmc import effective_sample_size, potential_scale_reduction
from ..utils.empirical import local_estimation, smooth
from ..utils.posterior_analysis import lvecs_to_corr, samples2quantiles
from ..utils.sim import sim_mnts
from ..utils.visualization import _plt, plot_process_overlay

__all__ = ["HYPERS", "CHEES_CHUNK", "parse_args", "Study", "svc_problem", "svc_density",
           "centered_draws", "recovery_bands", "recovery", "run_study", "run", "main"]

# the hyperparameters of the reference's simulation study (sim.py:208)
HYPERS = dict(mu_tilde_l=-3.0, alpha_tilde_l=3.0, beta_tilde_l=0.4, mu_L=0.0, alpha_L=5.0,
              beta_L=1.0, a=1.0, b=1.0)
# ChEES draws are taken in calls of this many, the Halton offset advancing
CHEES_CHUNK = 100


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Not ported: the JAX script's --segment-iters (its TPU worker's dispatch budget).")
    p.add_argument("--N", type=int, default=100)
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--warmup", type=int, default=400)
    p.add_argument("--samples", type=int, default=400)
    p.add_argument("--max-depth", type=int, default=8)
    p.add_argument("--sampler", choices=["nuts", "hmc", "chees"], default="nuts")
    p.add_argument("--dense-mass", action="store_true",
                   help="adapt a dense mass matrix during NUTS warmup")
    p.add_argument("--centered", action="store_true",
                   help="use the centered parameterization (default: whitened)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--plots-dir", default=None,
                   help="write true-vs-inferred overlay PNGs of the lengthscale/correlation "
                        "processes here (reference synthetic_plot.py:101-142)")
    p.add_argument("--steady", action="store_true",
                   help="run the sampler twice and report the second run's samples/s")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    return p.parse_args(argv)


class Study(NamedTuple):
    """What a run keeps beside its JSON: the start, the draws, the density."""

    inits: torch.Tensor  # (C, dim)
    samples: torch.Tensor  # (C, S, dim), in the sampled space
    info: dict
    problem: dict  # `svc_density`'s: the data, `lp`, the whitening factors


def svc_problem(N: int, seed: int = 0) -> dict:
    """The data, the truth and the empirical init of the study
    (run_mcmc_sim.py:99-111), as NumPy arrays in a dict."""
    M = 2
    T = ld.tri_size(M)
    x, true_l, true_L_vecs, true_s2e, Y = sim_mnts(M=M, N=N, seed=seed)
    est = local_estimation(x, Y, window_size=max(N // 6, 10))
    init_tilde_l = np.log(smooth(est["ls"], 10))
    init_uL = lvec_to_uvec(torch.as_tensor(smooth(est["L_vecs"], 10)), M).numpy().reshape(-1)
    return dict(x=x, Y=Y, true_l=true_l, true_L_vecs=true_L_vecs, true_s2e=true_s2e, N=N, M=M, T=T,
                init_tilde_l=init_tilde_l, init_uL=init_uL)


def svc_density(prob: dict, device, dtype=DEFAULT_DTYPE, centered: bool = False,
                chols=None) -> dict:
    """The study's log-posterior in `dtype` on `device` (run_mcmc_sim.py:
    121-154): `prob` and `lp` (C, dim) -> (C,), `init` (NumPy, in the
    sampled space), `centered`, and, whitened, the factors `chol_l`,
    `chol_L`: computed (rbf and cholesky), or `chols` cast to `dtype` (a
    comparison across dtypes shares one pair)."""
    N, T, h = prob["N"], prob["T"], HYPERS
    xt = torch.as_tensor(prob["x"], dtype=dtype, device=device)
    Yt = torch.as_tensor(prob["Y"], dtype=dtype, device=device)
    s2e = [np.log(prob["true_s2e"])]
    if centered:
        return dict(prob, centered=True, init=np.concatenate([prob["init_tilde_l"], prob["init_uL"], s2e]),
                    lp=lambda q: ld.svc_log_posterior(q, Yt, xt, **h))
    if chols is None:
        chols = ld.svc_whiten_chols(xt, h["alpha_tilde_l"], h["beta_tilde_l"], h["alpha_L"],
                                    h["beta_L"])
    chol_l, chol_L = (c.to(dtype) for c in chols)
    cl, cL = chol_l.double().cpu(), chol_L.double().cpu()
    eta_l = torch.linalg.solve_triangular(
        cl, torch.as_tensor(prob["init_tilde_l"] - h["mu_tilde_l"])[:, None], upper=False)[:, 0]
    eta_U = torch.linalg.solve_triangular(
        cL, torch.as_tensor(prob["init_uL"].reshape(N, T) - h["mu_L"]), upper=False)

    def lp(q):
        return ld.svc_log_posterior_whitened(q, Yt, xt, chol_l, chol_L, mu_tilde_l=h["mu_tilde_l"],
                                             mu_L=h["mu_L"], a=h["a"], b=h["b"])

    return dict(prob, centered=False, chol_l=chol_l, chol_L=chol_L, lp=lp,
                init=np.concatenate([eta_l.numpy(), eta_U.numpy().reshape(-1), s2e]))


def centered_draws(prob: dict, samples: np.ndarray) -> np.ndarray:
    """Draws (..., dim) of the sampled space of `svc_density`'s `prob` as
    centered SVC parameters [tilde_l, uL_vecs, tilde_s2e]
    (run_mcmc_sim.py:245-252)."""
    if prob["centered"]:
        return samples
    N, T, h = prob["N"], prob["T"], HYPERS
    dim = samples.shape[-1]
    flat = samples.reshape(-1, dim)
    tl = h["mu_tilde_l"] + flat[:, :N] @ prob["chol_l"].double().cpu().numpy().T
    U = h["mu_L"] + np.einsum("nk,skt->snt", prob["chol_L"].double().cpu().numpy(),
                              flat[:, N:N + N * T].reshape(-1, N, T))
    flat = np.concatenate([tl, U.reshape(-1, N * T), flat[:, -1:]], axis=1)
    return flat.reshape(samples.shape)


def recovery_bands(prob: dict, samples: np.ndarray):
    """(true tilde_l, its 2.5/50/97.5% draw quantiles (3, N), true
    correlation, its quantiles) from draws (C, S, dim)."""
    N, M, T = prob["N"], prob["M"], prob["T"]
    pooled = centered_draws(prob, samples).reshape(-1, samples.shape[-1])
    true_tl = np.log(prob["true_l"])
    true_corr = lvecs_to_corr(prob["true_L_vecs"], N, M, constrained=True)[:, 0, 1]
    tl_q = samples2quantiles(pooled[:, :N])
    corr_q = samples2quantiles(lvecs_to_corr(pooled[:, N:N + N * T], N, M)[:, :, 0, 1])
    return true_tl, tl_q, true_corr, corr_q


def recovery(prob: dict, samples: np.ndarray) -> dict:
    """tilde_l and correlation RMSE and coverage against the truth from
    draws (C, S, dim) (run_mcmc_sim.py:253-265)."""
    true_tl, tl_q, true_corr, corr_q = recovery_bands(prob, samples)
    return dict(
        rmse_tilde_l=float(np.sqrt(np.mean((tl_q[1] - true_tl) ** 2))),
        rmse_corr=float(np.sqrt(np.mean((corr_q[1] - true_corr) ** 2))),
        coverage_tilde_l=float(np.mean((true_tl > tl_q[0]) & (true_tl < tl_q[2]))),
        coverage_corr=float(np.mean((true_corr > corr_q[0]) & (true_corr < corr_q[2]))),
    )


def _chees(lp, inits, gen, args, progress):
    """chees_warmup, then the draws streamed by chees_sample in calls of
    CHEES_CHUNK with advancing Halton offsets (run_mcmc_sim.py:176-213)."""
    st, tuning, winfo = chees_warmup(lp, inits, gen, num_warmup=args.warmup, progress=progress)
    off = winfo["halton_offset"]
    chunks, aps, nsteps = [], [], []
    reads, leapfrogs = winfo["host_reads"], winfo["leapfrogs"]
    done = 0
    while done < args.samples:
        n = min(CHEES_CHUNK, args.samples - done)
        st, pos, cinfo = chees_sample(lp, st, tuning, gen, n, halton_offset=off + done,
                                      progress=progress)
        chunks.append(pos)
        aps.append(cinfo["accept_prob"])
        nsteps.append(cinfo["num_steps"])
        reads += cinfo["host_reads"]
        leapfrogs += cinfo["leapfrogs"]
        done += n
    info = {"accept_prob": torch.cat(aps, 1), "num_steps": torch.cat(nsteps),
            "step_size": tuning.step_size, "trajectory_length": torch.exp(tuning.log_traj_length),
            "inv_mass": tuning.inv_mass, "warmup_accept_mean": winfo["warmup_accept_mean"],
            "warmup_leapfrogs": winfo["leapfrogs"], "host_reads": reads, "leapfrogs": leapfrogs}
    return torch.cat(chunks, 1), info


def _sample(args, prob, inits, gen, progress=None):
    lp = prob["lp"]
    if args.sampler == "chees":
        return _chees(lp, inits, gen, args, progress)
    if args.sampler == "nuts":
        return run_nuts(lp, inits, gen, num_warmup=args.warmup, num_samples=args.samples,
                        max_depth=args.max_depth, dense_mass=args.dense_mass, progress=progress)
    return run_hmc(lp, inits, gen, num_warmup=args.warmup, num_samples=args.samples, num_steps=32)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_study(args, device=None, dtype=DEFAULT_DTYPE, progress=None):
    """The study of `args` (a Namespace of `parse_args`, or its argv list);
    `progress(phase, i)` is called after each NUTS or ChEES iteration.
    Returns (the JSON dict, `Study`)."""
    if not isinstance(args, argparse.Namespace):
        args = parse_args(args)
    if args.plots_dir:
        _plt()  # the figures need matplotlib: fail before sampling, not after
    dev = resolve_device("cpu" if args.cpu and device is None else device)
    # dense-Cholesky MCMC is precision-sensitive: no TF32 in its products
    torch.backends.cuda.matmul.allow_tf32 = False
    prob = svc_density(svc_problem(args.N, args.seed), dev, dtype, centered=args.centered)
    dim = prob["init"].shape[0]
    init = torch.as_tensor(prob["init"], dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    noise = torch.randn(args.chains, dim, generator=gen, dtype=dtype, device=dev)
    if args.sampler == "chees" and not args.centered:
        # ChEES adapts from cross-chain variance, which near-identical
        # starts degenerate: an overdispersed start in the whitened space
        # (eta ~ N(0, I)), the sigma^2 init kept
        inits = 0.5 * noise
        inits[:, -1] = init[-1]
    else:
        inits = init[None, :] + 0.01 * noise
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    t0 = time.perf_counter()
    samples, info = _sample(args, prob, inits, gen, progress)
    _sync(dev)
    wall = time.perf_counter() - t0
    total_draws = args.chains * args.samples
    steady_rate = None
    if args.steady:
        gen2 = torch.Generator(device=dev).manual_seed(args.seed + 2)
        t0 = time.perf_counter()
        _sample(args, prob, inits, gen2)
        _sync(dev)
        steady_rate = total_draws / (time.perf_counter() - t0)

    draws = samples.double().cpu()
    rhat = potential_scale_reduction(draws).numpy()
    ess = effective_sample_size(draws).numpy()
    out = dict(
        sampler=args.sampler, N=args.N, chains=args.chains, draws=total_draws, wall_s=wall,
        samples_per_s=total_draws / wall, **recovery(prob, draws.numpy()),
        rhat_max=float(rhat.max()), rhat_median=float(np.median(rhat)),
        mean_accept=float(info["accept_prob"].double().mean()),
        ess_median=float(np.median(ess)), ess_min=float(ess.min()),
        ess_per_s=float(np.median(ess) / wall),
    )
    if steady_rate is not None:
        out["steady_samples_per_s"] = steady_rate
        out["steady_ess_per_s"] = float(np.median(ess) / (total_draws / steady_rate))
    if args.plots_dir:
        true_tl, tl_q, true_corr, corr_q = recovery_bands(prob, draws.numpy())
        for name, ylabel, true, q in (("log_lengthscale", "log lengthscale", true_tl, tl_q),
                                      ("correlation", "correlation", true_corr, corr_q)):
            plot_process_overlay(prob["x"], true, q[1], quantiles=q[[0, 2]], ylabel=ylabel,
                                 save_path=os.path.join(args.plots_dir,
                                                        f"nuts_recovery_{name}_N{args.N}.png"))
        out["plots"] = sorted(os.listdir(args.plots_dir))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return out, Study(inits, samples, info, prob)


def run(args, device=None) -> dict:
    """The study's JSON dict (the JAX script's keys)."""
    return run_study(args, device)[0]


def main(argv: Optional[list] = None) -> None:
    print(json.dumps(run(argv)))


if __name__ == "__main__":
    main()
