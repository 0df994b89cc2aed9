#!/usr/bin/env python3
"""How often the port's NUTS leaves a chain behind when it starts at the
empirical init of `scripts/run_mcmc_sim.py`'s default study, on one CUDA card.

    python3 svc_init_study.py [--chains 16] [--warmup 100] [--samples 100] [--seed 1]

The SVC NUTS phase of `chip_smoke.py` (sim_mnts M=2, N=100; the whitened SVC
density, dim 401; max depth 8, diagonal mass) without its MAP start: every
chain starts at the empirical init plus 0.01 N(0, I), as run_mcmc_sim.py:167
spreads it, and the chains run in lockstep, each with its own step size and
mass.  Prints one JSON line: per chain the final step size and the mean
log-posterior of its draws; per group of four chains (the study's count)
R-hat max and the recovery RMSEs of the lengthscale and correlation
processes.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("svc_init_study: no CUDA device is available", file=sys.stderr)
        return 2
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import mcmc_sim
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.nuts import run_nuts
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.sharded_mcmc import (
        potential_scale_reduction,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ck.build()
    dens = mcmc_sim.svc_density(mcmc_sim.svc_problem(cs.FB_N), dev, torch.float32)
    lp = dens["lp"]
    init = torch.as_tensor(dens["init"], dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    q0 = init[None] + 0.01 * torch.randn(args.chains, init.shape[0], device=dev, generator=gen)
    t0 = time.perf_counter()
    samples, info = run_nuts(lp, q0, gen, num_warmup=args.warmup, num_samples=args.samples,
                             max_depth=cs.FB_DEPTH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    draws = samples.double().cpu()
    groups = []
    for g in range(args.chains // 4):
        part = draws[4 * g:4 * g + 4]
        rec = mcmc_sim.recovery(dens, part.numpy())
        groups.append(dict(rhat_max=float(potential_scale_reduction(part).max()),
                           rmse_tilde_l=rec["rmse_tilde_l"], rmse_corr=rec["rmse_corr"]))
    print(json.dumps(dict(
        chains=args.chains, warmup=args.warmup, samples=args.samples, seed=args.seed, wall_s=wall,
        finite=bool(torch.isfinite(samples).all()),
        step_size=[round(float(e), 5) for e in info["step_size"]],
        lp_mean=[round(float(v), 2) for v in info["log_prob"].mean(1)],
        groups_of_4=groups, card=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
