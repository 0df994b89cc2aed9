"""Fix the ChEES tuning of the SVC cells once, on the card.

    python3 -m portbench.tools.chees_tuning --out portbench/traffic/svc_chees_tuning.json \\
        [--config portbench/configs/svc-sim-n100.json] [--chains 4] [--warmup 400] [--seed 0]

Runs the port's `chees_warmup` on the configuration's whitened SVC density
from the study's overdispersed start (eta ~ N(0, 0.25 I), log s2e at the
data's value; `drivers/mcmc_sim.run_study`), `--warmup` iterations and the
re-adaptation after them, and writes the adapted step size, log trajectory
length and diagonal inverse mass, the chains' final positions (where the
cells start), the Halton offset sampling resumes at, and the command, seed
and card that made them.
"""

from __future__ import annotations

import argparse
import json
import math
import shlex
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench.kinds import chees_sample


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--config", default="portbench/configs/svc-sim-n100.json")
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--warmup", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    chees, hmc, _ = chees_sample._port()
    cfg = json.loads(Path(args.config).read_text())
    dev = torch.device("cuda")
    lp = chees_sample.port_density(cfg, dev)
    dim = 4 * cfg["N"] + 1
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    inits = 0.5 * torch.randn(args.chains, dim, generator=gen, device=dev)
    inits[:, -1] = math.log(cfg["sigma2_err"])
    t0 = time.perf_counter()
    state, tuning, info = chees.chees_warmup(lp, inits, gen, num_warmup=args.warmup)
    torch.cuda.synchronize()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = dict(
        command="python3 -m portbench.tools.chees_tuning " + shlex.join(sys.argv[1:]),
        seed=args.seed, chains=args.chains, num_warmup=args.warmup, card=card,
        warmup_s=time.perf_counter() - t0, warmup_leapfrogs=int(info["leapfrogs"]),
        warmup_accept_mean=float(info["warmup_accept_mean"]),
        halton_offset=int(info["halton_offset"]),
        step_size=float(tuning.step_size), log_traj_length=float(tuning.log_traj_length),
        inv_mass=[float(v) for v in tuning.inv_mass.cpu()],
        final_log_prob=[float(v) for v in state.log_prob.cpu()],
        positions=[[float(v) for v in row] for row in state.position.cpu()],
    )
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: v for k, v in out.items() if k not in ("inv_mass", "positions")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
