"""Readings that a cell's check limits are set from, on the card.

    python3 -m portbench.tools.calibrate --workload <cell> --seeds S1 S2 ... \\
        [--seconds 8] [--controls 3] [--out chiprun_out/calibrate.jsonl]

For each seed, in one process: the cell's set-up and a window of
`--seconds`, then every number its check can compare (the port against
the float64 reference), as `cell.check` computes them.  For the first
`--controls` seeds also the same numbers with the plain reference in
float32 ("f32", a witness of float32's own rounding) and in float32 with
TF32 products ("tf32", the control: the precision below the configuration's)
in the port's place.  One JSON line a seed and reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import run


def readings(workload, seeds, seconds, controls, device="cuda", root=run.ROOT,
             kinds=("f32", "tf32")):
    """Yield one dict a seed and reading."""
    spec = run.cell_spec(run.benchmark(root), workload, root)
    kind = run.kind_module(spec["traffic"])
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        cell = kind.Cell(spec["config"], spec["traffic"], spec["limits"], seed,
                         torch.device(device), root=root)
        cell.setup()
        wall, records, _ = run.run_window(cell, seconds, False)
        summary = cell.summarize(records, wall)
        cell.release()
        t1 = time.perf_counter()
        nums = cell.numbers_of_port()
        yield dict(workload=workload, seed=seed, reading="port", units=len(records),
                   metrics=summary["metrics"], numbers=nums, run_s=t1 - t0,
                   check_s=time.perf_counter() - t1)
        if i < controls:
            for reading in kinds:
                yield dict(workload=workload, seed=seed, reading=reading,
                           numbers=cell.control(reading))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--readings", nargs="+", default=["f32", "tf32"],
                   help="what stands in for the port: f32, tf32, or a kind's planted fault")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    run.set_caches()
    out = open(args.out, "a") if args.out else None
    try:
        for r in readings(args.workload, args.seeds, args.seconds, args.controls,
                          kinds=args.readings):
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
