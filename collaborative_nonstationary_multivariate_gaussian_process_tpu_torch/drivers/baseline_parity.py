"""Baseline parity table (the JAX package's `scripts/baseline_parity.py`).

Fits the IGPR and ICM baselines (`models/baselines.py`) to the three
simulation datasets under the reference's notebook protocol
(code/notebook/IGPR.ipynb cell 1, ICM.ipynb cell 1):

  - IGPR: independent exact GPR per output, Exponential kernel, ML-II
    (2000 Adam steps at lr 0.02)
  - ICM : GPCoregionalizedRegression equivalent, Exponential kernel,
    rank-1 B + kappa, shared input kernel, ML-II (3000 steps at lr 0.02)
  - metrics: test RMSE over stacked outputs; mean 95% CI length
    (quantiles 2.5/97.5 of the predictive incl. noise); empirical coverage

and prints each row beside the reference's GPy numbers (BASELINE.md).  The
data is `utils.sim.sim_illustration_*(seed=22)`, the generator of the
reference's shipped pickles, or those pickles from `--data-dir`; the GPy
numbers are of the shipped pickles.

    python -m collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers.baseline_parity \\
        [--data-dir DIR] [--out FILE] [--x64] [--cpu]

Runs on the card unless `--cpu` is given, in float32 (the Cholesky kernel)
or, with `--x64`, float64 (the plain versions), as the JAX script always
does.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_DTYPE
from ..models.baselines import fit_icm, fit_igpr, predict_icm, predict_igpr
from ..utils import sim
from ..utils.data import load_sim_pickle

__all__ = ["DATASETS", "REFERENCE", "IGPR_STEPS", "ICM_STEPS", "metrics", "parse_args",
           "run_fits", "run", "main"]

DATASETS = {
    "low_freq": "sim_illustration_low_freq",
    "high_freq": "sim_illustration_high_freq",
    "varying_freq": "sim_illustration_varying_freq",
}

# The notebooks' Adam steps (at lr 0.02), fixed as in the JAX script
IGPR_STEPS, ICM_STEPS = 2000, 3000

# GPy numbers from the reference's committed notebook outputs (BASELINE.md):
# (rmse, ci_length, coverage)
REFERENCE = {
    ("low_freq", "IGPR"): (2.247, 2.178, 0.835),
    ("low_freq", "ICM"): (2.263, 2.179, 0.835),
    ("high_freq", "IGPR"): (1.507, 3.170, 0.915),
    ("high_freq", "ICM"): (1.520, 3.169, 0.910),
    ("varying_freq", "IGPR"): (1.640, 3.185, 0.875),
    ("varying_freq", "ICM"): (1.660, 3.164, 0.880),
}


def metrics(means, stds, Yt_list):
    """(rmse, mean 95% interval length, coverage) of Gaussian predictives."""
    mu = np.concatenate([np.asarray(m).reshape(-1) for m in means])
    sd = np.concatenate([np.asarray(s).reshape(-1) for s in stds])
    yt = np.concatenate([np.asarray(y).reshape(-1) for y in Yt_list])
    lo, hi = mu - 1.959963984540054 * sd, mu + 1.959963984540054 * sd
    rmse = float(np.sqrt(np.mean((mu - yt) ** 2)))
    length = float(np.mean(hi - lo))
    coverage = float(np.mean((yt >= lo) & (yt <= hi)))
    return rmse, length, coverage


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-dir", default=None,
                   help="a directory with the reference's sim_illustration_*.pickle files")
    p.add_argument("--out", default=None, help="write the rows here as JSON")
    p.add_argument("--x64", action="store_true", help="float64 (the plain versions on the card)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    return p.parse_args(argv)


def _dataset(name, data_dir):
    if data_dir:
        return load_sim_pickle(os.path.join(data_dir, f"{DATASETS[name]}.pickle"))
    return getattr(sim, DATASETS[name])(seed=22)


def run_fits(argv=None):
    """The six rows (dataset, model, rmse, ci_length, coverage and the GPy
    reference's three), printed as they come, and the fitted models by
    (dataset, model)."""
    a = argv if isinstance(argv, argparse.Namespace) else parse_args(argv)
    kw = dict(device="cpu" if a.cpu else None, dtype=torch.float64 if a.x64 else DEFAULT_DTYPE)
    rows, fits = [], {}
    for name in DATASETS:
        X_list, Y_list, Xt_list, Yt_list = _dataset(name, a.data_dir)
        fits[(name, "IGPR")] = fit_igpr(X_list, Y_list, kernel="exponential", steps=IGPR_STEPS,
                                        lr=0.02, **kw)
        fits[(name, "ICM")] = fit_icm(X_list, Y_list, rank=1, kernel="exponential",
                                      steps=ICM_STEPS, lr=0.02, **kw)
        for model, predict in (("IGPR", predict_igpr), ("ICM", predict_icm)):
            rmse, length, cov = metrics(*predict(fits[(name, model)], Xt_list), Yt_list)
            ref = REFERENCE[(name, model)]
            rows.append({"dataset": name, "model": model, "rmse": rmse, "ci_length": length,
                         "coverage": cov, "ref_rmse": ref[0], "ref_ci_length": ref[1],
                         "ref_coverage": ref[2]})
            print(rows[-1], flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=2)
    return rows, fits


def run(argv=None) -> list:
    """The six rows of `run_fits`."""
    return run_fits(argv)[0]


def main(argv: Optional[list] = None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
