"""Simulation parity harness: the reference's NMGP_SIM experiment (the JAX
package's `scripts/sim_parity.py`).

Reference protocol (code/notebook/NMGP_SIM.ipynb cells 1-7): M=20 inducing
points, full batch, lr=0.005, 2000 epochs, length-scale logs frozen at
{tildeell: 0, L0: 2, L1: 2}, sigma2 logs {tildeell: 0, L0: 0, L1: 0},
sigma2_err_log=-2; then 1000 posterior draws on the test points and the
RMSE / 95%-CI length / coverage (nmgp_dsvi.py:1050-1068).  Prints one JSON
line a seed and a summary line.

    python -m collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers.sim_parity \\
        [--data sim_illustration_low_freq] [--data-path PICKLE] [--seeds 0 1] [--itnum 2000] \\
        [--plots-dir DIR] [--x64] [--cpu]

The data is `utils.sim.<data>(seed=22)`, the generator of the reference's
shipped pickle, or the `[X, Y, Xt, Yt]` pickle at `--data-path`.  Runs on
the card unless `--cpu` is given, in float32 (the kernels) or, with
`--x64`, float64 (the plain versions).  `--plots-dir` (matplotlib needed)
writes the first seed's posterior bands.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_DTYPE
from ..infer.dsvi import inference
from ..models.predict import sample_Y
from ..utils import sim
from ..utils.data import load_sim_pickle
from ..utils.metrics import predictive_summary
from ..utils.visualization import _plt, plot_posterior, samples2quantiles

__all__ = ["HYPERPARS", "DATASETS", "N_SAMPLE", "parse_args", "load_data", "run_seed", "run",
           "main"]

HYPERPARS = {
    "sigma2_L0_log": 0, "length_scales_L0_log": 2,
    "sigma2_L1_log": 0, "length_scales_L1_log": 2,
    "sigma2_tildeell_log": 0, "length_scales_tildeell_log": 0,
    "sigma2_err_log": -2,
}
DATASETS = ("sim_illustration_low_freq", "sim_illustration_high_freq",
            "sim_illustration_varying_freq")
# posterior draws on the test points (nmgp_dsvi.py:1050-1068), fixed as in
# the JAX script
N_SAMPLE = 1000


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", default="sim_illustration_low_freq", choices=DATASETS)
    p.add_argument("--data-path", default=None,
                   help="an [X, Y, Xt, Yt] pickle to fit instead of the generated data")
    p.add_argument("--M", type=int, default=20)
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--itnum", type=int, default=2000)
    p.add_argument("--kl-mode", default="true", choices=["true", "ref_compat"],
                   help="ref_compat reproduces the reference's KL quirk "
                        "(see ops/linalg.kl_gaussian_ref_compat)")
    p.add_argument("--out", default=None)
    p.add_argument("--plots-dir", default=None,
                   help="write posterior-band PNGs for the FIRST seed")
    p.add_argument("--x64", action="store_true", help="float64 (the plain versions on the card)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    return p.parse_args(argv)


def load_data(name: str, data_path: Optional[str] = None):
    """(X_list, Y_list, Xt_list, Yt_list): the pickle at `data_path`, else
    `utils.sim.<name>(seed=22)`."""
    if data_path:
        return load_sim_pickle(data_path)
    return getattr(sim, name)(seed=22)


def run_seed(data, M, seed, itnum=2000, lr=0.005, n_sample=N_SAMPLE, kl_mode="true",
             plots_dir=None, label="sim", device=None, dtype=DEFAULT_DTYPE):
    """One fit of `data` (X_list, Y_list, Xt_list, Yt_list) by the protocol
    and its test metrics.  Returns (dict(seed, rmse, ci_length, coverage,
    elbo_trace), the `DSVIResult`)."""
    X_list, Y_list, Xt_list, Yt_list = data
    D = len(X_list)
    res = inference(X_list, Y_list, np.linspace(0, 1, M), batch_size=0, dim_outputs=D, lr=lr,
                    itnum=itnum, hyperpars=HYPERPARS, fix_hyperpars=True, seed=seed,
                    show_ELBO=True, elbo_every=100, kl_mode=kl_mode, dtype=dtype, device=device)
    ys_test = sample_Y(res.params, res.Z, Xt_list, n_sample=n_sample, seed=seed, kl_mode=kl_mode,
                       device=device)[0].cpu().numpy()
    y_test = np.concatenate([np.asarray(y).reshape(-1) for y in Yt_list])
    test_index = np.concatenate(
        [np.full(len(np.asarray(x).reshape(-1)), d) for d, x in enumerate(Xt_list)])
    r, length, cov = predictive_summary(ys_test, y_test, test_index=test_index, dim_outputs=D)
    if plots_dir:
        # per-output posterior predictive bands on a 200-grid with the train
        # scatter (reference Plot_posterior / nmgp_dsvi.py driver figures)
        grids = np.linspace(0, 1, 200)
        ys_g = sample_Y(res.params, res.Z, [grids] * D, n_sample=n_sample, seed=seed,
                        kl_mode=kl_mode, device=device)[0].cpu().numpy()
        pos = ys_g.reshape(ys_g.shape[0], D, 200).transpose(2, 0, 1)  # (200, S, D)
        x_tr = np.ravel(np.asarray(X_list[0]))
        Y_tr = np.stack([np.ravel(np.asarray(y)) for y in Y_list], axis=1)
        plot_posterior(x_tr, Y_tr, grids, samples2quantiles(pos), save_dir=plots_dir,
                       attributes=[f"{label}_y{d + 1}_seed{seed}" for d in range(D)],
                       type=f"DSVI_{kl_mode}")
    return dict(seed=seed, rmse=r, ci_length=length, coverage=float(np.mean(cov)),
                elbo_trace=res.elbo_trace), res


def run(argv=None) -> dict:
    """Every seed of the protocol: {"summary": ..., "results": [...]} (the
    JAX script's `--out` file)."""
    a = argv if isinstance(argv, argparse.Namespace) else parse_args(argv)
    if a.plots_dir:
        _plt()  # the figures need matplotlib: fail before training, not after
    data = load_data(a.data, a.data_path)
    device = "cpu" if a.cpu else None
    dtype = torch.float64 if a.x64 else DEFAULT_DTYPE
    results = []
    for s in a.seeds:
        t0 = time.time()
        r, _ = run_seed(data, a.M, s, itnum=a.itnum, n_sample=N_SAMPLE, kl_mode=a.kl_mode,
                        plots_dir=a.plots_dir if s == a.seeds[0] else None, label=a.data,
                        device=device, dtype=dtype)
        r["wallclock_s"] = time.time() - t0
        print(json.dumps({k: v for k, v in r.items() if k != "elbo_trace"}))
        print("  elbo_trace tail:", r["elbo_trace"][-3:])
        results.append(r)
    rmses = np.array([r["rmse"] for r in results])
    lens = np.array([r["ci_length"] for r in results])
    covs = np.array([r["coverage"] for r in results])
    summary = dict(data=a.data, M=a.M, kl_mode=a.kl_mode, n_seeds=len(results),
                   rmse_mean=float(rmses.mean()), rmse_std=float(rmses.std()),
                   ci_mean=float(lens.mean()), cov_mean=float(covs.mean()))
    out = {"summary": summary, "results": results}
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f)
    return out


def main(argv: Optional[list] = None) -> None:
    print(json.dumps(run(argv)["summary"]))


if __name__ == "__main__":
    main()
