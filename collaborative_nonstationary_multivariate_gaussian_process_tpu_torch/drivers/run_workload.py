"""Real-data workload driver: PM2.5 / HCP / ECoG (the JAX package's
`scripts/run_workload.py`).

Replaces the reference's per-dataset driver scripts (NMGP_PM25.py,
NMGP_HCP.py, NMGP_ECoG_full.py, NMGP_ECoG_pred.py) with one command.
Per-workload configurations follow the reference:

  pm25: M=100, B in {1000,2000,5000}, lr=0.01, hyperpars ls_*=10, mu_v=1
  hcp:  M=100, B in {1000,2000,5000}, lr=0.01, itnum=50, hyperpars ls_*=5
  ecog: M in {25,50,100,200}, B=512, lr=0.005,
        hyperpars {ls_L0:10, ls_L1:10, ls_te:5, s2e_log:-5}

Trains by DSVI (`infer.dsvi.inference`), scores the held-out points by
`sample_Y` and, with `--spatial-analysis` (ECoG), computes the
electrode-grid correlation curves of the posterior-mean correlation
process from `sample_FY`; prints one JSON line with the JAX script's keys.
Raw data is private (not shipped with the reference either); pass
`--data-path` to a raw notebook input or a pre-split pickle, else a
same-shape synthetic surrogate is used.

    python -m collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers.run_workload \\
        {pm25,hcp,ecog} [--full] [--spatial-analysis] [--out FILE] [--cpu]

Runs on the card unless `--cpu` is given.  With `--spatial-analysis` and
`--out`, the two figures of the analysis are written beside the JSON file
(matplotlib needed); without `--out` none is (the JAX script then writes
into its `results/`).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..infer.dsvi import inference
from ..models import cnmgp
from ..models.predict import DRAWS_PER_CHUNK, sample_FY, sample_Y
from ..utils import etl
from ..utils.checkpoint import LAST_IO_SECONDS
from ..utils.metrics import predictive_summary
from ..utils.posterior_analysis import (
    ECOG_GRID_CHANNEL_IDS,
    direction_correlation_curves,
    distance_correlation_curves,
    plot_spatial_correlation,
)
from ..utils.visualization import _plt

__all__ = ["WORKLOADS", "parse_args", "load_data", "divergence_diagnostics", "mean_corrs",
           "spatial_curves", "evaluate", "run_fit", "run", "main"]

WORKLOADS = {
    "pm25": dict(
        M=100, lr=0.01, itnum=100, batch_sizes=(1000, 2000, 5000),
        hyperpars={"length_scales_L0_log": 10, "length_scales_L1_log": 10,
                   "length_scales_tildeell_log": 10},
        mu_v_init=1.0,
    ),
    "hcp": dict(
        M=100, lr=0.01, itnum=50, batch_sizes=(1000, 2000, 5000),
        hyperpars={"length_scales_L0_log": 5, "length_scales_L1_log": 5,
                   "length_scales_tildeell_log": 5},
        mu_v_init=1.0,
    ),
    "ecog": dict(
        M=100, lr=0.005, itnum=50, batch_sizes=(512,),
        hyperpars={"length_scales_L0_log": 10, "length_scales_L1_log": 10,
                   "length_scales_tildeell_log": 5, "sigma2_err_log": -5},
        mu_v_init=1.0,
    ),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("workload", choices=sorted(WORKLOADS))
    p.add_argument("--data-path", default=None)
    p.add_argument("--M", type=int, default=None)
    p.add_argument("--batchsize", type=int, default=None)
    p.add_argument("--itnum", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=22)
    p.add_argument("--kl-mode", default="true", choices=["true", "ref_compat"])
    p.add_argument("--lr-decay", type=float, default=None,
                   help="per-epoch exponential lr decay (e.g. 0.99)")
    p.add_argument("--grad-clip", type=float, default=1000.0,
                   help="global-norm gradient clip (0 disables); bounds the slow "
                        "destabilization of long HCP runs, inactive on healthy steps")
    p.add_argument("--auto-rollback", action="store_true",
                   help="divergence rollback: an epoch with a non-finite or basin-escaping "
                        "loss is undone and retried at half the lr "
                        "(inference(divergence_rollback=True); incompatible with --lr-decay)")
    p.add_argument("--optimizer", default="adam", choices=["adam", "adam_bf16"],
                   help="adam_bf16 stores both Adam moments in bf16 (f32 compute)")
    p.add_argument("--n-sample", type=int, default=200)
    p.add_argument("--out", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--ckpt-bf16-moments", action="store_true",
                   help="save the Adam moments in bf16 (ckpt_moments_dtype=torch.bfloat16)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--full", action="store_true",
                   help="pm25: full-dataset shape (302,537 train / 10,077 test; reference "
                        "notebook/PM25.ipynb cell 5) instead of the sub shape")
    p.add_argument("--spatial-analysis", action="store_true",
                   help="ECoG only: electrode-grid direction/distance correlation analysis of "
                        "the inferred correlation process (reference NMGP_ECoG_full.py:456-546)")
    p.add_argument("--spatial-grid-points", type=int, default=200,
                   help="time-grid resolution for the spatial correlation analysis")
    p.add_argument("--channel-indexes-path", default=None,
                   help="pickle of electrode IDs per output (real data); default: "
                        "deterministic surrogate containing the 5x5 analysis grid")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.spatial_analysis and args.workload != "ecog":
        p.error("--spatial-analysis is an ECoG workload analysis")
    return args


def load_data(name, data_path, full=False):
    """(X_list, Y_list, Xt_list, Yt_list, source) of a workload: the file at
    `data_path` (raw notebook input or pre-split pickle, sniffed by
    `etl.load_workload_data`), else the same-shape synthetic surrogate."""
    if data_path:
        return (*etl.load_workload_data(name, data_path, full=full), "real")
    if name == "pm25":
        return (*etl.synthetic_pm25(full=full), "synthetic-full" if full else "synthetic")
    if name == "hcp":
        return (*etl.synthetic_hcp(), "synthetic")
    if name == "ecog":
        # held-out 20% of the last channel (NMGP_ECoG_pred.py:24-51 protocol)
        X_list, Y_list = etl.synthetic_ecog()
        return (*etl.ecog_pred_split(X_list, Y_list), "synthetic")
    raise ValueError(name)


def divergence_diagnostics(loss_list) -> dict:
    """Where (if anywhere) the loss left its basin: loss_min, loss_argmin,
    first_nonfinite_step and first_blowup_step (a loss above 10x |min|
    after the minimum; the initial loss legitimately starts above it)."""
    la = np.asarray(loss_list, dtype=np.float64)
    if np.all(~np.isfinite(la)):  # an all-NaN run still gives the record
        return dict(loss_min=float("nan"), loss_argmin=-1, first_nonfinite_step=0,
                    first_blowup_step=-1)
    argmin = int(np.nanargmin(la))
    bad = np.where(~np.isfinite(la))[0]
    blow = np.where(la[argmin:] > 10.0 * abs(float(np.nanmin(la))))[0]
    return dict(loss_min=float(np.nanmin(la)), loss_argmin=argmin,
                first_nonfinite_step=int(bad[0]) if bad.size else -1,
                first_blowup_step=int(argmin + blow[0]) if blow.size else -1)


def mean_corrs(params, Z, grids, n_sample, seed, kl_mode="true",
               noise: Optional[cnmgp.CNMGPNoise] = None, device=None) -> torch.Tensor:
    """Posterior-mean correlation process on `grids`, (G, D, D) on the
    device: the mean over `sample_FY`'s draws (reference est_corrs_train,
    NMGP_ECoG_full.py:321-339), summed chunk by chunk on the device, so the
    (S, G, D, D) draws never exist at once (0.97 GB at ECoG's 200 x 200
    x 78 x 78).  The same draws as one `sample_FY(..., seed=seed)` call, or
    those of `noise`."""
    total = None
    if noise is None:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    for start in range(0, n_sample, DRAWS_PER_CHUNK):
        stop = min(start + DRAWS_PER_CHUNK, n_sample)
        if noise is None:
            chunk = cnmgp.draw_noise(gen, stop - start, params.mu_v.shape[0], len(grids),
                                     params.num_outputs, all_outputs=True, dtype=params.mu_v.dtype)
        else:
            chunk = cnmgp.CNMGPNoise(*(None if z is None else z[start:stop] for z in noise))
        _, _, corrs = sample_FY(params, Z, grids, n_sample=stop - start, kl_mode=kl_mode,
                                noise=chunk, device=device)
        part = corrs.sum(dim=0)
        total = part if total is None else total + part
    return total / n_sample


def spatial_curves(params, Z, args, noise: Optional[cnmgp.CNMGPNoise] = None, device=None):
    """The ECoG spatial analysis of a fit, without figures: (grids (G,),
    direction curves {left, top, right, bottom: (G,)}, distance curves
    {1, 2, 3: (G,)}) on `args.spatial_grid_points` points over Z's span
    (`run_fit`'s Z is linspace(0, t_max, M)), as NumPy arrays.  The
    electrode IDs of the outputs come from `args.channel_indexes_path`,
    else the surrogate's."""
    D = params.num_outputs
    if args.channel_indexes_path:
        with open(args.channel_indexes_path, "rb") as f:  # a file the user names
            channel_indexes = np.asarray(pickle.load(f))
    else:
        channel_indexes = etl.surrogate_ecog_channel_indexes(D)
    z = Z.detach().cpu().numpy() if torch.is_tensor(Z) else np.asarray(Z)
    grids = np.linspace(0.0, float(z.reshape(-1)[-1]), args.spatial_grid_points)
    est = mean_corrs(params, Z, grids, args.n_sample, args.seed, args.kl_mode, noise, device)
    est = est.cpu().numpy()
    return (grids, direction_correlation_curves(est, ECOG_GRID_CHANNEL_IDS, channel_indexes),
            distance_correlation_curves(est, ECOG_GRID_CHANNEL_IDS, channel_indexes))


def evaluate(params, Z, Xt_list: Sequence, Yt_list: Sequence, args, noise=None) -> dict:
    """The keys the JAX script adds after training: rmse_test, ci_length and
    coverage of `sample_Y` over the held-out outputs (when any), and with
    `args.spatial_analysis` the spatial analysis (its figures written
    beside `args.out` when given).  `noise` = (the test draws, the
    spatial draws), either None for the seeded draws."""
    device = "cpu" if args.cpu else None
    noise_test, noise_spatial = noise if noise is not None else (None, None)
    out = {}
    Xt = [np.ravel(v) for v in Xt_list]
    Yt = [np.ravel(v) for v in Yt_list]
    keep = [i for i in range(len(Xt)) if len(Xt[i])]
    if keep:
        ys, _, _, _ = sample_Y(params, Z, [Xt[i] for i in keep], index=keep,
                               n_sample=args.n_sample, seed=args.seed, kl_mode=args.kl_mode,
                               noise=noise_test, device=device)
        rmse, ci, cov = predictive_summary(ys.cpu().numpy(), np.concatenate([Yt[i] for i in keep]))
        out.update(rmse_test=float(rmse), ci_length=float(ci), coverage=float(np.mean(cov)))
    if args.spatial_analysis:
        grids, direction, distance = spatial_curves(params, Z, args, noise_spatial, device)
        figures = []
        if args.out:
            save_dir = os.path.dirname(os.path.abspath(args.out))
            figures = list(plot_spatial_correlation(grids, direction, distance, save_dir))
        out["spatial_analysis"] = {
            "grid_points": int(args.spatial_grid_points),
            "direction_mean": {k: float(np.mean(v)) for k, v in direction.items()},
            "direction_curves": {k: v.tolist() for k, v in direction.items()},
            "distance_mean": {str(k): float(np.mean(v)) for k, v in distance.items()},
            "distance_curves": {str(k): v.tolist() for k, v in distance.items()},
            "figures": figures,
        }
    return out


def run_fit(args):
    """The workload of `args` (a Namespace of `parse_args`, or its argv
    list): returns (the JSON dict, the `DSVIResult`)."""
    if not isinstance(args, argparse.Namespace):
        args = parse_args(args)
    if args.spatial_analysis and args.out:
        _plt()  # the figures need matplotlib: fail before training, not after
    cfg = WORKLOADS[args.workload]
    M = args.M or cfg["M"]
    lr = args.lr or cfg["lr"]
    itnum = args.itnum or cfg["itnum"]
    batch_size = args.batchsize or cfg["batch_sizes"][0]

    X_list, Y_list, Xt_list, Yt_list, source = load_data(args.workload, args.data_path,
                                                         full=args.full)
    D = len(X_list)
    t_max = max(float(np.max(np.concatenate([np.ravel(v) for v in X_list if len(v)]))), 1.0)
    z = np.linspace(0, t_max, M)
    n_train = sum(len(np.ravel(v)) for v in X_list)
    print(f"# {args.workload} ({source}): D={D}, N={n_train}, M={M}, B={batch_size}", flush=True)
    if args.kl_mode == "ref_compat" and args.grad_clip:
        # the reference clips nothing: a trajectory-exact reproduction disables it
        print("# WARNING: --kl-mode ref_compat with grad clip "
              f"{args.grad_clip} — the reference clips nothing; pass "
              "--grad-clip 0 for trajectory-exact reproduction")

    t0 = time.time()
    res = inference(
        X_list, Y_list, z, batch_size=batch_size, dim_outputs=D, lr=lr, itnum=itnum,
        hyperpars=cfg["hyperpars"], fix_hyperpars=True, mu_v=cfg["mu_v_init"] * np.ones(M),
        seed=args.seed, show_ELBO=False, PATH=args.checkpoint, continuous_training=args.resume,
        save_model=args.checkpoint is not None, kl_mode=args.kl_mode,
        grad_clip_norm=args.grad_clip if args.grad_clip else None, lr_decay=args.lr_decay,
        divergence_rollback=args.auto_rollback, optimizer=args.optimizer,
        ckpt_moments_dtype=torch.bfloat16 if args.ckpt_bf16_moments else None,
        device="cpu" if args.cpu else None,
    )
    train_s = time.time() - t0
    out = dict(
        workload=args.workload, source=source, kl_mode=args.kl_mode, D=D, N=n_train, M=M,
        batch_size=batch_size, itnum=itnum, grad_clip=float(args.grad_clip),
        ckpt_bf16_moments=bool(args.ckpt_bf16_moments), lr_decay=args.lr_decay,
        rollbacks=res.rollbacks, final_loss=float(res.loss_list[-1]),
        steps_per_s=len(res.loss_list) / train_s, train_s=train_s,
    )
    if args.checkpoint:
        out["ckpt_load_s"] = LAST_IO_SECONDS["load"]
        out["ckpt_save_s"] = LAST_IO_SECONDS["save"]
    out.update(divergence_diagnostics(res.loss_list))
    out.update(evaluate(res.params, res.Z, Xt_list, Yt_list, args))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return out, res


def run(argv=None) -> dict:
    """The workload's JSON dict (the JAX script's keys)."""
    return run_fit(argv)[0]


def main(argv: Optional[list] = None) -> None:
    print(json.dumps(run(argv)))


if __name__ == "__main__":
    main()
