"""Entry points: a one-card forward step and a multi-rank dry run (the JAX
package's `__graft_entry__.py`).

    python -m collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers.\\
graft_entry [--ranks 2] [--cpu]

runs `dryrun_multichip(ranks)`, then `entry()`'s function once, and prints
an OK line for each.  On the card every rank shares it under the "gloo"
backend (NCCL refuses two ranks on one GPU); `--cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import math

import torch

from ..config import resolve_device
from ..infer import dsvi
from ..models import cnmgp
from ..models import logdensities as ld
from ..parallel.launch import spawn
from ..parallel.mesh import CHAIN_AXIS, DATA_AXIS, make_mesh
from ..parallel.sharded_mcmc import run_chees_sharded, run_hmc_sharded
from ..parallel.sharded_smc import run_smc_sharded

__all__ = ["entry", "dryrun_multichip", "dryrun_rank"]


def entry(device=None):
    """(fn, example_args): the float32 negative SELBO of the CNMGP at D = 4
    outputs, M = 32 inducing points, a batch of B = 256, on the card unless
    `device` says otherwise; the parameters from `init_params` at seed 0,
    the noise of one draw at seed 1 (the JAX `entry()` takes PRNGKeys 0
    and 1)."""
    D, M, B = 4, 32, 256
    dtype = torch.float32
    dev = resolve_device(device)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    params = cnmgp.init_params(gen(0), D, M, dtype=dtype, device=dev)
    Z = torch.linspace(0.0, 1.0, M, dtype=dtype, device=dev)
    x = torch.linspace(0.0, 1.0, B, dtype=dtype, device=dev)
    y = torch.sin(7.0 * x)
    idx = torch.arange(B, device=dev) % D
    w = torch.ones(B, dtype=dtype, device=dev)
    noise = cnmgp.draw_train_noise(gen(1), 1, M, B, D, dtype=dtype)

    def fn(params, Z, x, y, idx, w, noise):
        return cnmgp.negative_selbo(params, Z, x, y, idx, w, float(B), noise)

    return fn, (params, Z, x, y, idx, w, noise)


def dryrun_rank(n_devices: int, device: str) -> dict:
    """One rank of `dryrun_multichip`: a data-parallel DSVI step over a
    (n x 1) mesh (parameters from rank 0), chain-sharded HMC on the SNMGP
    posterior, sharded SMC and chain-sharded ChEES over a (1 x n) mesh, at
    the JAX dry run's sizes.  Returns what the caller checks."""
    dev = torch.device(device)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    f32 = torch.float32

    # ---------------- data-parallel DSVI step over "data" -----------------
    mesh = make_mesh(data=n_devices, chain=1)
    D, M = 3, 8
    B = 16 * n_devices
    params = cnmgp.init_params(gen(0), D, M, dtype=f32, device=dev)
    params = cnmgp.CNMGPParams(*(mesh.broadcast_(t.clone(), 0).requires_grad_(True)
                                 for t in params))
    Z = torch.linspace(0.0, 1.0, M, dtype=f32, device=dev)
    x = torch.linspace(0.0, 1.0, B, dtype=f32, device=dev)
    y = torch.sin(5.0 * x)
    idx = torch.arange(B, device=dev) % D
    opt = dsvi.make_optimizer(params, "adam", 1e-2)
    run = dsvi.make_scan_epochs(opt, float(B), 1e-4, 1, B, mesh=mesh)
    losses = run(params, dsvi.freeze_mask(params, True), Z, x, y, idx,
                 dsvi.EpochDraws(gen(1), M, B, D, f32), 1)
    loss = float(losses[-1])
    checksum = float(sum(float(p.detach().double().sum()) for p in params))

    # ---------------- chain-sharded HMC on the SNMGP posterior ------------
    mesh_c = make_mesh(data=1, chain=n_devices)
    N, T = 6, ld.tri_size(2)
    xs = torch.linspace(0.0, 1.0, N, device=dev)
    Y = torch.stack([torch.sin(3 * xs), torch.cos(3 * xs)], dim=1)
    dim = 2 * N + T + 1
    init = 0.01 * torch.randn(2 * n_devices, dim, generator=gen(2), device=dev)
    positions, _ = run_hmc_sharded(lambda q: ld.snmgp_log_posterior(q, Y, xs), init, 3, mesh_c,
                                   num_warmup=3, num_samples=2, num_steps=4)

    # ---------------- sharded SMC ----------------------------------------
    def lp_prior(q):
        return -0.5 * torch.sum(q**2, dim=-1)

    def lp_like(q):
        return -0.5 * torch.sum((q - 1.0) ** 2, dim=-1) / 0.25

    q0 = torch.randn(4 * n_devices, 3, generator=gen(4), device=dev)
    _, smc_info = run_smc_sharded(lp_prior, lp_like, q0, 5, mesh_c, num_mutations=2,
                                  num_leapfrog=4, max_stages=20)

    # ---------------- chain-sharded ChEES --------------------------------
    chees_init = 0.1 * torch.randn(2 * n_devices, 3, generator=gen(6), device=dev)
    chees_pos, chees_info = run_chees_sharded(lp_like, chees_init, 7, mesh_c, num_warmup=8,
                                              num_samples=4, max_num_steps=8)
    return {
        "mesh": [mesh.size(DATA_AXIS), mesh_c.size(CHAIN_AXIS)],
        "loss": loss,
        "params_checksum": checksum,
        "hmc_shape": list(positions.shape),
        "hmc_finite": bool(torch.isfinite(positions).all()),
        "log_z": float(smc_info["log_z"]),
        "smc_stages": int(smc_info["num_stages"]),
        "chees_shape": list(chees_pos.shape),
        "chees_finite": bool(torch.isfinite(chees_pos).all()),
        "chees_step_size": float(chees_info["step_size"]),
    }


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600.0):
    """Spawn `n_devices` ranks (gloo) and run one `dryrun_rank` in each:
    the data-parallel DSVI step, chain-sharded HMC, sharded SMC and
    chain-sharded ChEES, every collective family the port uses.  Checks
    that every rank's loss and log Z are finite, that the ranks hold the
    same parameters after the step and adapted the same ChEES step size,
    prints the JAX dry run's OK line, and returns each rank's result (with
    its kernel launches).  Runs on the card unless `device` says
    otherwise."""
    if n_devices < 2:
        raise ValueError("need at least 2 ranks for a meaningful dry run")
    dev = str(resolve_device(device))
    # `__spec__.name`: this module's import path, also when it runs as `python -m`
    results = spawn(f"{__spec__.name}:dryrun_rank", n_devices,
                    {"n_devices": n_devices, "device": dev}, timeout=timeout)
    r0 = results[0]
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["log_z"]) for r in results):
        raise RuntimeError(f"dry run: a non-finite loss or log Z: {results}")
    for key in ("loss", "params_checksum", "log_z", "chees_step_size"):
        if len({r[key] for r in results}) != 1:
            raise RuntimeError(f"dry run: the ranks disagree on {key}: {[r[key] for r in results]}")
    if not all(r["hmc_finite"] and r["chees_finite"] for r in results):
        raise RuntimeError("dry run: non-finite draws")
    data, chain = r0["mesh"]
    print(
        f"dryrun_multichip OK: mesh=({data}x1, 1x{chain}) dp-loss={r0['loss']:.3f}, "
        f"chain-sharded HMC samples {tuple(r0['hmc_shape'])}, "
        f"sharded SMC log_z={r0['log_z']:.3f} ({r0['smc_stages']} stages), "
        f"sharded ChEES samples {tuple(r0['chees_shape'])}"
    )
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    a = ap.parse_args(argv)
    device = "cpu" if a.cpu else None
    dryrun_multichip(a.ranks, device)
    fn, args = entry(device)
    print("entry loss:", float(fn(*args)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
