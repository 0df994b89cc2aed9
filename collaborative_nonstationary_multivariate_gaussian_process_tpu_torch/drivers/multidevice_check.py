"""The multi-rank paths of the port at full width, one rank's body.

`chip_smoke.py`'s multidevice phase spawns two ranks of a gloo group on one
card (`parallel.launch.spawn`) and each runs `card_ranks`, in order:

  - one data-parallel DSVI step at ECoG width (D = 78, M = 100, a
    minibatch of 512 rows, 256 a rank), its gradient held against the
    one-process float64 gradient of the same minibatch and noise (on rank
    0, with the plain float32 errors at three row orders, as the ECoG
    gradient gate takes them), then the seconds a full step takes and the
    seconds of its all-reduce alone;
  - `run_chees_sharded` on the SVC study of `drivers/mcmc_sim.py` (dim 401
    at N = 100, 4 chains, 2 a rank), its depth cut;
  - `run_smc_sharded` on the three models of `drivers/model_comparison.py`
    (512 particles, 256 a rank), at the script's mutations and seeds;
  - a short `run_nuts_sharded` on the SVC study.

It returns what the caller gates and prints, with each part's kernel
launches.  The sizes are arguments, so the same body runs at a tiny size on
the CPU.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, NamedTuple

import numpy as np
import torch

from ..infer import dsvi
from ..models import cnmgp
from ..ops import cuda_kernels as ck
from ..parallel.mesh import make_mesh
from ..parallel.sharded_mcmc import (
    potential_scale_reduction,
    run_chees_sharded,
    run_nuts_sharded,
)
from ..parallel.sharded_smc import run_smc_sharded
from ..utils.data import flatten_output_lists
from ..utils.sim import sim_mnts
from . import mcmc_sim
from . import model_comparison as mc

__all__ = ["card_ranks", "ecog_data", "ecog_lists", "ecog_problem", "GradientProblem"]

JITTER = 1e-4


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launched(before):
    return {k: ck.LAUNCHES[k] - before[k] for k in ck.KERNELS}


def _rel_to_max(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def ecog_lists(D: int = 78):
    """The ECoG-width synthetic data (scripts/bench_ecog.py:46-52): D
    outputs, each on the time axis 0..799, y = sin(t / 40)."""
    t = np.arange(800.0)
    return [t] * D, [np.sin(t / 40.0)] * D


def ecog_data(dev, D: int = 78, M: int = 100):
    """The flat ECoG training data (x, y, idx) on `dev` and Z =
    linspace(0, 800, M)."""
    flat = flatten_output_lists(*ecog_lists(D))
    return (torch.as_tensor(flat.x, dtype=torch.float32, device=dev),
            torch.as_tensor(flat.y, dtype=torch.float32, device=dev),
            torch.as_tensor(flat.idx, dtype=torch.int64, device=dev),
            torch.linspace(0.0, 800.0, M, device=dev))


class GradientProblem(NamedTuple):
    """One minibatch of the ECoG gradient check (`ecog_problem`)."""

    params: cnmgp.CNMGPParams
    rows: torch.Tensor  # the minibatch's rows of the data
    noise: cnmgp.CNMGPNoise
    weights: torch.Tensor
    orders: List[torch.Tensor]  # the identity, then two more row orders
    # grads(dtype, order) -> (-SELBO, every parameter's gradient)
    grads: Callable


def ecog_problem(x, y, idx, Z, gen, D: int = 78, B: int = 512) -> GradientProblem:
    """The ECoG gradient check's problem: `init_params` (seed 0) with the
    lengthscales set to 40 (dense priors), and one minibatch of B rows, its
    noise and two more row orders drawn from `gen`.  `grads(dtype, order)`
    takes the minibatch's rows and their noise in `order`, all cast to
    `dtype`: the same sum rounded otherwise, so the plain float32 errors
    at the three orders witness how far float32 may stray from float64."""
    dev, M = x.device, Z.shape[0]
    params = cnmgp.init_params(torch.Generator(device=dev).manual_seed(0), D, M, device=dev)
    log40 = torch.tensor(math.log(40.0), device=dev)
    params = params._replace(mu_v=torch.full((M,), math.log(40.0), device=dev),
                             length_scales_tildeell_log=log40, length_scales_L0_log=log40,
                             length_scales_L1_log=log40)
    sel = torch.randperm(x.shape[0], device=dev, generator=gen)[:B]
    noise = cnmgp.draw_train_noise(gen, 1, M, B, D)
    w = torch.ones(B, device=dev)
    orders = [torch.arange(B, device=dev)] + [
        torch.randperm(B, device=dev, generator=gen) for _ in range(2)]

    def grads(dtype, order):
        p = cnmgp.CNMGPParams(*(t.detach().to(dtype, copy=True).requires_grad_(True)
                                for t in params))
        nz = noise._replace(**{f: getattr(noise, f)[..., order] for f in ("z_te", "z_diag", "z_off")})
        nz = cnmgp.CNMGPNoise(*(None if z is None else z.to(dtype) for z in nz))
        b = sel[order]
        loss = cnmgp.negative_selbo(p, Z.to(dtype), x[b].to(dtype), y[b].to(dtype), idx[b],
                                    w.to(dtype), float(x.shape[0]), nz)
        loss.backward()
        return float(loss.detach()), [t.grad for t in p]

    return GradientProblem(params, sel, noise, w, orders, grads)


def _dp_step(dev, mesh, D, M, B, steps):
    """The data-parallel step's gradient against float64, and its time."""
    x, y, idx, Z = ecog_data(dev, D, M)
    n = x.shape[0]
    prob = ecog_problem(x, y, idx, Z, torch.Generator(device=dev).manual_seed(3), D, B)
    for t in prob.params:
        mesh.broadcast_(t, 0)
    sel, noise, w = prob.rows, prob.noise, prob.weights

    before = dict(ck.LAUNCHES)
    p = cnmgp.CNMGPParams(*(t.detach().clone().requires_grad_(True) for t in prob.params))
    step = dsvi._TrainStep(dsvi.make_optimizer(p, "adam", 0.005), float(n), JITTER, "true", None,
                           None, 0, mesh)
    loss = float(step._shard_loss(p, Z, x[sel], y[sel], idx[sel], w, noise))
    dp_grads = [q.grad.detach().clone() for q in p]
    _sync(dev)
    out = {"loss": loss, "grad_launches": _launched(before)}

    if mesh.rank == 0:
        loss64, g64 = prob.grads(torch.float64, prob.orders[0])
        with ck.plain_versions():
            plain = [prob.grads(torch.float32, o)[1] for o in prob.orders]
        out["loss64"] = loss64
        out["grad_errors"] = {
            name: {"dp_kernels": _rel_to_max(dp_grads[i], g64[i]),
                   "plain": [_rel_to_max(g[i], g64[i]) for g in plain]}
            for i, name in enumerate(cnmgp.CNMGPParams._fields)}
        del g64, plain

    # a full step (all-reduce and Adam included), then the all-reduce alone
    mask = dsvi.freeze_mask(p, True)
    bx, by, bi = x[sel], y[sel], idx[sel]
    before = dict(ck.LAUNCHES)
    for _ in range(2):
        step(p, mask, Z, bx, by, bi, w, noise)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        last = step(p, mask, Z, bx, by, bi, w, noise)
    _sync(dev)
    out["step_s"] = (time.perf_counter() - t0) / steps
    out["step_launches"] = _launched(before)
    out["last_loss"] = float(last)
    flat_grads = torch.zeros(sum(q.numel() for q in p) + 1, device=dev)
    mesh.all_reduce_(flat_grads)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        mesh.all_reduce_(flat_grads)
    _sync(dev)
    out["allreduce_s"] = (time.perf_counter() - t0) / steps
    out["allreduce_mb"] = 4 * flat_grads.numel() / 2**20
    out["params_checksum"] = float(sum(float(q.detach().double().sum()) for q in p))
    return out


def _svc(dev, N, chains, seed=0):
    """The SVC study's whitened density and the ChEES and NUTS starts of
    `drivers/mcmc_sim.run_study`."""
    prob = mcmc_sim.svc_density(mcmc_sim.svc_problem(N, seed), dev)
    init = torch.as_tensor(prob["init"], dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(chains, init.shape[0], generator=gen, device=dev)
    chees_init = 0.5 * noise
    chees_init[:, -1] = init[-1]
    return prob["lp"], chees_init, init[None, :] + 0.01 * noise


def card_ranks(device: str = "cuda", D: int = 78, M: int = 100, B: int = 512, dp_steps: int = 5,
               svc_n: int = 100, chains: int = 4, chees_warmup: int = 40, chees_samples: int = 20,
               particles: int = 512, smc_n: int = 48, mutations: int = 5, nuts_warmup: int = 6,
               nuts_samples: int = 4, nuts_depth: int = 4) -> dict:
    """One rank of the multi-rank checks (the module docstring)."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    t0 = time.perf_counter()
    out["dp"] = _dp_step(dev, make_mesh(data=2), D, M, B, dp_steps)
    out["dp"]["s"] = time.perf_counter() - t0

    mesh_c = make_mesh(data=1, chain=2)
    lp, chees_init, nuts_init = _svc(dev, svc_n, chains)
    before, t0 = dict(ck.LAUNCHES), time.perf_counter()
    pos, info = run_chees_sharded(lp, chees_init, 1, mesh_c, num_warmup=chees_warmup,
                                  num_samples=chees_samples)
    _sync(dev)
    draws = pos.double().cpu()
    out["chees"] = {
        "s": time.perf_counter() - t0, "launches": _launched(before), "shape": list(pos.shape),
        "finite": bool(torch.isfinite(draws).all()), "step_size": float(info["step_size"]),
        "trajectory_length": float(info["trajectory_length"]),
        "rhat_max": float(potential_scale_reduction(draws).max()),
        "mean_accept": float(info["accept_prob"].double().mean()),
        "leapfrogs": info["leapfrogs"], "host_reads": info["host_reads"]}

    before, t0 = dict(ck.LAUNCHES), time.perf_counter()
    x_np, _, _, _, Y_np = sim_mnts(M=2, N=smc_n, seed=0)
    models = mc.make_models(torch.as_tensor(x_np, dtype=torch.float32, device=dev),
                            torch.as_tensor(Y_np, dtype=torch.float32, device=dev))
    smc = {}
    for name in mc.MODELS:
        m, (s_init, s_smc) = models[name], mc.SEEDS[name]
        t1 = time.perf_counter()
        init = m.prior_sampler(torch.Generator(device=dev).manual_seed(s_init), particles)
        _, info = run_smc_sharded(m.log_prior, m.log_like, init, s_smc, mesh_c,
                                  num_mutations=mutations, num_leapfrog=mc.NUM_LEAPFROG)
        smc[name] = {"log_z": float(info["log_z"]), "stages": info["num_stages"],
                     "last_beta": float(info["betas"][-1]), "s": time.perf_counter() - t1}
    out["smc"] = {"models": smc, "s": time.perf_counter() - t0, "launches": _launched(before)}

    before, t0 = dict(ck.LAUNCHES), time.perf_counter()
    pos, info = run_nuts_sharded(lp, nuts_init, 2, mesh_c, num_warmup=nuts_warmup,
                                 num_samples=nuts_samples, max_depth=nuts_depth)
    _sync(dev)
    out["nuts"] = {"s": time.perf_counter() - t0, "launches": _launched(before),
                   "shape": list(pos.shape), "finite": bool(torch.isfinite(pos).all()),
                   "host_reads": info["host_reads"]}
    return out
