"""Chain-parallel MCMC over the ranks of a mesh (the JAX package's
`parallel/sharded_mcmc.py`), and the MCMC diagnostics: effective sample
size and split R-hat over (chains, samples, dim) draws (`:297-329`).

The chains split over the mesh's "chain" axis, a block of equal size a
rank.  NUTS and HMC are per-chain kernels: each rank runs the port's
`run_nuts` / `run_hmc` on its block, and the draws and the per-chain info
are gathered in chain order.  ChEES is a joint kernel: its one `cmean`,
through which every cross-chain mean goes, is an all-reduce over "chain"
divided by the shard count (the JAX `pmean` of the block means), so every
rank adapts the same step size and trajectory length from the whole
population.

Randomness: the JAX package splits its key per chain (NUTS, HMC) or folds
in the shard index (ChEES).  The port draws a block's noise from one
generator, seeded `fold_in(seed, r)` for the block of chain-axis rank r;
`draws`, given, is this rank's draws object instead (a test replays the
JAX streams through it).  The draws of a block therefore depend on how the
chains are split, as the JAX ChEES draws do.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..infer import chees as chees_mod
from ..infer.hmc import GeneratorDraws, initial_positions, run_hmc
from ..infer.nuts import run_nuts
from .mesh import CHAIN_AXIS, Mesh

__all__ = [
    "fold_in",
    "run_nuts_sharded",
    "run_hmc_sharded",
    "run_chees_sharded",
    "effective_sample_size",
    "potential_scale_reduction",
]


def fold_in(seed: int, index: int) -> int:
    """The seed of stream `index` of `seed` (the JAX `fold_in`'s role): a
    different seed for every (seed, index) pair of small integers."""
    return (int(seed) * 0x9E3779B1 + int(index) + 1) % (1 << 63)


def _block(mesh: Mesh, init_positions, device):
    """This rank's block of the chains, and the block size."""
    q = initial_positions(init_positions, device)
    n, r = mesh.size(CHAIN_AXIS), mesh.coordinate(CHAIN_AXIS)
    if q.shape[0] % n:
        raise ValueError(f"{q.shape[0]} chains do not split over {n} chain shards")
    c = q.shape[0] // n
    return q[r * c:(r + 1) * c], c


def _draws(mesh: Mesh, seed: int, q, draws):
    if draws is not None:
        return draws
    gen = torch.Generator(device=q.device).manual_seed(fold_in(seed, mesh.coordinate(CHAIN_AXIS)))
    return GeneratorDraws(gen, q.shape[0], q.shape[1], q.dtype, q.device)


def _gather(mesh: Mesh, info: dict, chains: int) -> dict:
    """Per-chain tensors (leading dim `chains`) gathered in chain order;
    counts of host work a list over the chain shards; the rest as they are
    (the same on every rank)."""
    out = {}
    for k, v in info.items():
        if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == chains:
            out[k] = mesh.all_gather(v.contiguous(), CHAIN_AXIS)
        elif isinstance(v, int):
            out[k] = mesh.all_gather(torch.tensor([v]), CHAIN_AXIS).tolist()
        else:
            out[k] = v
    return out


def run_nuts_sharded(
    log_prob_fn: Callable,
    init_positions,  # (num_chains, dim); num_chains % mesh "chain" size == 0
    seed: int,
    mesh: Mesh,
    num_warmup: int = 500,
    num_samples: int = 1000,
    max_depth: int = 10,
    target_accept: float = 0.8,
    draws=None,
    device=None,
):
    """NUTS with the chains split over the mesh's "chain" axis: each rank
    runs `infer.nuts.run_nuts` on its block (warmup included, per chain),
    with its own draws (the module docstring).
    Returns, on every rank, the positions (num_chains, num_samples, dim)
    and the info of `run_nuts`, each per-chain entry gathered in chain
    order and the host counts a list over the shards."""
    q, c = _block(mesh, init_positions, device)
    positions, info = run_nuts(log_prob_fn, q, num_warmup=num_warmup, num_samples=num_samples,
                               max_depth=max_depth, target_accept=target_accept,
                               draws=_draws(mesh, seed, q, draws))
    return mesh.all_gather(positions, CHAIN_AXIS), _gather(mesh, info, c)


def run_hmc_sharded(
    log_prob_fn: Callable,
    init_positions,
    seed: int,
    mesh: Mesh,
    num_warmup: int = 500,
    num_samples: int = 1000,
    num_steps: int = 32,
    target_accept: float = 0.8,
    draws=None,
    device=None,
):
    """HMC with the chains split over the mesh's "chain" axis, as
    `run_nuts_sharded` (each rank runs `infer.hmc.run_hmc` on its block)."""
    q, c = _block(mesh, init_positions, device)
    positions, info = run_hmc(log_prob_fn, q, num_warmup=num_warmup, num_samples=num_samples,
                              num_steps=num_steps, target_accept=target_accept,
                              draws=_draws(mesh, seed, q, draws))
    return mesh.all_gather(positions, CHAIN_AXIS), _gather(mesh, info, c)


def run_chees_sharded(
    log_prob_fn: Callable,
    init_positions,  # (num_chains, dim); num_chains % mesh "chain" size == 0
    seed: int,
    mesh: Mesh,
    num_warmup: int = 500,
    num_samples: int = 1000,
    target_accept: float = 0.651,
    init_step_size: float = 0.1,
    init_traj_length=None,
    max_num_steps: int = 1024,
    adam_lr: float = 0.025,
    mass_adapt: bool = True,
    max_iters_per_dispatch=None,
    draws=None,
    device=None,
):
    """ChEES-HMC with the chains split over the mesh's "chain" axis, one
    joint kernel: every cross-chain statistic (mean acceptance, the ChEES
    gradient, the pooled mass-matrix moments) is the all-reduced mean over
    all chains, so the adaptation is the same on every rank.

    `max_iters_per_dispatch` is the JAX package's segment length (its TPU
    worker's dispatch budget); the port runs one host loop and takes it
    only for the signature: the draws do not depend on it.

    Returns, on every rank, positions (num_chains, num_samples, dim) and
    info: accept_prob and log_prob (num_chains, num_samples) in chain
    order (the JAX info holds them (num_samples, num_chains)); num_steps
    (num_samples,), step_size, trajectory_length and inv_mass, equal on
    every rank; warmup_accept_mean over all chains; host_reads and
    leapfrogs of this rank."""
    del max_iters_per_dispatch
    q, _ = _block(mesh, init_positions, device)
    shards = mesh.size(CHAIN_AXIS)

    def cmean(x):
        return mesh.all_reduce_(x.mean(dim=0), CHAIN_AXIS) / shards

    d = _draws(mesh, seed, q, draws)
    state, tuning, winfo = chees_mod.chees_warmup(
        log_prob_fn, q, num_warmup=num_warmup, target_accept=target_accept,
        init_step_size=init_step_size, init_traj_length=init_traj_length,
        max_num_steps=max_num_steps, adam_lr=adam_lr, mass_adapt=mass_adapt, cmean=cmean,
        draws=d)
    _, positions, info = chees_mod.chees_sample(
        log_prob_fn, state, tuning, num_samples=num_samples,
        halton_offset=winfo["halton_offset"], max_num_steps=max_num_steps, cmean=cmean, draws=d)
    warm = winfo["warmup_accept_mean"]
    info = dict(info)
    info.update(
        accept_prob=mesh.all_gather(info["accept_prob"], CHAIN_AXIS),
        log_prob=mesh.all_gather(info["log_prob"], CHAIN_AXIS),
        step_size=tuning.step_size,
        trajectory_length=torch.exp(tuning.log_traj_length),
        inv_mass=tuning.inv_mass,
        warmup_accept_mean=None if warm is None else mesh.all_reduce_(warm, CHAIN_AXIS) / shards,
        host_reads=info["host_reads"] + winfo["host_reads"],
        leapfrogs=info["leapfrogs"] + winfo["leapfrogs"],
    )
    return mesh.all_gather(positions, CHAIN_AXIS), info


def _as_draws(chains_samples):
    if isinstance(chains_samples, torch.Tensor):
        return chains_samples
    return torch.as_tensor(chains_samples)


def effective_sample_size(chains_samples):
    """ESS by the autocorrelation method (Geyer's initial positive sequence,
    FFT autocovariances), over (C, S, dim) draws.  Returns (dim,)."""
    x = _as_draws(chains_samples)
    c, n, d = x.shape
    x = x - x.mean(dim=1, keepdim=True)
    nfft = 2 ** math.ceil(math.log2(2 * n))
    f = torch.fft.rfft(x, n=nfft, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=1)[:, :n, :] / n
    rho = acov.mean(dim=0) / torch.clamp(acov[:, 0, :].mean(dim=0), min=1e-30)
    n_pairs = (n - 1) // 2
    pair = rho[1:1 + 2 * n_pairs].reshape(n_pairs, 2, d).sum(dim=1)  # (P, dim)
    positive = torch.cumprod((pair > 0).to(rho.dtype), dim=0)
    tau = 1.0 + 2.0 * torch.sum(pair * positive, dim=0)
    return c * n / torch.clamp(tau, min=1.0)


def potential_scale_reduction(chains_samples):
    """Split R-hat over (C, S, dim) draws.  Returns (dim,)."""
    x = _as_draws(chains_samples)
    c, n, d = x.shape
    half = n // 2
    x = torch.cat([x[:, :half], x[:, half:2 * half]], dim=0)  # (2C, half, dim)
    nn = x.shape[1]
    chain_means = x.mean(dim=1)
    W = torch.var(x, dim=1, correction=1).mean(dim=0)
    B = nn * torch.var(chain_means, dim=0, correction=1)
    var_plus = (nn - 1) / nn * W + B / nn
    return torch.sqrt(var_plus / W)
