"""Particle-sharded Sequential Monte Carlo over the ranks of a mesh (the
JAX package's `parallel/sharded_smc.py`).

The particles of `infer/smc.py` split over the mesh's "chain" axis, a
block of equal size a rank, and every statistic across them is a
collective:

  - the weights' log-normalizer, the log Z increment and the ESS: a
    distributed logsumexp (`_global_logsumexp`: the all-reduced max, kept
    finite, then the all-reduced sum of exp(x - max); the ESS's two
    logsumexps share one max and one sum all-reduce);
  - the tempering bisection: the same 50 masked passes as one device's,
    each on the global ESS, so every rank walks the same beta ladder and
    takes the same number of stages (each stage loop test reads beta, an
    all-reduced value; no rank can take a pass another does not);
  - systematic resampling: the (P,) log-weights all-gathered, every rank
    computes the same cumulative weights and the same u0 (a generator
    seeded alike on every rank), resolves the parents of its own slots, and
    takes them from one (P, dim) all-gather of the positions;
  - mutation: HMC per particle with this rank's own draws, the step-size
    controller from the all-reduced mean acceptance.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..infer.hmc import GeneratorDraws, initial_positions
from ..infer.smc import _systematic_resample, run_smc_staged
from .mesh import CHAIN_AXIS, Mesh
from .sharded_mcmc import fold_in

__all__ = ["ShardedSMCDraws", "run_smc_sharded"]


def _global_logsumexp(mesh: Mesh, *xs):
    """logsumexp of each local block x (a vector split over "chain"), in one
    max and one sum all-reduce; the max kept finite when every shard holds
    only -inf."""
    m = mesh.all_reduce_(torch.stack([x.max() for x in xs]), CHAIN_AXIS, "max")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = mesh.all_reduce_(torch.stack([torch.sum(torch.exp(x - mi)) for x, mi in zip(xs, m)]),
                         CHAIN_AXIS)
    return m + torch.log(s)


def _global_ess(mesh: Mesh, log_w):
    """ESS = (sum w)^2 / sum w^2 of the globally normalized weights."""
    lse = _global_logsumexp(mesh, log_w, 2.0 * log_w)
    return torch.exp(2.0 * lse[0] - lse[1])


def _systematic_resample_sharded(mesh: Mesh, u0, log_w_local, positions_local):
    """Global systematic resampling of a (P, dim) cloud split over "chain":
    this rank's new block (P_local, dim)."""
    p_local = positions_local.shape[0]
    r = mesh.coordinate(CHAIN_AXIS)
    log_w = mesh.all_gather(log_w_local, CHAIN_AXIS)
    parents = _systematic_resample(u0, log_w, log_w.shape[0])[r * p_local:(r + 1) * p_local]
    return mesh.all_gather(positions_local, CHAIN_AXIS)[parents]


class _Sharded:
    """The reductions of `infer.smc`'s stage over the particle shards."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def num_particles(self, local: int) -> int:
        return local * self.mesh.size(CHAIN_AXIS)

    def ess(self, log_w):
        return _global_ess(self.mesh, log_w)

    def logsumexp(self, x):
        return _global_logsumexp(self.mesh, x)[0]

    def mean(self, x):
        return (self.mesh.all_reduce_(torch.sum(x), CHAIN_AXIS)
                / self.num_particles(x.shape[0]))

    def resample(self, u0, log_w, positions):
        return _systematic_resample_sharded(self.mesh, u0, log_w, positions)


class ShardedSMCDraws(GeneratorDraws):
    """A shard's draws: the resampling uniform from `shared` (seeded alike
    on every rank, so all resolve the same u0), each mutation's momentum
    and accept uniforms of this shard's particles from `generator`."""

    def __init__(self, shared: torch.Generator, generator: torch.Generator, particles: int,
                 dim: int, dtype, device):
        super().__init__(generator, particles, dim, dtype, device)
        self.shared = shared

    def resample(self):
        return torch.rand((), generator=self.shared, dtype=self.dtype, device=self.device)


def run_smc_sharded(
    log_prior_fn: Callable,
    log_like_fn: Callable,
    init_positions,  # (P, dim) prior draws; P % mesh "chain" size == 0
    seed: int,
    mesh: Mesh,
    num_mutations: int = 5,
    num_leapfrog: int = 16,
    ess_target_frac: float = 0.5,
    max_stages: int = 100,
    init_step_size: float = 0.1,
    target_accept: float = 0.65,
    draws=None,
    device=None,
):
    """Adaptive-tempering SMC with the particles split over the mesh's
    "chain" axis: the algorithm of `infer.smc.run_smc`, its statistics
    collectives (the module docstring).  Every rank passes the whole
    (P, dim) cloud and keeps its block.  Draws: the resampling uniform from
    a generator seeded `seed` on every rank, the mutations' from one seeded
    `fold_in(seed, r)` on chain rank r; `draws`, given, is this rank's
    draws object instead.

    Returns, on every rank, the final positions (P, dim) in particle order
    and the info of `run_smc` (log_z, num_stages, final_step_size, betas),
    the same on every rank."""
    q = initial_positions(init_positions, device)
    n, r = mesh.size(CHAIN_AXIS), mesh.coordinate(CHAIN_AXIS)
    if q.shape[0] % n:
        raise ValueError(f"{q.shape[0]} particles do not split over {n} chain shards")
    p_local = q.shape[0] // n
    q = q[r * p_local:(r + 1) * p_local]
    if draws is None:
        gen = lambda s: torch.Generator(device=q.device).manual_seed(s)  # noqa: E731
        draws = ShardedSMCDraws(gen(int(seed)), gen(fold_in(seed, r)), p_local, q.shape[1],
                                q.dtype, q.device)
    positions, info = run_smc_staged(
        log_prior_fn, log_like_fn, q, num_mutations=num_mutations, num_leapfrog=num_leapfrog,
        ess_target_frac=ess_target_frac, max_stages=max_stages, init_step_size=init_step_size,
        target_accept=target_accept, draws=draws, _red=_Sharded(mesh))
    return mesh.all_gather(positions, CHAIN_AXIS), info
