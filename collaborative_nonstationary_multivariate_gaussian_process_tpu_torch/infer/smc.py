"""Sequential Monte Carlo with adaptive tempering, for model comparison.

The JAX package's `infer/smc.py`.  The reference compares models by
AIC/BIC/DIC over sampler histories (SIM_code/Utility/model_validation.py:
9-51); SMC gives the log marginal likelihood log p(y) instead:

  - particles on a leading (P, dim) axis, the densities taking (P, dim) to
    (P,);
  - the next inverse temperature by bisection, so that the ESS of the
    incremental weights stays at `ess_target_frac` P: a masked loop of at
    most 50 passes on the device, no host read inside it;
  - systematic resampling, then `num_mutations` HMC transitions at the new
    temperature (unit mass, one step size shared by the particles, moved
    each round toward `target_accept`).

The stage loop runs on the host, one read of beta a stage (`run_smc` and
`run_smc_staged` are that one loop).  Randomness comes from a `draws`
object with `resample()` (a stage's resampling uniform), `momentum()` and
`accept()` (a mutation's (P, dim) normals and (P,) uniforms): `SMCDraws`
over a `torch.Generator`, or a test's replay of the JAX key splits.  Every
statistic across the particles goes through one reductions object
(`_OneDevice` here; `parallel.sharded_smc` passes one whose reductions are
collectives over the particle shards).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .hmc import GeneratorDraws, hmc_init, hmc_kernel, initial_positions

__all__ = ["SMCState", "SMCDraws", "run_smc", "run_smc_staged", "log_marginal_likelihood"]

BISECTION_PASSES = 50


class SMCState(NamedTuple):
    positions: torch.Tensor  # (P, dim)
    log_like: torch.Tensor  # (P,) log-likelihood at the particles
    beta: torch.Tensor  # () current inverse temperature
    log_z: torch.Tensor  # () accumulated log normalizing constant
    step_size: torch.Tensor  # () mutation step size
    num_stages: int


class SMCDraws(GeneratorDraws):
    """`GeneratorDraws` over the particles, with the resampling uniform."""

    def resample(self):
        return torch.rand((), generator=self.generator, dtype=self.dtype, device=self.device)


def _ess(log_w):
    log_w = log_w - torch.logsumexp(log_w, dim=0)
    return torch.exp(-torch.logsumexp(2.0 * log_w, dim=0))


def _find_next_beta(log_like, beta, ess_target_frac, num_particles, ess=_ess):
    """Bisection for the largest dbeta in (0, 1 - beta] with ESS >= target,
    as the JAX while-loop runs it (at most 50 passes, until hi - lo <= 1e-6
    (1 - beta)); a pass past the end leaves lo and hi as they are.  The
    passes are a fixed count, decided by no value: sharded, every rank runs
    the same ones."""
    target = ess_target_frac * num_particles
    full = 1.0 - beta
    lo, hi = torch.zeros_like(full), full
    active = torch.ones((), dtype=torch.bool, device=full.device)
    for _ in range(BISECTION_PASSES):
        active = active & ((hi - lo) > 1e-6 * full)
        mid = 0.5 * (lo + hi)
        ok = ess(mid * log_like) >= target
        lo, hi = (torch.where(active & ok, mid, lo), torch.where(active & ~ok, mid, hi))
    # if even the full remaining jump keeps the ESS above target, take it
    db = torch.where(ess(full * log_like) >= target, full, lo)
    db = torch.maximum(db, 1e-6 * full)
    return beta + db


def _systematic_resample(u0, log_w, num_particles):
    """Parent indices (P,) of systematic resampling at the uniform u0:
    cumsum of the normalized weights, then searchsorted (left)."""
    w = torch.exp(log_w - torch.logsumexp(log_w, dim=0))
    cum = torch.cumsum(w, dim=0)
    us = (u0 + torch.arange(num_particles, dtype=w.dtype, device=w.device)) / num_particles
    return torch.searchsorted(cum, us, right=False).clamp(0, num_particles - 1)


class _OneDevice:
    """The cross-particle statistics when every particle is here."""

    def num_particles(self, local: int) -> int:
        return local

    def ess(self, log_w):
        return _ess(log_w)

    def logsumexp(self, x):
        return torch.logsumexp(x, dim=0)

    def mean(self, x):
        return torch.mean(x)

    def resample(self, u0, log_w, positions):
        return positions[_systematic_resample(u0, log_w, positions.shape[0])]


def _stage(log_prior_fn, log_like_fn, state: SMCState, draws, num_mutations, num_leapfrog,
           ess_target_frac, target_accept, red=_OneDevice()):
    dim = state.positions.shape[1]
    P = red.num_particles(state.positions.shape[0])
    new_beta = _find_next_beta(state.log_like, state.beta, ess_target_frac, P, red.ess)
    log_w = (new_beta - state.beta) * state.log_like
    log_z_inc = red.logsumexp(log_w) - math.log(P * 1.0)
    resampled = red.resample(draws.resample(), log_w, state.positions)

    def lp_fn(q):
        return log_prior_fn(q) + new_beta * log_like_fn(q)

    hs = hmc_init(lp_fn, resampled)
    eps = state.step_size
    unit = torch.ones(dim, dtype=eps.dtype, device=eps.device)
    for _ in range(num_mutations):
        hs, aps = hmc_kernel(lp_fn, hs, draws, eps, unit, num_leapfrog)
        # per-round step-size controller toward target_accept
        eps = eps * torch.exp(0.5 * (red.mean(aps) - target_accept))
    with torch.no_grad():
        new_log_like = log_like_fn(hs.position)
    return SMCState(hs.position, new_log_like, new_beta, state.log_z + log_z_inc, eps,
                    state.num_stages + 1)


def run_smc_staged(
    log_prior_fn: Callable,
    log_like_fn: Callable,
    init_positions,
    generator: Optional[torch.Generator] = None,
    num_mutations: int = 5,
    num_leapfrog: int = 16,
    ess_target_frac: float = 0.5,
    max_stages: int = 100,
    init_step_size: float = 0.1,
    target_accept: float = 0.65,
    progress: bool = False,
    draws=None,
    device=None,
    _red=_OneDevice(),
):
    """Adaptive-tempering SMC from the prior (`init_positions` (P, dim),
    prior draws) to the posterior, one stage a host iteration; `progress`
    prints beta after each stage.  Runs on the card unless
    `init_positions` is a tensor elsewhere or `device` says otherwise.

    Returns (final positions, info): log_z, the log marginal likelihood
    estimate sum_t log E[w_t]; num_stages; final_step_size; betas, the
    inverse temperature after each stage.  `_red` holds the statistics
    across particles (`parallel.sharded_smc.run_smc_sharded` passes its
    collectives); the stage loop's test reads beta, the same on every
    shard of a sharded run."""
    q0 = initial_positions(init_positions, device)
    P, dim = q0.shape
    if draws is None:
        draws = SMCDraws(generator, P, dim, q0.dtype, q0.device)
    scalar = lambda v: torch.as_tensor(v, dtype=q0.dtype, device=q0.device)  # noqa: E731
    with torch.no_grad():
        log_like0 = log_like_fn(q0)
    state = SMCState(q0, log_like0, scalar(0.0), scalar(0.0), scalar(init_step_size), 0)
    betas = []
    while state.num_stages < max_stages and float(state.beta) < 1.0:
        state = _stage(log_prior_fn, log_like_fn, state, draws, num_mutations, num_leapfrog,
                       ess_target_frac, target_accept, _red)
        betas.append(state.beta)
        if progress:
            print(f"smc stage {state.num_stages}: beta={float(state.beta):.4f}", flush=True)
    info = {"log_z": state.log_z, "num_stages": state.num_stages,
            "final_step_size": state.step_size,
            "betas": torch.stack(betas) if betas else q0.new_zeros(0)}
    return state.positions, info


def run_smc(log_prior_fn: Callable, log_like_fn: Callable, init_positions,
            generator: Optional[torch.Generator] = None, num_mutations: int = 5,
            num_leapfrog: int = 16, ess_target_frac: float = 0.5, max_stages: int = 100,
            init_step_size: float = 0.1, target_accept: float = 0.65, draws=None, device=None):
    """`run_smc_staged` without progress (the JAX package's device-loop
    form; here both are the same host loop)."""
    return run_smc_staged(log_prior_fn, log_like_fn, init_positions, generator, num_mutations,
                          num_leapfrog, ess_target_frac, max_stages, init_step_size,
                          target_accept, draws=draws, device=device)


def log_marginal_likelihood(log_prior_fn, log_like_fn, prior_sampler, generator,
                            num_particles=512, **smc_kwargs):
    """Sample the prior (`prior_sampler(generator, n)` -> (n, dim)), run SMC
    from there, return log Z."""
    init = prior_sampler(generator, num_particles)
    _, info = run_smc(log_prior_fn, log_like_fn, init, generator, **smc_kwargs)
    return info["log_z"]
