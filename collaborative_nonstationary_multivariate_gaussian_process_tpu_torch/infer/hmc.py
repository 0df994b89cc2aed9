"""Hamiltonian Monte Carlo with window adaptation (step size + diagonal mass),
over a leading chain axis.

The JAX package's `infer/hmc.py`.  There the transition is a pure function
of one chain that `vmap` batches; here every function takes the chains on
a leading axis, positions (C, dim), and a log-density `log_prob_fn(q)`
that maps (C, dim) to (C,) (every density of `models.logdensities` does).
Gradients are `torch.autograd.grad(lp.sum(), q)`: the chains are
independent, so that is each chain's gradient.

Randomness comes from a `draws` object (see `GeneratorDraws`, the default
over a `torch.Generator`); a test passes an object with the same methods
that replays the JAX package's key splits.  A per-chain while-loop of the
JAX package becomes a masked loop: a chain that has stopped keeps its
state, and the loop ends when no chain is active (one host read a pass).

A gradient (`value_and_grad`) is the span `hmc.gradient` (attribute
`chains`), its forward `logdensity.value` and its backward
`logdensity.backward` (`utils.profiling.span`, recorded while a profiler
records).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..config import DEFAULT_DTYPE, resolve_device
from ..utils import profiling

__all__ = [
    "HMCState",
    "DualAveragingState",
    "GeneratorDraws",
    "value_and_grad",
    "da_init",
    "da_update",
    "hmc_init",
    "hmc_kernel",
    "find_reasonable_step_size",
    "run_hmc",
]


class HMCState(NamedTuple):
    position: torch.Tensor  # (C, dim)
    log_prob: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, dim)


class DualAveragingState(NamedTuple):
    """Nesterov dual averaging toward `target_accept` (Hoffman & Gelman
    2014, Algorithm 5), one per chain."""

    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    step: torch.Tensor


class GeneratorDraws:
    """The samplers' standard draws from a `torch.Generator`, afresh at every
    call and for every chain (a stopped chain's draws are discarded).

    The methods are the injection points: `momentum()` the (C, dim) standard
    normals of a transition; `accept()` HMC's accept uniforms (C,);
    `direction(depth)`, `bias(depth)` NUTS's direction bits and merge
    uniforms of a doubling; `leaf(depth, n)` its uniform at leaf n."""

    def __init__(self, generator: torch.Generator, chains: int, dim: int, dtype, device):
        self.generator = generator
        self.shape = (chains, dim)
        self.dtype, self.device = dtype, device

    def _uniform(self):
        return torch.rand(self.shape[:1], generator=self.generator, dtype=self.dtype,
                          device=self.device)

    def momentum(self):
        return torch.randn(self.shape, generator=self.generator, dtype=self.dtype,
                           device=self.device)

    def accept(self):
        return self._uniform()

    def direction(self, depth):
        return self._uniform() < 0.5

    def bias(self, depth):
        return self._uniform()

    def leaf(self, depth, n):
        return self._uniform()


class _FixedDraws:
    """The same momentum and accept uniforms at every call
    (`find_reasonable_step_size` reuses one key for every trial)."""

    def __init__(self, draws):
        self._z, self._u = draws.momentum(), draws.accept()

    def momentum(self):
        return self._z

    def accept(self):
        return self._u


def value_and_grad(log_prob_fn: Callable, q):
    """(log_prob_fn(q) (C,), its gradient (C, dim)), both detached."""
    with profiling.span("hmc.gradient", chains=q.shape[0] if q.ndim > 1 else 1):
        q = q.detach().requires_grad_(True)
        with torch.enable_grad():
            with profiling.span("logdensity.value"):
                lp = log_prob_fn(q)
            with profiling.span("logdensity.backward"):
                (g,) = torch.autograd.grad(lp.sum(), q)
        return lp.detach(), g


def per_chain(value, chains: int, like):
    """A scalar or (C,) step size as a (C,) tensor like `like`."""
    return torch.as_tensor(value, dtype=like.dtype, device=like.device).expand(chains)


def initial_positions(init_position, device=None, dtype=None):
    """(C, dim) positions: a tensor as given (its device and dtype), else
    an array put on `device` (the card unless the CPU is asked for)."""
    if isinstance(init_position, torch.Tensor):
        return init_position
    return torch.as_tensor(init_position, dtype=DEFAULT_DTYPE if dtype is None else dtype,
                           device=resolve_device(device))


def da_init(eps0):
    log_eps = torch.log(eps0)
    zero = torch.zeros_like(log_eps)
    return DualAveragingState(log_eps, zero, zero, math.log(10.0) + log_eps, zero)


def da_update(state: DualAveragingState, accept_prob, target=0.8):
    t0, gamma, kappa = 10.0, 0.05, 0.75
    step = state.step + 1.0
    eta_h = 1.0 / (step + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_prob)
    log_eps = state.mu - torch.sqrt(step) / gamma * h_bar
    eta = step**-kappa
    log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar
    return DualAveragingState(log_eps, log_eps_bar, h_bar, state.mu, step)


def hmc_init(log_prob_fn: Callable, position) -> HMCState:
    lp, g = value_and_grad(log_prob_fn, position)
    return HMCState(position.detach(), lp, g)


def _leapfrog(log_prob_fn, state: HMCState, momentum, eps, inv_mass, num_steps):
    """Static-length leapfrog; eps (C, 1), inv_mass diagonal."""
    q, p, g = state.position, momentum, state.grad
    lp = state.log_prob
    for _ in range(num_steps):
        p_half = p + 0.5 * eps * g
        q = q + eps * inv_mass * p_half
        lp, g = value_and_grad(log_prob_fn, q)
        p = p_half + 0.5 * eps * g
    return q, p, g, lp


def hmc_kernel(log_prob_fn: Callable, state: HMCState, draws, step_size, inv_mass,
               num_steps: int):
    """One Metropolis-adjusted HMC transition of every chain.  step_size a
    scalar or (C,); inv_mass (dim,) or (C, dim).  Returns (state,
    accept_prob (C,))."""
    C = state.position.shape[0]
    eps = per_chain(step_size, C, state.log_prob)[:, None]
    p0 = torch.sqrt(1.0 / inv_mass) * draws.momentum()  # p ~ N(0, M), M = 1 / inv_mass
    q_new, p_new, g_new, lp_new = _leapfrog(log_prob_fn, state, p0, eps, inv_mass, num_steps)
    ke0 = 0.5 * torch.sum(inv_mass * p0**2, dim=-1)
    ke1 = 0.5 * torch.sum(inv_mass * p_new**2, dim=-1)
    log_ratio = (lp_new - ke1) - (state.log_prob - ke0)
    log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio, -math.inf)
    accept_prob = torch.clamp(torch.exp(log_ratio), max=1.0)
    accept = draws.accept() < accept_prob
    new_state = HMCState(
        position=torch.where(accept[:, None], q_new, state.position),
        log_prob=torch.where(accept, lp_new, state.log_prob),
        grad=torch.where(accept[:, None], g_new, state.grad),
    )
    return new_state, accept_prob


def find_reasonable_step_size(log_prob_fn, state: HMCState, draws, inv_mass, init_eps=1.0):
    """Heuristic initial step size of every chain (Hoffman & Gelman 2014,
    Algorithm 4): halve or double until the one-step accept probability
    crosses 1/2, at most 50 times.  One draw of momentum and uniform serves
    every trial, as one key does in the JAX package.  Returns (eps (C,),
    host reads)."""
    fixed = _FixedDraws(draws)
    C = state.position.shape[0]

    def one_step_accept(eps):
        return hmc_kernel(log_prob_fn, state, fixed, eps, inv_mass, 1)[1]

    eps = per_chain(init_eps, C, state.log_prob).clone()
    ap = one_step_accept(eps)
    up = ap > 0.5
    direction = torch.where(up, 2.0, 0.5).to(eps.dtype)
    active = torch.ones(C, dtype=torch.bool, device=eps.device)
    reads = 0
    for it in range(51):  # the JAX loop stops at it = 50 whatever the trial says
        active = active & torch.where(up, ap > 0.5, ap < 0.5)
        reads += 1
        if it == 50 or not bool(active.any()):
            break
        eps = torch.where(active, eps * direction, eps)
        ap = one_step_accept(eps)
    return eps, reads


def welford(mean, m2, cnt, x, in_window, dense):
    """One Welford update of the per-chain mean and (co)variance sums by x
    (C, dim) when `in_window`: m2 (C, dim), or (C, dim, dim) if dense."""
    cnt = cnt + (1.0 if in_window else 0.0)
    if not in_window:
        return mean, m2, cnt
    delta = x - mean
    mean = mean + delta / max(cnt, 1.0)
    if dense:
        m2 = m2 + delta[:, :, None] * (x - mean)[:, None, :]
    else:
        m2 = m2 + delta * (x - mean)
    return mean, m2, cnt


def adapted_inv_mass(m2, cnt, dense=False):
    """The inverse mass from Welford sums of `cnt` draws: the variance
    (a tiny one replaced by 1), or, dense, the covariance shrunk toward
    1e-3 I by cnt / (cnt + 5)."""
    denom = max(cnt - 1.0, 1.0)
    if dense:
        w = cnt / (cnt + 5.0)
        eye = torch.eye(m2.shape[-1], dtype=m2.dtype, device=m2.device)
        return w * (m2 / denom) + (1e-3 * (1.0 - w)) * eye
    var = m2 / denom
    return torch.where(var > 1e-10, var, 1.0)


def run_hmc(
    log_prob_fn: Callable,
    init_position,
    generator: Optional[torch.Generator] = None,
    num_warmup: int = 500,
    num_samples: int = 1000,
    num_steps: int = 32,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
    thin: int = 1,
    mass_adapt: bool = True,
    draws=None,
    device=None,
):
    """HMC with warmup, every chain of `init_position` (C, dim) at once.

    Warmup: dual averaging of the step size throughout and a Welford
    variance of the second half for the diagonal mass matrix, then a
    re-adaptation of the step size under that mass (num_warmup // 4
    transitions).  Randomness from `draws` (default `GeneratorDraws` over
    `generator`).  Returns (positions (C, num_samples, dim), info dict)."""
    q0 = initial_positions(init_position, device)
    C, dim = q0.shape
    if draws is None:
        draws = GeneratorDraws(generator, C, dim, q0.dtype, q0.device)
    state = hmc_init(log_prob_fn, q0)
    inv_mass0 = torch.ones(dim, dtype=q0.dtype, device=q0.device)
    eps0, reads = find_reasonable_step_size(log_prob_fn, state, draws, inv_mass0, init_step_size)

    half = num_warmup // 2
    da = da_init(eps0)
    mean, m2, cnt = torch.zeros_like(q0), torch.zeros_like(q0), 0.0
    warm_aps = []
    for i in range(num_warmup):
        state, ap = hmc_kernel(log_prob_fn, state, draws, torch.exp(da.log_eps), inv_mass0,
                               num_steps)
        da = da_update(da, ap, target_accept)
        mean, m2, cnt = welford(mean, m2, cnt, state.position, i >= half, dense=False)
        warm_aps.append(ap)

    if mass_adapt and num_warmup > 10:
        inv_mass = adapted_inv_mass(m2, cnt)
    else:
        inv_mass = inv_mass0.expand(C, dim)
    da = da_init(torch.exp(da.log_eps_bar))
    for _ in range(max(num_warmup // 4, 1)):
        state, ap = hmc_kernel(log_prob_fn, state, draws, torch.exp(da.log_eps), inv_mass,
                               num_steps)
        da = da_update(da, ap, target_accept)
    eps_final = torch.exp(da.log_eps_bar)

    positions = q0.new_empty((C, num_samples, dim))
    aps, lps = q0.new_empty((C, num_samples)), q0.new_empty((C, num_samples))
    for s in range(num_samples):
        for _ in range(thin):
            state, ap = hmc_kernel(log_prob_fn, state, draws, eps_final, inv_mass, num_steps)
        positions[:, s], aps[:, s], lps[:, s] = state.position, ap, state.log_prob
    info = {
        "accept_prob": aps,
        "log_prob": lps,
        "step_size": eps_final,
        "inv_mass": inv_mass,
        "warmup_accept_mean": torch.stack(warm_aps).mean(0) if warm_aps else None,
        "host_reads": reads,
    }
    return positions, info
