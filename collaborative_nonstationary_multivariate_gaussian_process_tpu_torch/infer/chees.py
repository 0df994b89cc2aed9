"""ChEES-HMC: jittered fixed-length HMC with cross-chain adaptation
(Hoffman, Radul & Sountsov 2021), over a leading chain axis.

The JAX package's `infer/chees.py`.  Every chain runs the SAME number of
leapfrog steps an iteration, and that shared trajectory length is adapted
from cross-chain statistics:

  - trajectory length t_i = h_i T, with h_i a base-2 Halton jitter shared by
    all chains;
  - T maximizes the ChEES criterion E[(|q' - E q'|^2 - |q - E q|^2)^2] by
    Adam on log T, the gradient estimated from the chains themselves;
  - step size: dual averaging on the cross-chain mean acceptance (target
    0.651 for fixed-length HMC);
  - diagonal mass matrix: pooled cross-chain variance of the second half of
    the warmup.

The step count of an iteration, ceil(t_i / eps) clipped to
[1, max_num_steps], is one scalar all chains share: it is read on the host
once an iteration (`host_reads`), and the leapfrogs then run as a plain
loop over all chains with no mask and no further read.  Every cross-chain
mean goes through one `cmean` callable (default: the mean over dim 0).

Randomness comes from a `draws` object with `momentum()` (the (C, dim)
standard normals of an iteration) and `accept()` (its (C,) uniforms), the
default `infer.hmc.GeneratorDraws`; a test passes one that replays the JAX
key splits.  The JAX package's dispatch segments (its TPU worker's
leapfrog budget) have no counterpart here.

Spans (`utils.profiling.span`, recorded while a profiler records): a
`chees_warmup` or `chees_sample` call is the root `chees.call` (attributes
`iterations`, `chains`); in it each iteration `chees.iteration` (attribute
`leapfrogs`), its host read of the step count `chees.steps_read` (where
the host waits for the card), each leapfrog `hmc.leapfrog` (half kick,
drift, gradient, half kick) and the Metropolis correction with the ChEES
statistic `chees.accept`.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils import profiling
from .hmc import (
    DualAveragingState,
    GeneratorDraws,
    da_init,
    da_update,
    initial_positions,
    value_and_grad,
)

__all__ = [
    "CheesState",
    "CheesTuning",
    "CheesCarry",
    "halton_sequence",
    "init_carry",
    "finish_mass",
    "make_phase",
    "chees_warmup",
    "chees_sample",
    "run_chees",
]


def halton_sequence(n: int, offset: int = 0) -> np.ndarray:
    """Points offset..offset+n of the base-2 Halton (van der Corput) sequence
    in (0, 1): bit-reversed binary fractions (a copy of the JAX package's)."""
    out = np.zeros(n)
    for i in range(n):
        f, r, k = 0.5, 0.0, offset + i + 1
        while k > 0:
            r += f * (k & 1)
            k >>= 1
            f *= 0.5
        out[i] = r
    return out


class CheesState(NamedTuple):
    position: torch.Tensor  # (C, dim)
    log_prob: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, dim)


class CheesTuning(NamedTuple):
    """Adapted sampler constants: returned by `chees_warmup`, taken by
    `chees_sample`."""

    step_size: torch.Tensor  # ()
    log_traj_length: torch.Tensor  # ()
    inv_mass: torch.Tensor  # (dim,)


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    step: torch.Tensor


class CheesCarry(NamedTuple):
    """The adaptation loop's state; m1, m2 sum the cross-chain means of q
    and q^2 over the window's iterations, cnt counts them."""

    state: CheesState
    da: DualAveragingState
    adam: AdamState
    log_T: torch.Tensor  # ()
    inv_mass: torch.Tensor  # (dim,)
    m1: torch.Tensor  # (dim,)
    m2: torch.Tensor  # (dim,)
    cnt: torch.Tensor  # ()


def _chain_mean(x):
    return x.mean(dim=0)


def _adam_update(s: AdamState, g, lr=0.025, b1=0.9, b2=0.999, eps=1e-8):
    step = s.step + 1.0
    m = b1 * s.m + (1.0 - b1) * g
    v = b2 * s.v + (1.0 - b2) * g * g
    mhat = m / (1.0 - b1**step)
    vhat = v / (1.0 - b2**step)
    return AdamState(m, v, step), lr * mhat / (torch.sqrt(vhat) + eps)


def _num_steps(traj_len, eps, max_num_steps: int) -> int:
    """clip(ceil(traj_len / eps), 1, max_num_steps), read on the host; a NaN
    ratio counts as 0 (and so 1 step), as the JAX int32 cast has it."""
    ratio = torch.ceil(traj_len / eps)
    with profiling.span("chees.steps_read"):
        n = float(ratio)
    if math.isnan(n):
        n = 0.0
    return int(min(max(n, 1.0), float(max_num_steps)))


def _chees_kernel(log_prob_fn, state: CheesState, draws, eps, traj_len, inv_mass,
                  max_num_steps: int, cmean):
    """One joint transition of all chains: n = ceil(traj_len / eps) leapfrog
    steps (one host read), a Metropolis correction per chain, and the
    cross-chain ChEES gradient of the trajectory length.  Returns (state,
    accept_prob (C,), mean accept (), ChEES gradient (), n)."""
    sd = torch.sqrt(1.0 / inv_mass)
    p0 = sd * draws.momentum()
    num_steps = _num_steps(traj_len, eps, max_num_steps)

    q, p, g, lp = state.position, p0, state.grad, state.log_prob
    for _ in range(num_steps):
        with profiling.span("hmc.leapfrog"):
            p_half = p + 0.5 * eps * g
            q = q + eps * (inv_mass * p_half)
            lp, g = value_and_grad(log_prob_fn, q)
            p = p_half + 0.5 * eps * g

    with profiling.span("chees.accept"):
        new_state, accept_prob, mean_accept, chees_grad_t = _accept(
            state, draws, q, p, p0, lp, g, inv_mass, cmean)
    return new_state, accept_prob, mean_accept, chees_grad_t, num_steps


def _accept(state: CheesState, draws, q, p, p0, lp, g, inv_mass, cmean):
    """The Metropolis correction of each chain's proposal (q, p, lp, g) and
    the cross-chain ChEES gradient: (state, accept_prob, mean accept,
    ChEES gradient)."""
    ke0 = 0.5 * torch.sum(inv_mass * p0**2, dim=-1)
    ke1 = 0.5 * torch.sum(inv_mass * p**2, dim=-1)
    log_ratio = (lp - ke1) - (state.log_prob - ke0)
    log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio, -math.inf)
    accept_prob = torch.clamp(torch.exp(log_ratio), max=1.0)
    accept = draws.accept() < accept_prob
    new_state = CheesState(
        position=torch.where(accept[:, None], q, state.position),
        log_prob=torch.where(accept, lp, state.log_prob),
        grad=torch.where(accept[:, None], g, state.grad),
    )

    # d/dt E[(|dq'|^2 - |dq|^2)^2] is proportional to E[(|dq'|^2 - |dq|^2)
    # dq'^T v'], estimated across the chains weighted by acceptance
    dq1 = q - cmean(q)[None, :]
    dq0 = state.position - cmean(state.position)[None, :]
    v1 = inv_mass * p
    per_chain = (torch.sum(dq1 * dq1, -1) - torch.sum(dq0 * dq0, -1)) * torch.sum(dq1 * v1, -1)
    finite = torch.isfinite(per_chain)
    w = torch.where(finite, accept_prob, 0.0)
    per_chain = torch.where(finite, per_chain, 0.0)
    chees_grad_t = cmean(w * per_chain) / torch.clamp(cmean(w), min=1e-10)
    return new_state, accept_prob, cmean(accept_prob), chees_grad_t


def make_phase(log_prob_fn, cmean, max_num_steps, target_accept, adam_lr, adapt):
    """One iteration, `phase(carry, h, draws, in_window) -> (carry, out)`.
    Adapting (warmup): dual averaging, Adam on log T, the Welford window
    sums; `out` is the accept probabilities.  Fixed (sampling): `out` is
    (position, accept_prob, log_prob, num_steps)."""

    def phase(carry: CheesCarry, h, draws, in_window: bool):
        with profiling.span("chees.iteration") as iteration:
            carry, out = step(carry, h, draws, in_window)
            iteration.set(leapfrogs=out[-1])
        return carry, out

    def step(carry: CheesCarry, h, draws, in_window: bool):
        eps = torch.exp(carry.da.log_eps)
        traj = h * torch.exp(carry.log_T)
        st, aps, mean_acc, chees_g, nsteps = _chees_kernel(
            log_prob_fn, carry.state, draws, eps, traj, carry.inv_mass, max_num_steps, cmean)
        da, adam, log_T = carry.da, carry.adam, carry.log_T
        m1, m2, cnt = carry.m1, carry.m2, carry.cnt
        if adapt:
            da = da_update(da, mean_acc, target_accept)
            # chain rule through t = h e^{log T}: dt / dlog T = t
            adam, delta = _adam_update(adam, -chees_g * traj, lr=adam_lr)
            log_T = log_T - delta  # Adam minimizes; flipped for ascent
            # keep the trajectory reachable under the step-size cap
            log_T = torch.clamp(log_T, min=da.log_eps - 2.0,
                                max=da.log_eps + math.log(float(max_num_steps)))
            if in_window:
                m1 = m1 + cmean(st.position)
                m2 = m2 + cmean(st.position**2)
                cnt = cnt + 1.0
        new_carry = CheesCarry(st, da, adam, log_T, carry.inv_mass, m1, m2, cnt)
        if adapt:
            return new_carry, (aps, nsteps)
        return new_carry, (st.position, aps, st.log_prob, nsteps)

    return phase


def _zero_adam(like):
    z = torch.zeros_like(like)
    return AdamState(z, z, z)


def init_carry(log_prob_fn, init_positions, init_step_size, init_traj_length,
               dtype=None) -> CheesCarry:
    """The initial carry (log-probs and gradients evaluated once at the
    start points).  The step size, the trajectory length, the Adam state,
    the mass matrix and the window sums are in `dtype` (the JAX call form,
    `init_carry(..., init_traj_length, dtype)`), by default the positions'
    dtype; the state keeps the positions' own."""
    q = init_positions
    lp0, g0 = value_and_grad(log_prob_fn, q)
    dtype = q.dtype if dtype is None else dtype
    scalar = lambda v: torch.as_tensor(v, dtype=dtype, device=q.device)  # noqa: E731
    zeros_d = torch.zeros(q.shape[1], dtype=dtype, device=q.device)
    return CheesCarry(CheesState(q.detach(), lp0, g0), da_init(scalar(init_step_size)),
                      _zero_adam(scalar(0.0)), torch.log(scalar(init_traj_length)),
                      torch.ones(q.shape[1], dtype=dtype, device=q.device), zeros_d, zeros_d,
                      scalar(0.0))


def finish_mass(carry: CheesCarry, mass_adapt: bool) -> CheesCarry:
    """Between the warmup phases: the pooled mass matrix from the window
    sums (a variance at or below 1e-10 replaced by 1), and dual averaging
    restarted at the averaged step size."""
    inv_mass = carry.inv_mass
    if mass_adapt:
        mean = carry.m1 / torch.clamp(carry.cnt, min=1.0)
        var = carry.m2 / torch.clamp(carry.cnt, min=1.0) - mean**2
        inv_mass = torch.where(var > 1e-10, var, 1.0)
    da = da_init(torch.exp(carry.da.log_eps_bar))
    return CheesCarry(carry.state, da, carry.adam, carry.log_T, inv_mass,
                      0.0 * carry.m1, 0.0 * carry.m2, 0.0 * carry.cnt)


def _draws_for(draws, generator, q):
    if draws is not None:
        return draws
    return GeneratorDraws(generator, q.shape[0], q.shape[1], q.dtype, q.device)


def chees_warmup(
    log_prob_fn: Callable,
    init_positions,
    generator: Optional[torch.Generator] = None,
    num_warmup: int = 500,
    target_accept: float = 0.651,
    init_step_size: float = 0.1,
    init_traj_length: Optional[float] = None,
    max_num_steps: int = 1024,
    adam_lr: float = 0.025,
    mass_adapt: bool = True,
    cmean: Optional[Callable] = None,
    draws=None,
    device=None,
    progress: Optional[Callable[[str, int], None]] = None,
):
    """The adaptation phases: `num_warmup` iterations under a unit metric
    (the window sums over their second half), the mass matrix, then
    max(num_warmup // 4, 1) iterations re-adapting under it;
    `progress(phase, i)`, if given, is called after each.  Returns
    (CheesState, CheesTuning, info): info holds warmup_accept_mean (the
    mean accept probability of the first phase), halton_offset (where
    sampling resumes the jitter), host_reads and leapfrogs."""
    with profiling.span("chees.call", iterations=num_warmup + max(num_warmup // 4, 1)) as call:
        q0 = initial_positions(init_positions, device)
        call.set(chains=q0.shape[0])
        cmean = _chain_mean if cmean is None else cmean
        draws = _draws_for(draws, generator, q0)
        if init_traj_length is None:
            init_traj_length = float(init_step_size)
        n_re = max(num_warmup // 4, 1)
        halton = torch.as_tensor(halton_sequence(num_warmup + n_re), dtype=q0.dtype,
                                 device=q0.device)
        carry = init_carry(log_prob_fn, q0, init_step_size, init_traj_length)
        phase = make_phase(log_prob_fn, cmean, max_num_steps, target_accept, adam_lr, True)

        half = num_warmup // 2
        warm_aps, leapfrogs = [], 0
        for i in range(num_warmup):
            carry, (aps, n) = phase(carry, halton[i], draws, i >= half)
            warm_aps.append(aps)
            leapfrogs += n
            if progress is not None:
                progress("warmup", i)
        carry = finish_mass(carry, mass_adapt and num_warmup > 10)
        for i in range(n_re):
            carry, (_, n) = phase(carry, halton[num_warmup + i], draws, False)
            leapfrogs += n
            if progress is not None:
                progress("re-adaptation", i)
        tuning = CheesTuning(torch.exp(carry.da.log_eps_bar), carry.log_T, carry.inv_mass)
        info = {
            "warmup_accept_mean": torch.stack(warm_aps).mean() if warm_aps else None,
            "halton_offset": num_warmup + n_re,
            "host_reads": num_warmup + n_re,
            "leapfrogs": leapfrogs,
        }
        return carry.state, tuning, info


def chees_sample(
    log_prob_fn: Callable,
    state: CheesState,
    tuning: CheesTuning,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 1000,
    halton_offset: int = 0,
    max_num_steps: int = 1024,
    cmean: Optional[Callable] = None,
    draws=None,
    progress: Optional[Callable[[str, int], None]] = None,
):
    """`num_samples` iterations at fixed tuning, the Halton jitter resumed
    at `halton_offset`; `progress("sampling", i)`, if given, is called after
    each, i its Halton index.  Two calls with advancing offsets (and the
    draws continuing) give the draws of one call.  Returns (state,
    positions (C, num_samples, dim), info): accept_prob and log_prob (C,
    num_samples), num_steps (num_samples,) ints, host_reads, leapfrogs."""
    with profiling.span("chees.call", iterations=num_samples, chains=state.position.shape[0]):
        q = state.position
        cmean = _chain_mean if cmean is None else cmean
        draws = _draws_for(draws, generator, q)
        halton = torch.as_tensor(halton_sequence(num_samples, offset=halton_offset), dtype=q.dtype,
                                 device=q.device)
        phase = make_phase(log_prob_fn, cmean, max_num_steps, 0.651, 0.0, False)
        zeros_d = q.new_zeros(q.shape[1])
        carry = CheesCarry(state, da_init(tuning.step_size), _zero_adam(tuning.step_size),
                           tuning.log_traj_length, tuning.inv_mass, zeros_d, zeros_d,
                           torch.zeros_like(tuning.step_size))
        C, dim = q.shape
        positions = q.new_empty((C, num_samples, dim))
        aps, lps = q.new_empty((C, num_samples)), q.new_empty((C, num_samples))
        nsteps = []
        for s in range(num_samples):
            carry, (positions[:, s], aps[:, s], lps[:, s], n) = phase(carry, halton[s], draws,
                                                                      False)
            nsteps.append(n)
            if progress is not None:
                progress("sampling", halton_offset + s)
        info = {"accept_prob": aps, "log_prob": lps,
                "num_steps": torch.tensor(nsteps, dtype=torch.int64), "host_reads": num_samples,
                "leapfrogs": sum(nsteps)}
        return carry.state, positions, info


def run_chees(
    log_prob_fn: Callable,
    init_positions,
    generator: Optional[torch.Generator] = None,
    num_warmup: int = 500,
    num_samples: int = 1000,
    target_accept: float = 0.651,
    init_step_size: float = 0.1,
    init_traj_length: Optional[float] = None,
    max_num_steps: int = 1024,
    adam_lr: float = 0.025,
    mass_adapt: bool = True,
    cmean: Optional[Callable] = None,
    draws=None,
    device=None,
):
    """ChEES-HMC over jointly-updated chains (warmup, then sampling), every
    chain of `init_positions` (C, dim) at once.  Runs on the card unless
    `init_positions` is a tensor elsewhere or `device` says otherwise.

    Returns (positions (C, num_samples, dim), info): accept_prob, log_prob
    (C, num_samples); num_steps (num_samples,); step_size,
    trajectory_length (); inv_mass (dim,); warmup_accept_mean; host_reads
    and leapfrogs of the whole run."""
    state, tuning, winfo = chees_warmup(
        log_prob_fn, init_positions, generator, num_warmup=num_warmup,
        target_accept=target_accept, init_step_size=init_step_size,
        init_traj_length=init_traj_length, max_num_steps=max_num_steps, adam_lr=adam_lr,
        mass_adapt=mass_adapt, cmean=cmean, draws=draws, device=device)
    _, positions, info = chees_sample(
        log_prob_fn, state, tuning, generator, num_samples,
        halton_offset=winfo["halton_offset"], max_num_steps=max_num_steps, cmean=cmean,
        draws=draws)
    info = dict(info)
    info["step_size"] = tuning.step_size
    info["trajectory_length"] = torch.exp(tuning.log_traj_length)
    info["inv_mass"] = tuning.inv_mass
    info["warmup_accept_mean"] = winfo["warmup_accept_mean"]
    info["host_reads"] += winfo["host_reads"]
    info["leapfrogs"] += winfo["leapfrogs"]
    return positions, info
