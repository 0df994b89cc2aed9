"""No-U-Turn Sampler over a leading chain axis: multinomial progressive
sampling (Betancourt 2017) with the iterative checkpoint U-turn scheme.

The JAX package's `infer/nuts.py` (`nuts_kernel`, `run_nuts`,
`run_nuts_multichain`).  There one chain's transition is two nested
`lax.while_loop`s that `vmap` runs for many chains; here the chains run in
lockstep with per-chain masks, the semantics `vmap` gives those loops: a
chain whose tree has stopped (U-turn, divergence, maximum depth) keeps its
state while the others go on, and its extra leapfrogs are computed and
discarded.  A pass of either loop that is not its last ends with one host
read (`active.any()`); `NUTSInfo.host_reads` counts them.

Outer loop: up to `max_depth` doublings; the doubling at depth d extends
the trajectory by 2^d leapfrog steps in a random direction, all chains
at the same depth.  Inner loop: one leapfrog a pass; the U-turn test of
every completed binary subtree uses O(max_depth) checkpoints: a span
[a, n] of 2^k leaves completes when (n + 1) % 2^k == 0, and its left
edge lives in checkpoint slot popcount(a).  The leaf index n is shared by
the chains, so slots and spans are host integers.

`run_nuts` over (C, dim) is also the JAX `run_nuts_multichain`: per-chain
step sizes and mass matrices; its dispatch segments (`segment_iters`, the
TPU worker's leapfrog budget) have no counterpart here.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..ops.linalg import cholesky
from .hmc import (
    GeneratorDraws,
    HMCState,
    adapted_inv_mass,
    da_init,
    da_update,
    find_reasonable_step_size,
    hmc_init,
    initial_positions,
    per_chain,
    value_and_grad,
    welford,
)

__all__ = ["NUTSInfo", "nuts_kernel", "run_nuts"]

MAX_DELTA_ENERGY = 1000.0


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # (C,) mean accept prob over the visited leaves
    num_steps: torch.Tensor  # (C,) leapfrog steps of this transition
    depth: torch.Tensor  # (C,) tree depth reached
    diverging: torch.Tensor  # (C,) bool
    step_size: torch.Tensor  # (C,)
    host_reads: int  # loop-exit reads of this transition
    leapfrogs: int  # lockstep leapfrog passes (each over all C chains)


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _vel(inv_mass, p):
    """Velocity M^-1 p.  inv_mass (dim,) or (C, dim) is a diagonal metric,
    (C, dim, dim) a dense one ("diag_e" / "dense_e")."""
    if inv_mass.ndim == 3:
        return (inv_mass @ p[..., None])[..., 0]
    return inv_mass * p


def _kinetic(inv_mass, p):
    return 0.5 * torch.sum(p * _vel(inv_mass, p), dim=-1)


def _sample_momentum(z, inv_mass):
    """p ~ N(0, M), M = inv_mass^-1, from standard normals z (C, dim):
    z / sqrt(inv_mass), or, dense, p = L^-T z with L = chol(inv_mass)."""
    if inv_mass.ndim != 3:
        return z / torch.sqrt(inv_mass)
    L = cholesky(inv_mass)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), z[..., None], upper=True)[..., 0]


def _where(mask, new, old):
    """Per-chain select of (C, ...) tensors by a (C,) mask."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def nuts_kernel(log_prob_fn: Callable, state: HMCState, draws, step_size, inv_mass,
                max_depth: int = 10):
    """One NUTS transition of every chain.  step_size a scalar or (C,);
    inv_mass a diagonal metric (dim,) or (C, dim), or a dense one (C, dim,
    dim).  Returns (HMCState, NUTSInfo)."""
    q0, lp0, g0 = state
    C, dim = q0.shape
    dev = q0.device
    eps = per_chain(step_size, C, lp0)
    p0 = _sample_momentum(draws.momentum(), inv_mass)
    energy0 = lp0 - _kinetic(inv_mass, p0)
    false = torch.zeros(C, dtype=torch.bool, device=dev)

    def leapfrog(q, p, g, e):
        p_half = p + 0.5 * e * g
        q_new = q + e * _vel(inv_mass, p_half)
        lp, g_new = value_and_grad(log_prob_fn, q_new)
        return q_new, p_half + 0.5 * e * g_new, g_new, lp

    tree = dict(
        q_left=q0, p_left=p0, g_left=g0, q_right=q0, p_right=p0, g_right=g0,
        q_prop=q0, lp_prop=lp0, g_prop=g0, rho=p0,
        log_w=torch.zeros_like(lp0),  # the initial point has weight exp(0)
        sum_accept=torch.zeros_like(lp0),
        num_leaves=torch.ones(C, dtype=torch.int64, device=dev),
        depth=torch.zeros(C, dtype=torch.int64, device=dev),
        turning=false, diverging=false,
    )
    reads = leapfrogs = 0
    for depth in range(max_depth):
        active = ~(tree["turning"] | tree["diverging"])
        if depth > 0:
            reads += 1
            if not bool(active.any()):
                break
        go_right = draws.direction(depth)
        e = torch.where(go_right, eps, -eps)[:, None]
        side = lambda name: _where(go_right, tree[f"{name}_right"], tree[f"{name}_left"])  # noqa: E731

        # ---- the subtree: 2^depth leapfrogs from the edge in direction e
        sub = dict(q=side("q"), p=side("p"), g=side("g"), psum=torch.zeros_like(p0),
                   q_prop=side("q"), lp_prop=torch.full_like(lp0, -math.inf), g_prop=side("g"),
                   log_w=torch.full_like(lp0, -math.inf), sum_accept=torch.zeros_like(lp0),
                   turning=false, diverging=false)
        ck_p = p0.new_zeros((C, max_depth + 1, dim))
        ck_psum = p0.new_zeros((C, max_depth + 1, dim))
        act = active
        for n in range(2**depth):
            q, p, g, lp = leapfrog(sub["q"], sub["p"], sub["g"], e)
            leapfrogs += 1
            delta = lp - _kinetic(inv_mass, p) - energy0
            delta = torch.where(torch.isnan(delta), -math.inf, delta)
            accept_p = torch.clamp(torch.exp(delta), max=1.0)
            # progressive multinomial proposal within the subtree
            log_w = torch.logaddexp(sub["log_w"], delta)
            take = act & (torch.log(draws.leaf(depth, n)) < delta - log_w)
            if n % 2 == 0:  # a span start: checkpoint its left edge
                slot = _popcount(n)
                ck_p[:, slot] = _where(act, p, ck_p[:, slot])
                ck_psum[:, slot] = _where(act, sub["psum"], ck_psum[:, slot])
            psum = sub["psum"] + p
            # U-turn of every span that completes at this leaf
            turn = false
            v_cur = _vel(inv_mass, p)
            for k in range(1, max_depth + 1):
                span = 2**k
                if (n + 1) % span or n + 1 < span:
                    continue
                a = _popcount(n + 1 - span)
                rho_span = psum - ck_psum[:, a]
                v_left = _vel(inv_mass, ck_p[:, a])
                turn = turn | (torch.sum(v_left * rho_span, -1) <= 0.0) | (
                    torch.sum(rho_span * v_cur, -1) <= 0.0)
            sub = dict(
                q=_where(act, q, sub["q"]), p=_where(act, p, sub["p"]),
                g=_where(act, g, sub["g"]), psum=_where(act, psum, sub["psum"]),
                q_prop=_where(take, q, sub["q_prop"]), lp_prop=torch.where(take, lp, sub["lp_prop"]),
                g_prop=_where(take, g, sub["g_prop"]),
                log_w=torch.where(act, log_w, sub["log_w"]),
                sum_accept=torch.where(act, sub["sum_accept"] + accept_p, sub["sum_accept"]),
                turning=sub["turning"] | (act & turn),
                diverging=sub["diverging"] | (act & (delta < -MAX_DELTA_ENERGY)),
            )
            act = act & ~(sub["turning"] | sub["diverging"])
            if n + 1 < 2**depth:
                reads += 1
                if not bool(act.any()):
                    break

        # ---- merge the subtree into the trajectory (chains still active)
        sub_ok = ~(sub["turning"] | sub["diverging"])
        take_new = active & sub_ok & (torch.log(draws.bias(depth)) < sub["log_w"] - tree["log_w"])
        new = dict(tree)
        for name in ("q", "g"):
            new[f"{name}_prop"] = _where(take_new, sub[f"{name}_prop"], tree[f"{name}_prop"])
        new["lp_prop"] = torch.where(take_new, sub["lp_prop"], tree["lp_prop"])
        for name in ("q", "p", "g"):  # the subtree's last state is the new edge
            new[f"{name}_left"] = _where(active & ~go_right, sub[name], tree[f"{name}_left"])
            new[f"{name}_right"] = _where(active & go_right, sub[name], tree[f"{name}_right"])
        rho = tree["rho"] + sub["psum"]
        v_l, v_r = _vel(inv_mass, new["p_left"]), _vel(inv_mass, new["p_right"])
        turning_total = (torch.sum(v_l * rho, -1) <= 0.0) | (torch.sum(v_r * rho, -1) <= 0.0)
        new["rho"] = _where(active, rho, tree["rho"])
        new["log_w"] = torch.where(active, torch.logaddexp(tree["log_w"], sub["log_w"]),
                                   tree["log_w"])
        new["sum_accept"] = torch.where(active, tree["sum_accept"] + sub["sum_accept"],
                                        tree["sum_accept"])
        new["num_leaves"] = tree["num_leaves"] + active * 2**depth
        new["depth"] = tree["depth"] + active
        new["turning"] = torch.where(active, sub["turning"] | (sub_ok & turning_total),
                                     tree["turning"])
        new["diverging"] = torch.where(active, sub["diverging"], tree["diverging"])
        tree = new

    n_lf = tree["num_leaves"] - 1
    info = NUTSInfo(
        accept_prob=tree["sum_accept"] / torch.clamp(n_lf.to(lp0.dtype), min=1.0),
        num_steps=n_lf,
        depth=tree["depth"],
        diverging=tree["diverging"],
        step_size=eps,
        host_reads=reads,
        leapfrogs=leapfrogs,
    )
    return HMCState(tree["q_prop"], tree["lp_prop"], tree["g_prop"]), info


def run_nuts(
    log_prob_fn: Callable,
    init_position,
    generator: Optional[torch.Generator] = None,
    num_warmup: int = 500,
    num_samples: int = 1000,
    max_depth: int = 10,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
    mass_adapt: bool = True,
    dense_mass: bool = False,
    draws=None,
    device=None,
    progress: Optional[Callable[[str, int], None]] = None,
):
    """NUTS with dual-averaging and mass-matrix warmup, every chain of
    `init_position` (C, dim) at once, each with its own step size and mass.

    Warmup as the JAX package's: unit metric, dual averaging throughout and
    Welford statistics of the second half; then the diagonal variance
    ("diag_e") or the covariance shrunk toward 1e-3 I ("dense_e",
    `dense_mass=True`) as the inverse mass; then num_warmup // 5 transitions
    re-adapting the step size under it.  Randomness from `draws` (default
    `GeneratorDraws` over `generator`).  `progress(phase, i)`, if given, is
    called after each transition.

    Returns (positions (C, num_samples, dim), info dict): accept_prob,
    log_prob, num_steps, diverging (C, num_samples); step_size (C,);
    inv_mass; warmup_accept_mean (C,); host_reads (int, loop exits read on
    the host); leapfrogs (lockstep passes, each over all chains)."""
    q0 = initial_positions(init_position, device)
    C, dim = q0.shape
    if draws is None:
        draws = GeneratorDraws(generator, C, dim, q0.dtype, q0.device)
    state = hmc_init(log_prob_fn, q0)
    inv_mass0 = torch.ones(dim, dtype=q0.dtype, device=q0.device)
    eps0, reads = find_reasonable_step_size(log_prob_fn, state, draws, inv_mass0, init_step_size)
    counts = {"host_reads": reads, "leapfrogs": 0}

    def step(st, eps, inv_mass, phase, i):
        st, info = nuts_kernel(log_prob_fn, st, draws, eps, inv_mass, max_depth)
        counts["host_reads"] += info.host_reads
        counts["leapfrogs"] += info.leapfrogs
        if progress is not None:
            progress(phase, i)
        return st, info

    half = num_warmup // 2
    da = da_init(eps0)
    mean = torch.zeros_like(q0)
    m2 = q0.new_zeros((C, dim, dim) if dense_mass else (C, dim))
    cnt = 0.0
    warm_aps = []
    for i in range(num_warmup):
        state, info = step(state, torch.exp(da.log_eps), inv_mass0, "warmup", i)
        da = da_update(da, info.accept_prob, target_accept)
        warm_aps.append(info.accept_prob)
        mean, m2, cnt = welford(mean, m2, cnt, state.position, i >= half, dense_mass)
    if mass_adapt and num_warmup > 10:
        inv_mass = adapted_inv_mass(m2, cnt, dense_mass)
    elif dense_mass:
        inv_mass = torch.eye(dim, dtype=q0.dtype, device=q0.device).expand(C, dim, dim)
    else:
        inv_mass = inv_mass0.expand(C, dim)

    da = da_init(torch.exp(da.log_eps_bar))
    for i in range(max(num_warmup // 5, 1)):
        state, info = step(state, torch.exp(da.log_eps), inv_mass, "readapt", i)
        da = da_update(da, info.accept_prob, target_accept)
    eps_final = torch.exp(da.log_eps_bar)

    positions = q0.new_empty((C, num_samples, dim))
    out = {k: q0.new_empty((C, num_samples)) for k in ("accept_prob", "log_prob")}
    out["num_steps"] = torch.empty((C, num_samples), dtype=torch.int64, device=q0.device)
    out["diverging"] = torch.empty((C, num_samples), dtype=torch.bool, device=q0.device)
    for s in range(num_samples):
        state, info = step(state, eps_final, inv_mass, "sample", s)
        positions[:, s] = state.position
        out["accept_prob"][:, s], out["log_prob"][:, s] = info.accept_prob, state.log_prob
        out["num_steps"][:, s], out["diverging"][:, s] = info.num_steps, info.diverging
    out.update(
        step_size=eps_final,
        inv_mass=inv_mass,
        warmup_accept_mean=torch.stack(warm_aps).mean(0) if warm_aps else None,
        **counts,
    )
    return positions, out
