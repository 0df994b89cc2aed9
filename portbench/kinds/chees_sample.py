"""ChEES-HMC sampling of the whitened SVC posterior at fixed tuning
(`infer/chees.chees_sample`).

The data are the reference study's simulated series (`data.sim_mnts` at the
configuration's size and data seed); the density is the port's
`svc_log_posterior_whitened` over the port's whitening factors of that
data.  The tuning (step size, trajectory length, diagonal inverse mass) is
fixed data (`portbench/traffic/<tuning>.json`, written once by
`portbench/tools/chees_tuning.py`), so every iteration's leapfrog count is
ceil(h_i T / eps) with h_i the Halton point of its index: set by the tuning
and the iteration's place, never by the seed.  Chains start at the tuning
run's final positions (chain c at position c mod their number) plus
`start_jitter` of the posterior scale from the seed.  A unit of the window
is one `chees_sample` call of `iterations_per_call` iterations, the state
carried from call to call, the Halton offset advancing.

The momenta and accept uniforms come from the benchmark's own draws object,
which keeps its generator's state before each iteration.  The check draws a
sample of the window's iterations from the seed, with the longest among
them, and replays each from the port's own state at its start in the
plain reference in float64 with the same draws: the leapfrog count, the
accept decision (where the reference's log ratio lies farther than
`margin` from log u), and the new positions (the summed squared jumps and
each moved chain's distance from the reference's new position).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from portbench import data, work
from portbench.reference import svc as ref

PACKAGE = Path(__file__).resolve().parents[1]


def _port():
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import chees, hmc
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
        logdensities,
    )

    return chees, hmc, logdensities


def tuning_file(traffic: dict, root=None) -> dict:
    """The fixed tuning the mix names, `portbench/traffic/<tuning>.json`."""
    base = PACKAGE if root is None else Path(root) / PACKAGE.name
    return json.loads((base / "traffic" / f"{traffic['tuning']}.json").read_text())


def problem(cfg, dev, dtype=torch.float64):
    """The study's data as tensors: x (N,), Y (N, 2)."""
    x, Y = data.sim_mnts(cfg["N"], cfg["data_seed"], cfg["sigma2_err"])
    return torch.as_tensor(x, dtype=dtype, device=dev), torch.as_tensor(Y, dtype=dtype, device=dev)


def port_density(cfg, dev):
    """The port's whitened log density (C, dim) -> (C,) in float32 on `dev`."""
    _, _, ld = _port()
    h = cfg["hypers"]
    x, Y = problem(cfg, dev, torch.float32)
    chol_l, chol_L = ld.svc_whiten_chols(x, h["alpha_tilde_l"], h["beta_tilde_l"], h["alpha_L"],
                                         h["beta_L"])

    def lp(q):
        return ld.svc_log_posterior_whitened(q, Y, x, chol_l, chol_L, mu_tilde_l=h["mu_tilde_l"],
                                             mu_L=h["mu_L"], a=h["a"], b=h["b"])

    return lp


def reference_density(cfg, dev, dtype=torch.float64):
    """The plain reference's log density in `dtype`, its whitening factors
    worked out again with the configuration's prior jitters."""
    h = cfg["hypers"]
    x, Y = problem(cfg, dev, dtype)
    chol_l, chol_L = ref.prior_chols(
        x, ((h["alpha_tilde_l"], h["beta_tilde_l"]), (h["alpha_L"], h["beta_L"])),
        (cfg["prior_jitter"]["tilde_l"], cfg["prior_jitter"]["L"]))
    return lambda q: ref.log_posterior(q, Y, x, chol_l, chol_L, h, cfg["mcmc_jitter"])


class Draws:
    """Momenta and accept uniforms from the benchmark's generator; keeps the
    generator's state before each iteration's momentum."""

    def __init__(self, gen, chains, dim, dtype, dev):
        self.gen, self.shape, self.dtype, self.dev = gen, (chains, dim), dtype, dev
        self.states = []

    def momentum(self):
        self.states.append(self.gen.get_state())
        return torch.randn(self.shape, generator=self.gen, dtype=self.dtype, device=self.dev)

    def accept(self):
        return torch.rand(self.shape[:1], generator=self.gen, dtype=self.dtype, device=self.dev)

    def replay(self, i):
        """The (z, u) of iteration i, drawn again."""
        g = torch.Generator(device=self.dev)
        g.set_state(self.states[i])
        z = torch.randn(self.shape, generator=g, dtype=self.dtype, device=self.dev)
        return z, torch.rand(self.shape[:1], generator=g, dtype=self.dtype, device=self.dev)


class Cell:
    slice_units = 1  # one call under the profiler

    def __init__(self, cfg, traffic, limits, seed, device, root=None):
        self.cfg, self.traffic, self.limits, self.dev = cfg, traffic, limits, device
        self.seed_start, self.seed_draws, self.seed_check = data.seeds(seed, 3)
        self.tuning = tuning_file(traffic, root)
        self.C, self.K = traffic["chains"], traffic["iterations_per_call"]

    def setup(self):
        chees, hmc, _ = _port()
        dev, t = self.dev, self.tuning
        self.lp = port_density(self.cfg, dev)
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        self.tune = chees.CheesTuning(f32(t["step_size"]), f32(t["log_traj_length"]),
                                      f32(t["inv_mass"]))
        warm = f32(t["positions"])
        dim = warm.shape[1]
        gen = torch.Generator(device=dev).manual_seed(self.seed_start)
        z = torch.randn((self.C, dim), generator=gen, dtype=torch.float32, device=dev)
        q0 = warm[torch.arange(self.C, device=dev) % warm.shape[0]] \
            + self.traffic["start_jitter"] * torch.sqrt(self.tune.inv_mass) * z
        lp0, g0 = hmc.value_and_grad(self.lp, q0)
        self.state = chees.CheesState(q0, lp0, g0)
        self.draws = Draws(torch.Generator(device=dev).manual_seed(self.seed_draws), self.C, dim,
                           torch.float32, dev)
        self.offset = t["halton_offset"]
        self.calls = []  # (start state, positions, info, final state) of each call
        self._chees = chees
        self.unit(keep=False)  # every shape warm

    def unit(self, keep=True):
        start = self.state
        state, pos, info = self._chees.chees_sample(
            self.lp, start, self.tune, num_samples=self.K, halton_offset=self.offset,
            draws=self.draws)
        n_iter0 = len(self.draws.states) - self.K
        self.offset += self.K
        self.state = state
        lp = info["log_prob"]
        bad = int((~torch.isfinite(lp)).sum())  # waits for the call's last iteration
        if keep:
            self.calls.append(dict(start=start, pos=pos, info=info, end=state, first=n_iter0,
                                   offset=self.offset - self.K))
        return {"draws": self.C * self.K, "leapfrogs": int(info["leapfrogs"]),
                "iterations": self.K, "nonfinite": bad}

    def summarize(self, records, wall):
        draws = sum(r["draws"] for r in records)
        return {"attempted": draws, "failed": sum(r["nonfinite"] for r in records),
                "metrics": {"sample_draws_per_s": draws / wall}}

    def describe_work(self):
        t, c = self.tuning, self.cfg
        steps = [int(n) for call in self.calls for n in call["info"]["num_steps"]]
        ops, least = work.total(work.svc_gradient(self.C, c["N"], c["outputs"]))
        return [f"work: fixed tuning step size {t['step_size']!r}, trajectory length "
                f"{math.exp(t['log_traj_length'])!r}; {len(steps)} iterations in the window took "
                f"{sum(steps)} leapfrogs ({sum(steps) / max(len(steps), 1):.3f} a draw of "
                f"{self.C} chains, from {min(steps)} to {max(steps)})",
                f"work: a gradient of {self.C} chains counts {ops:.6e} kernel operations, least "
                f"time {least * 1e3:.6f} ms"]

    def release(self):
        self.lp = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def sample(self):
        """The window's iterations to replay, (call, k): the one with the
        most leapfrogs and `check_iterations` - 1 more drawn from the seed."""
        its = [(j, k) for j, c in enumerate(self.calls) for k in range(self.K)]
        steps = [int(self.calls[j]["info"]["num_steps"][k]) for j, k in its]
        longest = int(np.argmax(steps))
        rng = np.random.default_rng(self.seed_check)
        rest = [i for i in range(len(its)) if i != longest]
        n = min(self.traffic["check_iterations"] - 1, len(rest))
        picked = [longest] + list(rng.choice(rest, size=n, replace=False))
        return [its[i] for i in picked]

    def replay_numbers(self, lp_ref, program=None):
        """The compared numbers over the sampled iterations, each replayed
        from the port's position at its start with the same draws.
        `program`, if given, maps (start position (C, dim), z, u, eps,
        inv_mass, steps) to the position after the iteration and stands in
        for the port (a control or a planted fault).

        steps_mismatch: the most by which an iteration's leapfrog count
        differs from ceil(h T / eps).  flip_share: the share of accept
        decisions (moved or not) that differ from the reference's, of those
        whose log ratio lies farther than `margin` from log u.  jump_gap: the
        gap of the chains' summed squared jumps from the reference's,
        relative.  move_gap: over the chains that both sides moved, the
        median of each chain's distance from the reference's new position
        over the reference's jump."""
        t, dev = self.tuning, self.dev
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        eps32 = torch.exp(torch.log(f32(t["step_size"])))
        T32 = torch.exp(f32(t["log_traj_length"]))
        eps, inv_mass = float(eps32), f32(t["inv_mass"]).double()
        steps_mismatch, flips, judged, jump_got, jump_ref, moves = 0, 0, 0, 0.0, 0.0, []
        for j, k in self.sample():
            call = self.calls[j]
            q0 = (call["start"].position if k == 0 else call["pos"][:, k - 1]).double()
            h = f32(ref.halton(1, call["offset"] + k)[0])
            n = int(min(max(float(torch.ceil(h * T32 / eps32)), 1.0), 1024.0))
            steps_mismatch = max(steps_mismatch, abs(int(call["info"]["num_steps"][k]) - n))
            z, u = self.draws.replay(call["first"] + k)
            _, log_ratio, new_ref, _ = ref.transition(lp_ref, q0, z.double(), u.double(), eps,
                                                      inv_mass, n)
            got = (call["pos"][:, k] if program is None
                   else program(q0, z, u, eps, inv_mass, n)).double()
            moved = (got != q0).any(-1)
            log_u = u.double().log()
            accepted = log_u < log_ratio
            clear = (log_ratio - log_u).abs() > self.traffic["margin"]
            flips += int((clear & (moved != accepted)).sum())
            judged += int(clear.sum())
            jump_got += float(((got - q0) ** 2).sum())
            jump_ref += float(((new_ref - q0) ** 2).sum())
            both = moved & accepted
            moves.append(torch.linalg.vector_norm(got - new_ref, dim=-1)[both]
                         / torch.linalg.vector_norm(new_ref - q0, dim=-1)[both])
        moves = torch.cat(moves)
        return {"steps_mismatch": float(steps_mismatch), "flip_share": flips / max(judged, 1),
                "jump_gap": abs(jump_got - jump_ref) / jump_ref if jump_ref > 0 else float("inf"),
                "move_gap": float(moves.median()) if moves.numel() else 0.0}

    def control(self, reading):
        """The numbers of the plain reference in float32 (`reading` "f32"), in
        float32 with TF32 products ("tf32"), or in float32 with a planted
        fault ("short": the proposal one leapfrog short; "bias": each moved
        chain's new position off by a tenth of the posterior scale) put in
        the port's place."""
        tf32 = reading == "tf32"
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            lp32 = reference_density(self.cfg, self.dev, torch.float32)

            def program(q0, z, u, eps, inv_mass, n):
                q0, inv_mass = q0.float(), inv_mass.float()
                _, _, new, _ = ref.transition(lp32, q0, z, u, eps, inv_mass,
                                              max(n - 1, 1) if reading == "short" else n)
                if reading == "bias":
                    moved = (new != q0).any(-1, keepdim=True)
                    new = torch.where(moved, new + 0.1 * torch.sqrt(inv_mass), new)
                return new

            return self.replay_numbers(reference_density(self.cfg, self.dev), program)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def numbers_of_port(self):
        return self.replay_numbers(reference_density(self.cfg, self.dev))

    def check(self):
        nums = self.numbers_of_port()
        return {k: {"value": nums[k], "limit": v} for k, v in self.limits.items()}
