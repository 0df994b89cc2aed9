"""DSVI training through the port's fused trainer (`infer/dsvi.make_scan_epochs`).

Set-up builds one trainer (the model's starting weights from the seed,
Adam, the freeze mask of the fixed length scales), captures its graphs,
drives its first `CHECK_STEPS` steps one replay at a time through the same
graphs and buffers the window replays (recording what the check compares),
then warms up with one whole epoch.  A unit of the window is one call of
the trainer for one epoch, its losses read on the host.  The window runs
fits of `epochs_per_fit` epochs back to back, each from the set-up's
starting state (the parameters, Adam's moments and counts reset in place,
where the graphs read them).

The check follows those first steps in the plain reference in float64 from
the same starting weights, the same shuffle and the same noise (drawn again
from the draws' seed in the trainer's draw order) and compares each step's
loss, and the median leaf's norm of the first gradient as Adam received it
(its first moment after one step over 1 - b1) and of its change after the
steps.  A leaf whose reference gradient is under `SILENT` of the median
leaf's moves by round-off alone and is left out.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import data, work
from portbench.reference import cnmgp as ref

CHECK_STEPS = 3
SILENT = 1e-3
B1, B2, EPS = 0.9, 0.999, 1e-8


def _port():
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp

    return dsvi, cnmgp


class Cell:
    slice_units = 1  # one epoch under the profiler

    def __init__(self, cfg, traffic, limits, seed, device, root=None):
        self.cfg, self.traffic, self.limits, self.dev = cfg, traffic, limits, device
        self.root = root
        self.seed_w, self.seed_d = data.seeds(seed, 2)
        self.fit_epochs, self.epochs = traffic["epochs_per_fit"], 0

    def setup(self):
        dsvi, cnmgp = _port()
        cfg, dev = self.cfg, self.dev
        x, y, idx, Z = data.observations(cfg, dev, root=self.root)
        n, B = x.shape[0], cfg["B"]
        self.nb = -(-n // B)
        w = data.cnmgp_weights(cfg, self.seed_w, dev)
        self.start = {k: v.clone() for k, v in w.items()}
        params = cnmgp.init_params(torch.Generator(device=dev).manual_seed(0), cfg["D"], cfg["M"],
                                   device=dev, **{k: w[k] for k in cnmgp.CNMGPParams._fields[:6]})
        params = dsvi.apply_hyperpars(params, {k: w[k] for k in cfg["log_hyperpars"]})
        params = cnmgp.CNMGPParams(*(t.requires_grad_(True) for t in params))
        self.p0 = [p.detach().clone() for p in params]
        self.mask = dsvi.freeze_mask(params, bool(cfg["frozen"]))
        self.opt = dsvi.make_optimizer(params, "adam", cfg["lr"])
        self.run = dsvi.make_scan_epochs(self.opt, float(n), cfg["jitter"], self.nb, B)
        self.params, self.inputs = params, (Z, x, y, idx)
        self.gen = torch.Generator(device=dev).manual_seed(self.seed_d)
        self.first = self._first_steps()
        self.unit()  # a whole epoch: every replay warm
        self._restart()  # the window's first fit starts afresh

    def _call(self, n_epochs):
        Z, x, y, idx = self.inputs
        return self.run(self.params, self.mask, Z, x, y, idx, self.gen, n_epochs)

    def _first_steps(self):
        """The first CHECK_STEPS steps through the window's own trainer: on a
        card one replay of its step graph at a time after its shuffle graph;
        on the CPU (one batch an epoch) one epoch a step.  Returns the losses,
        Adam's first moment after step 1 and the parameters after the last."""
        losses, m1 = [], None
        if self.dev.type == "cuda":
            self._call(0)  # captures the graphs, replays nothing
            (graphs,) = self.run.graphs.values()
            graphs.shuffle_graph.replay()
        elif self.nb != 1:
            raise ValueError("on the CPU the check steps need one batch an epoch")
        for k in range(CHECK_STEPS):
            if self.dev.type == "cuda":
                graphs.step_graph.replay()
            else:
                losses.append(float(self._call(1)[0]))
            if k == 0:
                # Adam's first moment; none where the step left the optimizer untouched
                m1 = [self.opt.state[p].get("exp_avg", torch.zeros_like(p)).detach().clone()
                      for p in self.params]
        if self.dev.type == "cuda":
            losses = [float(v) for v in graphs.losses[:CHECK_STEPS]]
        return dict(losses=losses, m1=m1, after=[p.detach().clone() for p in self.params])

    def _restart(self):
        """A new fit from the starting state, in place."""
        with torch.no_grad():
            for p, p0 in zip(self.params, self.p0):
                p.copy_(p0)
                for v in self.opt.state.get(p, {}).values():
                    if torch.is_tensor(v):
                        v.zero_()
            self.run.step.count.zero_()
        self.epochs = 0

    def unit(self):
        if self.epochs == self.fit_epochs:
            self._restart()
        self.epochs += 1
        losses = self._call(1).cpu()
        return {"steps": int(losses.numel()), "nonfinite": int((~torch.isfinite(losses)).sum())}

    def summarize(self, records, wall):
        steps = sum(r["steps"] for r in records)
        return {"attempted": steps, "failed": sum(r["nonfinite"] for r in records),
                "metrics": {"train_steps_per_s": steps / wall}}

    def describe_work(self):
        c = self.cfg
        ops, least = work.total(work.dsvi_step(c["D"], c["M"], c["B"]))
        return [f"work: a DSVI step counts {ops:.6e} kernel operations, least time "
                f"{least * 1e3:.6f} ms (D={c['D']} M={c['M']} B={c['B']}, {self.nb} steps an epoch)"]

    def release(self):
        self.run = self.opt = self.params = self.mask = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def reference_steps(self, dtype=torch.float64, rows_kept=1.0):
        """The first CHECK_STEPS steps of the plain reference in `dtype`:
        (losses, the first masked gradient per leaf, the parameters after).
        `rows_kept` below 1 leaves the rest of each batch out, its mean taken
        over the rows kept (a fault, planted for the check's own test)."""
        cfg, dev = self.cfg, self.dev
        x, y, idx, Z = (t.to(dtype) if t.is_floating_point() else t
                        for t in data.observations(cfg, dev, root=self.root))
        n, B, D, M = x.shape[0], cfg["B"], cfg["D"], cfg["M"]
        gen = torch.Generator(device=dev).manual_seed(self.seed_d)
        if self.nb > 1:
            order = torch.sort(data.sort_keys(gen, n), stable=True).indices
        else:
            order = torch.arange(n, device=dev)
        p = {k: self.start[k].to(dtype).clone().requires_grad_(True) for k in ref.FIELDS}
        frozen = set(cfg["frozen"])
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v = {k: torch.zeros_like(t) for k, t in p.items()}
        losses, g1 = [], None
        for t in range(1, CHECK_STEPS + 1):
            rows = order[(t - 1) * B:t * B] if self.nb > 1 else order
            nz = {k: z.to(dtype) for k, z in data.train_noise(gen, M, rows.shape[0], D).items()}
            w = torch.ones(rows.shape[0], dtype=dtype, device=dev)
            w[int(rows_kept * rows.shape[0]):] = 0.0
            loss = ref.negative_selbo(p, Z, x[rows], y[rows], idx[rows], w, float(n), nz,
                                      cfg["jitter"])
            grads = torch.autograd.grad(loss, [p[k] for k in ref.FIELDS])
            losses.append(loss.item())
            with torch.no_grad():
                step = {}
                for k, g in zip(ref.FIELDS, grads):
                    g = torch.where(torch.isfinite(g), g, 0.0) * (0.0 if k in frozen else 1.0)
                    step[k] = g
                    m[k] = B1 * m[k] + (1 - B1) * g
                    v[k] = B2 * v[k] + (1 - B2) * g * g
                    mhat, vhat = m[k] / (1 - B1**t), v[k] / (1 - B2**t)
                    p[k] -= cfg["lr"] * mhat / (torch.sqrt(vhat) + EPS)
                if t == 1:
                    g1 = step
        return losses, g1, {k: t.detach() for k, t in p.items()}

    def numbers(self, got, want):
        """The compared numbers of a run `got` (losses, first gradient, the
        parameters after) against the reference `want`: the steps' losses,
        and the median leaf's first-gradient norm and change in norm."""
        (l_got, g_got, p_got), (l_ref, g_ref, p_ref) = got, want
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l_got, l_ref))
        norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
        gn = {k: norm(g_ref[k]) for k in ref.FIELDS}
        med_g = float(np.median(list(gn.values())))
        moved = [k for k in ref.FIELDS if gn[k] >= SILENT * med_g]
        start = {k: self.start[k].double() for k in moved}
        med_g_kept = float(np.median([gn[k] for k in moved]))
        med_d = float(np.median([norm(p_ref[k] - start[k]) for k in moved]))
        return {"loss_gap": loss_gap,
                "median_grad_gap": abs(float(np.median([norm(g_got[k]) for k in moved]))
                                       - med_g_kept) / med_g_kept,
                "median_change_gap": abs(float(np.median([norm(p_got[k] - start[k])
                                                          for k in moved])) - med_d) / med_d}

    def program_outputs(self):
        f = self.first
        g1 = {k: mk / (1 - B1) for k, mk in zip(ref.FIELDS, f["m1"])}
        return f["losses"], g1, dict(zip(ref.FIELDS, f["after"]))

    def control(self, reading):
        """The numbers of the plain reference in float32 (`reading` "f32"),
        in float32 with TF32 products ("tf32"), or in float32 with half of
        each batch left out ("half", a fault) put in the port's place."""
        tf32 = reading == "tf32"
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            got = self.reference_steps(torch.float32, 0.5 if reading == "half" else 1.0)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        return self.numbers(got, self.reference_steps())

    def numbers_of_port(self):
        return self.numbers(self.program_outputs(), self.reference_steps())

    def check(self):
        nums = self.numbers_of_port()
        return {k: {"value": nums[k], "limit": v} for k, v in self.limits.items()}
