"""Serving a fitted CNMGP through the port's entry points (`models/predict`):
a closed loop with one caller, which sends its next request when the last
result is on the host.

The model's weights are drawn from the seed at the configuration's widths
(`data.cnmgp_weights`, as the trainer starts from them).  The mix is a
fixed cycle of `cycle` requests, `predict_share` of them `predict_Y` (the
plug-in mean) and the rest `sample_Y` with `sample_draws` draws (credible
bands); each kind's query sizes B are the quantiles of a log-uniform law
on [b_min, b_max], so every seed serves the same sizes, in an order drawn
from the seed anew each cycle.  A request's B points are spread over
random outputs at random inputs on the data's input range and go in as
NumPy; a `sample_Y` request passes a seed drawn from the benchmark's seed,
and the port draws its normals inside the call, `draws_per_chunk` draws at
a time, as a caller's request runs.  A unit of the window is one request,
timed from the call to its result (the posterior mean, or the y draws) on
the host.

The check draws a sample of the window's requests from the seed, with the
longest of each kind among them, and computes them again in the plain
reference in float64 from the same weights and inputs: a `predict_Y`
request's mean, and `check_draws` of a `sample_Y` request's draws (drawn
from the seed), their normals drawn again from the request's seed in the
port's draw order (`data.predictive_noise`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import data
from portbench.reference import cnmgp as ref


def _port():
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
        cnmgp,
        predict,
    )

    return dsvi, cnmgp, predict


def request_sizes(traffic):
    """The cycle's (kind, B) pairs in a fixed order."""
    n = traffic["cycle"]
    n_pred = int(round(traffic["predict_share"] * n))

    def quantiles(k):
        u = (np.arange(k) + 0.5) / k
        lo, hi = np.log(traffic["b_min"]), np.log(traffic["b_max"])
        return np.rint(np.exp(lo + u * (hi - lo))).astype(int)

    return [("predict", int(b)) for b in quantiles(n_pred)] + [
        ("sample", int(b)) for b in quantiles(n - n_pred)]


class Cell:
    slice_units = 100  # a whole cycle of the mix under the profiler

    def __init__(self, cfg, traffic, limits, seed, device, root=None):
        self.cfg, self.traffic, self.limits, self.dev = cfg, traffic, limits, device
        self.root = root
        self.seed_w, self.seed_order, self.seed_req, self.seed_check = data.seeds(seed, 4)
        self.sizes = request_sizes(traffic)
        self.rng = np.random.default_rng(self.seed_order)
        self.queue, self.served, self.count = [], [], 0

    def setup(self):
        dsvi, cnmgp, predict = _port()
        cfg, dev = self.cfg, self.dev
        self.predict = predict
        self.w = data.cnmgp_weights(cfg, self.seed_w, dev)
        params = cnmgp.init_params(torch.Generator(device=dev).manual_seed(0), cfg["D"], cfg["M"],
                                   device=dev, **{k: self.w[k] for k in cnmgp.CNMGPParams._fields[:6]})
        self.params = dsvi.apply_hyperpars(params, {k: self.w[k] for k in cfg["log_hyperpars"]})
        self.Z = data.observations(cfg, dev, root=self.root)[3]
        for kind, b in self.sizes:  # every shape of the mix once
            self._call(kind, self._inputs(b, np.random.default_rng(b)), draws=16)

    def _inputs(self, b, rng):
        """B points over random outputs, as the port takes them: one NumPy
        array of sorted inputs an output."""
        D, x_max = self.cfg["D"], self.cfg["data"]["x_max"]
        out = rng.integers(0, D, b)
        xs = rng.uniform(0.0, float(x_max), b)
        return [np.sort(xs[out == d]).astype(np.float32) for d in range(D)]

    def _call(self, kind, X, draws=None, seed=0):
        if kind == "predict":
            return self.predict.predict_Y(self.params, self.Z, X, jitter=self.cfg["jitter"],
                                          device=self.dev).cpu().numpy()
        return self.predict.sample_Y(self.params, self.Z, X, n_sample=draws or self.traffic[
            "sample_draws"], seed=seed, jitter=self.cfg["jitter"], draws_per_chunk=self.traffic[
            "draws_per_chunk"], device=self.dev)[0].cpu().numpy()

    def unit(self):
        if not self.queue:
            self.queue = [self.sizes[i] for i in self.rng.permutation(len(self.sizes))]
        kind, b = self.queue.pop()
        i = self.count
        self.count += 1
        rng = np.random.default_rng([self.seed_req, i])  # the request's inputs and seed
        X, seed = self._inputs(b, rng), int(rng.integers(2**62))
        t0 = time.perf_counter()
        got = self._call(kind, X, seed=seed)
        ms = 1e3 * (time.perf_counter() - t0)
        self.served.append(dict(i=i, kind=kind, b=b, X=X, seed=seed, got=got))
        return {"requests": 1, "kind": kind, "b": b, "ms": ms,
                "nonfinite": int(not np.all(np.isfinite(got)))}

    def summarize(self, records, wall):
        ms = np.array([r["ms"] for r in records])
        return {"attempted": len(records), "failed": sum(r["nonfinite"] for r in records),
                "metrics": {"serve_p95_ms": float(np.percentile(ms, 95))}}

    def describe_work(self):
        c, t = self.cfg, self.traffic
        sizes = [b for _, b in self.sizes]
        return [f"work: a cycle of {len(self.sizes)} requests, {t['predict_share']:.0%} predict_Y, "
                f"sample_Y with {t['sample_draws']} draws; B from {min(sizes)} to {max(sizes)} "
                f"(D={c['D']} M={c['M']}); {self.count} requests in the window"]

    def release(self):
        self.params = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def sample(self):
        """The served requests to compute again: the longest of each kind and
        `check_requests` - 2 more drawn from the seed."""
        picked = set()
        for kind in ("predict", "sample"):
            mine = [s for s in self.served if s["kind"] == kind]
            if mine:
                picked.add(max(mine, key=lambda s: s["b"])["i"])
        rng = np.random.default_rng(self.seed_check)
        rest = [s["i"] for s in self.served if s["i"] not in picked]
        n = min(max(self.traffic["check_requests"] - len(picked), 0), len(rest))
        picked |= set(int(i) for i in rng.choice(rest, size=n, replace=False))
        return [s for s in self.served if s["i"] in picked]

    def reference_answer(self, s, draws, dtype=torch.float64):
        """The reference's answer to served request `s`: the mean (B,), or
        the y draws (len(draws), B) of the given draw indices."""
        p = {k: self.w[k].to(dtype) for k in ref.FIELDS}
        Z = self.Z.to(dtype)
        x = torch.as_tensor(np.concatenate(s["X"]), dtype=dtype, device=self.dev)
        idx = torch.as_tensor(np.concatenate([np.full(len(a), d) for d, a in enumerate(s["X"])]),
                              device=self.dev)
        if s["kind"] == "predict":
            return ref.predict_y(p, Z, x, idx, self.cfg["jitter"]).cpu().numpy()
        t = self.traffic
        noise = data.predictive_noise(s["seed"], t["sample_draws"], self.cfg["M"], s["b"],
                                      self.cfg["D"], t["draws_per_chunk"], draws, self.dev)
        out = []
        for d in range(len(draws)):  # one at a time: the reference holds (G, B, M) products
            nz = {k: noise[k][d:d + 1].to(dtype) for k in ref.NOISE}
            out.append(ref.sample_y(p, Z, x, idx, nz, self.cfg["jitter"]).cpu().numpy())
        return np.concatenate(out)

    def answer_gaps(self, answer):
        """{answer_gap}: the widest gap of an answer (a `predict_Y` mean or a
        `sample_Y` draw) from the reference's over the sampled requests,
        relative to the largest reference value of that request.
        `answer(s, draws)` gives the answer under test (the served one, or a
        control's)."""
        gap = 0.0
        rng = np.random.default_rng(self.seed_check + 1)
        for s in self.sample():
            draws = (None if s["kind"] == "predict" else np.sort(rng.choice(
                self.traffic["sample_draws"], self.traffic["check_draws"], replace=False)))
            want = self.reference_answer(s, draws)
            got = answer(s, draws)
            gap = max(gap, float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
                      if got.shape == want.shape and np.all(np.isfinite(got)) else float("inf"))
        return {"answer_gap": gap}

    def control(self, reading):
        """The gaps of the plain reference in float32 (`reading` "f32") or in
        float32 with TF32 products ("tf32") answering in the port's place."""
        tf32 = reading == "tf32"
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            return self.answer_gaps(lambda s, draws: self.reference_answer(s, draws, torch.float32))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def numbers_of_port(self):
        return self.answer_gaps(lambda s, draws: s["got"] if draws is None else s["got"][draws])

    def check(self):
        nums = self.numbers_of_port()
        return {k: {"value": nums[k], "limit": v} for k, v in self.limits.items()}
