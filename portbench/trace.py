"""The traced slice of a `--trace 1` run: `torch.profiler` over a bounded
steady slice of the window, reduced to device busy time, the top device
operations and the idle gaps labelled by what the host was doing.

The profiler is this package's own use of `torch.profiler`, not the port's
`utils/profiling.trace`.  Its window opens `LEAD_S` before the slice on
probe kernels (`torch.cuda._sleep`), the last of them launched right
before the slice: a profiler that drops the first part of its window drops
probes first, and a trace that lacks the last probe has lost the slice's
first kernels, which fails the run.
"""

from __future__ import annotations

import bisect
import contextlib
import time
import warnings
from collections import defaultdict

import torch

LEAD_S = 1.0
LEAD_PROBES = 50
PROBE_CYCLES = 20_000
SLICE_NAME = "portbench.slice"
TOP = 10


class Slice:
    """What a traced slice gives the per-layer metrics: `window_s` (the
    slice's length on the host), `busy_s` (union of device activity within
    it), `device_ops` and `idle_gaps` ([name, seconds], longest first)."""

    def __init__(self, window_s, busy_s, device_ops, idle_gaps):
        self.window_s, self.busy_s = window_s, busy_s
        self.device_ops, self.idle_gaps = device_ops, idle_gaps


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(cpu, starts, t):
    """The innermost host range open at time t (ns), else "host"."""
    i = bisect.bisect_right(starts, t) - 1
    best = None
    for j in range(i, max(i - 400, -1), -1):
        s, e, name = cpu[j]
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "host"


def _annotation(e) -> bool:
    """A host range mirrored on the device's timeline (the slice's, the
    profiler's step), not device work."""
    marked = getattr(e, "is_user_annotation", None)
    return e.name() == SLICE_NAME or e.name().startswith("ProfilerStep#") or bool(
        marked is not None and marked())


def reduce(events, cuda: bool) -> Slice:
    """Reduce the profiler's kineto events of one slice."""
    dev_type = torch.autograd.DeviceType.CUDA
    rng = [(e.start_ns(), e.end_ns()) for e in events if e.name() == SLICE_NAME]
    if not rng:
        raise RuntimeError(f"the trace holds no {SLICE_NAME!r} range")
    t0, t1 = rng[0]
    dev, cpu, probes = [], [], 0
    for e in events:
        if e.device_type() == dev_type:
            if _annotation(e):
                continue
            if "spin_kernel" in e.name() and e.end_ns() <= t0:
                probes += 1
            elif e.end_ns() > t0 and e.start_ns() < t1:
                dev.append((max(e.start_ns(), t0), min(e.end_ns(), t1), e.name()))
        elif t0 <= e.start_ns() <= t1 and e.name() != SLICE_NAME:
            cpu.append((e.start_ns(), e.end_ns(), e.name()))
    if cuda and probes == 0:
        raise RuntimeError("the trace lost the slice's first kernels: no lead probe is left")
    if cuda and not dev:
        raise RuntimeError("the trace holds no device activity in the slice")
    busy = _merge([(s, e) for s, e, _ in dev])
    by_name = defaultdict(float)
    for s, e, name in dev:
        by_name[name] += (e - s) * 1e-9
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps[_label(cpu, starts, (s + e) // 2)] += (e - s) * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return Slice((t1 - t0) * 1e-9, sum(e - s for s, e in busy) * 1e-9, top(by_name), top(gaps))


@contextlib.contextmanager
def traced(out: dict):
    """Profile the body as one slice; `out["slice"]` gets its `Slice`."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        if cuda:
            torch.cuda._sleep(PROBE_CYCLES)
            torch.cuda.synchronize()
        prof.step()
        if cuda:
            for _ in range(LEAD_PROBES):
                torch.cuda._sleep(PROBE_CYCLES)
                torch.cuda.synchronize()
                time.sleep(LEAD_S / LEAD_PROBES)
        with record_function(SLICE_NAME):
            yield
            if cuda:
                torch.cuda.synchronize()
    out["slice"] = reduce(prof.profiler.kineto_results.events(), cuda)
