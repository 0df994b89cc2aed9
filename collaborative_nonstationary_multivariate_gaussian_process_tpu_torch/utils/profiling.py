"""Lightweight observability: phase timers, memory probe, profiler hooks.

The JAX package's `utils/profiling.py`.  The reference times named phases
with `time.time()` deltas under `verbose` (nmgp_dsvi.py:161-260) and prints
the process's RSS beside its periodic ELBO probe (`print_mem`,
nmgp_dsvi.py:26-32).  This module keeps both, and adds the card's side:
`torch.profiler` traces with CUDA activity, the CUDA caching allocator's
counters, the FLOPs of a call and the card's peak rate.

None of these functions initializes CUDA: on a process that has not used
the card they report the host alone.  A `PhaseTimer` around work on the
card measures the host's enqueue unless the phase ends in a
`torch.cuda.synchronize()`.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

__all__ = [
    "PhaseTimer",
    "rss_mb",
    "print_mem",
    "trace",
    "device_memory_stats",
    "flops_of",
    "peak_flops_per_s",
]


def rss_mb() -> float:
    """Resident-set size of this process in MiB (reference `print_mem`,
    nmgp_dsvi.py:26-32, without the psutil dependency)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) / 1024.0
    return float("nan")


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def print_mem(epoch: Optional[int] = None) -> float:
    """Print and return the RSS in MiB (the reference prints it beside the
    periodic ELBO probe, nmgp_dsvi.py:888); where this process has used a
    CUDA card, the line also gives the allocator's allocated and peak MiB
    on the current device, in place of the TPU's live-buffer bytes."""
    mb = rss_mb()
    prefix = f"epoch: {epoch}, " if epoch is not None else ""
    line = f"{prefix}memory usage: {mb:.1f} MiB"
    if _cuda_in_use():
        line += (f", cuda allocated {torch.cuda.memory_allocated() / 2**20:.1f} MiB, "
                 f"peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(line)
    return mb


@dataclass
class PhaseTimer:
    """Named-phase wall-clock accumulator.

        timer = PhaseTimer(verbose=True)
        with timer.phase("reparameterization"):
            ...
        timer.report()

    Matches the reference's per-phase verbose prints (nmgp_dsvi.py:161-260)
    but accumulates across entries so epoch loops aggregate for free.
    """

    verbose: bool = False
    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    _order: List[str] = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self.totals:
                self.totals[name] = 0.0
                self.counts[name] = 0
                self._order.append(name)
            self.totals[name] += dt
            self.counts[name] += 1
            if self.verbose:
                print(f"{name} costs {dt:.4f}s")

    def report(self) -> str:
        lines = [
            f"{name}: {self.totals[name]:.4f}s over {self.counts[name]} calls"
            for name in self._order
        ]
        out = "\n".join(lines)
        if self.verbose and out:
            print(out)
        return out


# The recorded window of `trace` opens `CUDA_LEAD_S` before its region on a
# card, filled with `CUDA_LEAD_PROBES` probe kernels (`spin_kernel`, from
# `torch.cuda._sleep`), each waited for, and one last probe of about
# `CUDA_TAIL_CYCLES` cycles that the region's first kernels queue behind.
CUDA_LEAD_S = 3.0
CUDA_LEAD_PROBES = 300
CUDA_PROBE_CYCLES = 20_000
CUDA_TAIL_CYCLES = 20_000_000
# The host range around the region in the trace.
REGION_NAME = "profiling.trace"


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace a region with `torch.profiler` (host activity, and CUDA
    activity where a card is present) and write it as a Chrome trace,
    `log_dir/trace_<pid>.json` (viewable in Perfetto or chrome://tracing).
    Yields the profiler; its `key_averages()` sums the device time by
    kernel.  The region is the host range `REGION_NAME`.  The port's own
    kernels are launched through ctypes, past the PyTorch dispatcher: the
    trace holds their device activity (CUPTI sees every launch) but no
    operator of them on the host.

    On a card the profiler warms up on a throw-away launch, and the
    recorded window opens `CUDA_LEAD_S` before the region, on probe kernels
    spread over that time and a last one that keeps the card busy until
    the region's kernels follow it.  Late in a long process the profiler
    drops the kernels of a window's first 0.2-0.9 s on the H100 (whole runs
    of `chip_smoke.py`: a 0.2 s idle lead lost the region's first 16
    kernels once; of a 1 s lead of 100 probes, the first 834 ms were lost).
    The probes take that loss, and their count in the trace shows it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=activities, schedule=schedule) as prof:
        if cuda:
            torch.cuda._sleep(CUDA_PROBE_CYCLES)
            torch.cuda.synchronize()
        prof.step()
        if cuda:
            for _ in range(CUDA_LEAD_PROBES):
                torch.cuda._sleep(CUDA_PROBE_CYCLES)
                torch.cuda.synchronize()
                time.sleep(CUDA_LEAD_S / CUDA_LEAD_PROBES)
            torch.cuda._sleep(CUDA_TAIL_CYCLES)
        with torch.profiler.record_function(REGION_NAME):
            yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def flops_of(fn, *args, **kwargs) -> float:
    """FLOPs of one call `fn(*args, **kwargs)`, counted by
    `torch.utils.flop_counter.FlopCounterMode` as the call runs: the JAX
    `flops_of_jitted`'s counterpart.

    What it counts differs from XLA's cost analysis in two ways.  It sees
    only aten operators that have a FLOP formula, the matmul-like ones (mm,
    bmm, addmm, baddbmm, convolutions, attention): elementwise work,
    reductions and factorizations count 0, where XLA counts them too.  And
    it sees nothing launched past the dispatcher, so none of the port's
    ctypes kernels: run `fn` on their plain versions (CPU tensors, float64,
    or the plain wrappers) to count the work they do.  A backward run inside
    `fn` is counted too."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


# Peak DENSE bf16 matmul FLOP/s of a card, from the vendor's data sheet.
# The MFU convention of the JAX package: achieved FLOPs over the dense bf16
# peak even for float32 compute, a conservative utilization number.
_PEAK_FLOPS_PER_CARD = {
    # NVIDIA H100 data sheet, H100 SXM5 (the card that reports itself as
    # "NVIDIA H100 80GB HBM3"), 700 W: 989.4 TFLOP/s bf16 dense (1,979
    # with sparsity); a card set below 700 W peaks lower
    "h100 80gb hbm3": 989.4e12,
    "h100 sxm": 989.4e12,
}


def peak_flops_per_s(device=None) -> Optional[float]:
    """Peak bf16 dense FLOP/s of the CUDA card `device` (default the
    current one), or None on the CPU and on a card not in the table
    (callers then omit MFU)."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device).lower()
    for kind, peak in _PEAK_FLOPS_PER_CARD.items():
        if kind in name:
            return peak
    return None


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card allocator statistics in bytes, under the JAX keys:
    bytes_in_use and peak_bytes_in_use (the CUDA caching allocator's current
    and peak allocated bytes) and bytes_limit (the card's memory).  Only
    cards this process has used; {} on the CPU."""
    if not _cuda_in_use():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        if not s:
            continue
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
        }
    return out
