"""Lightweight observability: phase timers, memory probe, profiler hooks,
spans and counters.

The JAX package's `utils/profiling.py`.  The reference times named phases
with `time.time()` deltas under `verbose` (nmgp_dsvi.py:161-260) and prints
the process's RSS beside its periodic ELBO probe (`print_mem`,
nmgp_dsvi.py:26-32).  This module keeps both, and adds the card's side:
`torch.profiler` traces with CUDA activity, the CUDA caching allocator's
counters, the FLOPs of a call and the card's peak rate.

The port's layers open named spans (`span`) at their boundaries.  A span
records only while a `torch.profiler` records in this process: it is then
a host range of its name in the profiler's trace (so an idle gap of the
card falls inside a named range), and a `SpanRecord` on the profiler's own
host clock (`spans()`).  Off, a span reads no clock and records nothing.
Counters (`count`, `counters()`) are always on; they count what happens
outside any traced region (kernel builds, graph captures).

None of these functions initializes CUDA: on a process that has not used
the card they report the host alone.  A `PhaseTimer` around work on the
card measures the host's enqueue unless the phase ends in a
`torch.cuda.synchronize()`.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import os
import threading
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
    "SpanRecord",
    "recording",
    "span",
    "spans",
    "clear_spans",
    "count",
    "counters",
    "graph_kernel_nodes",
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
        """Time the body as phase `name`; while a profiler records, the
        body is also the span `name`."""
        t0 = time.perf_counter()
        try:
            with span(name):
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


# ---------------------------------------------------------------------------
# Spans and counters

# recording() -> bool: whether a `torch.profiler` records in this process,
# and so whether spans record
recording = torch._C._autograd._profiler_enabled
# A span's host range in the profiler's trace: the profiler's lightweight
# range where this torch has it (~0.75 us on a CPU where
# `torch.profiler.record_function` takes ~7 us), else `record_function`.
_host_range = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)


class SpanRecord:
    """One span: `name`; `start_ns` and `end_ns` on the profiler's host clock
    (`time.time_ns()`, the clock of the kineto events' `start_ns()`; end_ns
    is None while the span is open); `id`, in the order spans opened;
    `parent`, the id of the innermost span open when it opened (None for a
    root); `request`, the id of its root (a root opens a request, and every
    span under it carries its id); `attrs`, the keywords it was opened with
    and those `set` added."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "request", "attrs")

    def __init__(self, name, id, parent, request, attrs):
        self.name, self.id, self.parent, self.request, self.attrs = name, id, parent, request, attrs
        self.start_ns = self.end_ns = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, start_ns={self.start_ns}, end_ns={self.end_ns}, "
                f"attrs={self.attrs})")


class _NoSpan:
    """The span while no profiler records: does nothing.  Its `__enter__`
    and `__exit__` (set below) are bound C methods, so entering and leaving
    it runs no Python frame (a third of an off span's cost): entering gives
    the shared object, leaving gives "" (false: an exception propagates)."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()
_NoSpan.__enter__ = itertools.repeat(_NO_SPAN).__next__
_NoSpan.__exit__ = "".format
_SPANS: List[SpanRecord] = []
_IDS = itertools.count(1)
_OPEN = threading.local()  # .stack: the open spans of a thread, innermost last
_COUNTERS: Dict[str, float] = {}


class _Span:
    __slots__ = ("name", "attrs", "record", "_range")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        id = next(_IDS)
        if stack:
            rec = SpanRecord(self.name, id, stack[-1].id, stack[-1].request, self.attrs)
        else:
            rec = SpanRecord(self.name, id, None, id, self.attrs)
        self.record = rec
        stack.append(rec)
        _SPANS.append(rec)
        self._range = _host_range(self.name)
        rec.start_ns = time.time_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self.record.end_ns = time.time_ns()
        _OPEN.stack.pop()
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.record.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager over a layer's work: while a `torch.profiler`
    records in this process, the body is the host range `name` in the
    profiler's trace and a `SpanRecord` in `spans()`, its attributes
    `attrs` (and those the yielded object's `set(**attrs)` adds).  While no
    profiler records, one shared object that does nothing.  A span measures
    the host's time: it never waits for the card."""
    if not recording():
        return _NO_SPAN
    return _Span(name, attrs)


def spans() -> List[SpanRecord]:
    """The spans recorded in this process since `clear_spans()` (kept until
    then), in the order they opened."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()


def count(name: str, n=1) -> None:
    """Add `n` to counter `name`."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, float]:
    """This process's counters, and each port kernel's launches as
    `kernel.<name>.launches` (read from `ops.cuda_kernels.LAUNCHES`)."""
    from ..ops import cuda_kernels

    out = dict(_COUNTERS)
    out.update({f"kernel.{name}.launches": n for name, n in cuda_kernels.LAUNCHES.items()})
    return out


# cudaGraphNodeTypeKernel of the CUDA runtime's cudaGraphNodeType
_KERNEL_NODE = 0


def graph_kernel_nodes(graph: "torch.cuda.CUDAGraph") -> Optional[int]:
    """The kernel nodes of a captured CUDA graph, one made with
    `keep_graph=True`: the kernels a replay launches, whoever wrote them
    (the port, PyTorch, cuBLAS); copies and memsets are not counted.  Read
    from the graph PyTorch captured (`raw_cuda_graph()`) through the CUDA
    runtime that PyTorch loaded (`cudaGraphGetNodes`,
    `cudaGraphNodeGetType`).  None where that runtime cannot be loaded: the
    count is a diagnostic, and the graph runs without it."""
    try:
        runtime = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    except OSError:
        return None
    get_nodes, node_type = runtime.cudaGraphGetNodes, runtime.cudaGraphNodeGetType
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                          ctypes.POINTER(ctypes.c_size_t)]
    node_type.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    get_nodes.restype = node_type.restype = ctypes.c_int
    handle = graph.raw_cuda_graph()

    def check(err, call):
        if err != 0:
            raise RuntimeError(f"{call} failed with cudaError_t {err}")

    n = ctypes.c_size_t(0)
    check(get_nodes(handle, None, ctypes.byref(n)), "cudaGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(get_nodes(handle, nodes, ctypes.byref(n)), "cudaGraphGetNodes")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes[:n.value]:
        check(node_type(node, ctypes.byref(kind)), "cudaGraphNodeGetType")
        kernels += kind.value == _KERNEL_NODE
    return kernels


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
    kernel.  The region is the host range `REGION_NAME`; the port's spans
    opened in it are host ranges of their names in the trace, and
    `spans()` holds their records.  The port's own kernels are launched
    through ctypes, past the PyTorch dispatcher: the trace holds their
    device activity (CUPTI sees every launch) and, on the host, the span
    `kernel.<name>` of their wrapper, but no operator.

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
