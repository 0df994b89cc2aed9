"""The port's own spans and counters of a traced slice, for the per-layer
metrics that read them (`portbench/metrics/*.py`).

The port records spans (`utils/profiling.span`) only while a profiler
records in its process, so in a `--trace 1` run they are those of the
traced slice; a span that opened before the slice's window (another run in
the same process) is left out.  A port that records no spans (one without
`profiling.spans`) gives None, and the metric is left out of the line.
"""

from __future__ import annotations


def _profiling():
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
        profiling,
    )

    return profiling


def slice_spans(ctx, name):
    """The closed spans `name` of the traced slice in `ctx`, or None where
    the port records none."""
    spans = getattr(_profiling(), "spans", None)
    if spans is None:
        return None
    closed = [s for s in spans() if s.end_ns is not None]
    if not closed:
        return None
    # the slice ends on the card's synchronize, right after its last span
    start = max(s.end_ns for s in closed) - ctx["slice"].window_s * 1e9
    return [s for s in closed if s.name == name and s.start_ns >= start]


def mean_ms(ctx, name):
    """Mean duration in ms of the slice's spans `name`, None without any."""
    found = slice_spans(ctx, name)
    if not found:
        return None
    return 1e-6 * sum(s.duration_ns for s in found) / len(found)


def counter(name):
    """The port's counter `name`, None where it has none."""
    counters = getattr(_profiling(), "counters", None)
    return None if counters is None else counters().get(name)
