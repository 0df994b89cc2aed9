"""The per-layer metrics that read the port's own spans and counters
(`portbench/spans.py`): None off their traffic kind and where the port
records no spans, and reported in a CPU `--trace 1` run of each tiny cell
(`capture_s.train` excepted: nothing is captured on the CPU)."""

from __future__ import annotations

import json
from argparse import Namespace

import pytest

from portbench import run, spans
from portbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = {m["name"]: m for m in BENCH["per_layer"]
                if m["source"] in ("program_span", "program_counter")}
KINDS = {"ecog.train": "dsvi_train", "ecog.serve": "dsvi_serve", "svc.chees1024": "chees_sample"}


class _Slice:
    window_s, busy_s, device_ops, idle_gaps = 1.0, 0.5, [], []


def _ctx(kind):
    return dict(config={}, traffic={"kind": kind}, slice=_Slice(), units=[{"leapfrogs": 3}])


def test_six_metrics_each_in_one_cell():
    assert set(SPAN_METRICS) == {"request_host_ms.serve", "chunk_host_ms.serve",
                                 "leapfrog_host_ms.sample", "host_wait_pct.sample",
                                 "replay_host_ms.train", "capture_s.train"}
    for m in SPAN_METRICS.values():
        assert len(m["workloads"]) == 1 and m["better"] == "lower"


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_is_none_off_its_kind(name):
    (cell,) = SPAN_METRICS[name]["workloads"]
    read = run.metric_reader(name)
    for kind in set(KINDS.values()) - {KINDS[cell]}:
        assert read(_ctx(kind)) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_is_none_for_a_port_without_spans(name, monkeypatch):
    """The parent of this benchmark's span metrics has no `spans()` or
    `counters()`: the reader gives None and does not raise."""
    profiling = spans._profiling()
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    (cell,) = SPAN_METRICS[name]["workloads"]
    assert run.metric_reader(name)(_ctx(KINDS[cell])) is None


@pytest.mark.parametrize("cell", sorted(KINDS))
def test_traced_run_reports_its_span_metrics(tiny_root, cell):
    r = run.execute(Namespace(workload=cell, seed=2**36 + 11, seconds=0.3, trace=1),
                    root=tiny_root, device="cpu")
    want = {n for n, m in SPAN_METRICS.items() if cell in m["workloads"]} - {"capture_s.train"}
    assert want <= set(r["metrics"]), r["metrics"]
    assert all(r["metrics"][n]["value"] > 0 for n in want)
    assert "capture_s.train" not in r["metrics"]
    assert r["correct"] is True
