"""The `pm25sub.train` cell's files, and the two per-layer metrics of the
DSVI step it brought: `step_graph_kernels.train` (the port's counters) and
`qf_bwd_roofline.train` (the quadform backward's device time, by kernel
name), on synthetic contexts and in tiny runs on the CPU."""

from __future__ import annotations

import json
from argparse import Namespace

import pytest

from portbench import data, run, spans, work
from portbench.tests.conftest import ROOT, TINY_CONFIG

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL, CONFIG = "pm25sub.train", "pm25sub-m100"
NEW = ("step_graph_kernels.train", "qf_bwd_roofline.train")

class _Slice:
    def __init__(self, device_ops, window_s=1.0, busy_s=0.5):
        self.device_ops, self.window_s, self.busy_s = device_ops, window_s, busy_s
        self.idle_gaps = []


def _ctx(device_ops=(), kind="dsvi_train", steps=15):
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{CONFIG}.json").read_text())
    return dict(config=cfg, traffic={"kind": kind}, slice=_Slice(list(device_ops)),
                units=[{"steps": steps, "nonfinite": 0}])


def test_the_cell_and_its_configuration_are_found():
    spec = run.cell_spec(BENCH, CELL)
    cfg = spec["config"]
    assert spec["workload"]["chips"] == 1 and spec["traffic"]["kind"] == "dsvi_train"
    assert (cfg["D"], cfg["M"], cfg["B"], cfg["lr"]) == (6, 100, 2000, 0.01)
    assert set(spec["limits"]) == {"loss_gap", "median_grad_gap", "median_change_gap"}
    assert {m["name"] for m in spec["end_to_end"]} == {"train_steps_per_s", "setup_s"}
    train = {m["name"] for m in BENCH["per_layer"] if "ecog.train" in m.get("workloads", ())}
    assert {m["name"] for m in spec["per_layer"]} == train and set(NEW) <= train
    (entry,) = [c for c in BENCH["configs"] if c["name"] == CONFIG]
    assert entry["reduced"] == [] and cfg["reduced"] == []


def test_the_data_is_the_studys_split():
    """`utils/etl.etl_pm25`'s split of the first 5,000 rows: attribute 0 keeps
    80% of its 4,710 observed rows (942 held out), the other five all 5,000,
    on the row-number axis."""
    cfg = run.cell_spec(BENCH, CELL)["config"]
    x, y, idx, Z = data.observations(cfg, "cpu")
    assert x.shape[0] == 28_768 and idx.bincount().tolist() == [3768] + [5000] * 5
    assert 4710 - int(0.2 * 4710) == 3768
    assert -(-x.shape[0] // cfg["B"]) == 15 and Z.shape == (100,)
    assert float(x.max()) < cfg["data"]["x_max"] == 5000.0


def test_the_tiny_cut_is_registered_before_any_test_module():
    """The tiny root's cut of this configuration comes from
    `portbench/conftest.py`, whatever test files a run collects."""
    assert TINY_CONFIG[CONFIG]["data"]["lengths"] == [13, 9, 11, 9, 9, 9]


def test_kernel_count_is_the_counter_over_the_captures(monkeypatch):
    read = run.metric_reader("step_graph_kernels.train")
    profiling = spans._profiling()
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"dsvi.captures": 2, "dsvi.step_graph_kernels": 2 * 1043})
    assert read(_ctx()) == 1043
    assert read(_ctx(kind="dsvi_serve")) is None
    # a port that counts captures and not the step graph's kernels (the CPU,
    # or a port without the counter)
    monkeypatch.setattr(profiling, "counters", lambda: {"dsvi.captures": 1})
    assert read(_ctx()) is None
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read(_ctx()) is None
    monkeypatch.delattr(profiling, "counters")
    assert read(_ctx()) is None


FUSED = [("void (anonymous namespace)::quadform_diag_bwd_kernel<64, 7, 2, 2>(float const*)", 0.30),
         ("void (anonymous namespace)::quadform_diag_bwd_sum(float const*, float*, int, long long)",
          0.02)]
PAIR = [("void (anonymous namespace)::quadform_diag_dw_kernel(float const*)", 0.20),
        ("void (anonymous namespace)::quadform_diag_da_kernel<128, 7>(float const*)", 0.10),
        ("void (anonymous namespace)::quadform_diag_da_reduce(float const*, float*, int, int)",
         0.02)]
OTHER = [("void (anonymous namespace)::quadform_diag_kernel<8>(float const*)", 0.5),
         ("void at::native::vectorized_elementwise_kernel<4>", 0.7)]


@pytest.mark.parametrize("ops", [FUSED, PAIR], ids=["fused", "pair"])
def test_backward_share_reads_the_same_work_whatever_runs_it(ops):
    """The least work is the function's: C once, three quarters of the
    operations 6b and 6c count between them."""
    read = run.metric_reader("qf_bwd_roofline.train")
    share = read(_ctx(ops + OTHER, steps=15))
    cfg = _ctx()["config"]
    M, B = cfg["M"], cfg["B"]
    least = 0.0
    for G in (15, 6, 6):
        ops_once = 3 * G * B * M * (M + 1)
        assert 4 * ops_once == 3 * (work.quadform_dw(G, M, B)[0] + work.quadform_da(G, M, B)[0])
        least += work.least_s((ops_once, 4 * (2 * M * B + G * B + G * M * (M + 1))))
    assert share == pytest.approx(100.0 * least * 15 / 0.32)
    assert 0 < share < 100


def test_backward_share_is_none_without_its_kernels():
    read = run.metric_reader("qf_bwd_roofline.train")
    assert read(_ctx(OTHER)) is None
    assert read(_ctx(FUSED, kind="dsvi_serve")) is None
    assert read(_ctx(FUSED, steps=0)) is None


def test_a_tiny_traced_run_reports_no_graph_metric_on_the_cpu(tiny_root):
    """On the CPU nothing is captured and no kernel runs on a card: both
    new metrics are left out of the line, and the run is `correct`."""
    r = run.execute(Namespace(workload=CELL, seed=2**37 + 5, seconds=0.3, trace=1),
                    root=tiny_root, device="cpu")
    assert not set(NEW) & set(r["metrics"]) and r["metrics"] and r["correct"] is True
