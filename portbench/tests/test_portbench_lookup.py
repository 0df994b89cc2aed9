"""BENCHMARK.json against the benchmark's contract, and every cell, mix,
configuration, limit and per-layer metric found by name."""

from __future__ import annotations

import json
import re
import shutil
from argparse import Namespace

import pytest

from portbench import data, run
from portbench.tests.conftest import PACKAGE, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200, cells


def test_names_units_and_entries():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_with_its_files(cell):
    spec = run.cell_spec(BENCH, cell)
    assert spec["config"]["name"] == spec["workload"]["config"]
    assert run.kind_module(spec["traffic"]).Cell
    assert spec["limits"], "a cell's check compares at least one number"
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(run.metric_reader(m["name"]))


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert (PACKAGE / "metrics" / f"{m['name']}.py").exists()


def test_a_cell_is_added_by_files_and_an_entry(tiny_root, tmp_path):
    """A new configuration, mix and cell: three new files and three new
    entries, no file of the benchmark edited; the harness runs it."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    base = root / "portbench"
    cfg = json.loads((base / "configs" / "ecog-m100.json").read_text())
    cfg.update(name="ecog-d2", D=2, data={**cfg["data"], "lengths": cfg["data"]["lengths"][:2]})
    (base / "configs" / "ecog-d2.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "serve_mix.json").read_text())
    mix.update(predict_share=0.5)
    (base / "traffic" / "serve_half.json").write_text(json.dumps(mix))
    shutil.copy(base / "limits" / "ecog.serve.json", base / "limits" / "ecog-d2.serve_half.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ecog-d2", "source": "s", "file": "portbench/configs/ecog-d2.json",
                             "reduced": ["D"], "why": "w"})
    bench["workloads"].append({"name": "ecog-d2.serve_half", "config": "ecog-d2",
                               "traffic": "serve_half", "chips": 1, "why": "w"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ecog.serve" in m.get("workloads", ()):
            m["workloads"].append("ecog-d2.serve_half")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    args = Namespace(workload="ecog-d2.serve_half", seed=7, seconds=0.5, trace=0)
    result = run.execute(args, root=root, device="cpu")
    assert result["correct"] and "serve_p95_ms" in result["metrics"]


@pytest.mark.parametrize("traffic,metric", [("dsvi_epochs", "train_steps_per_s"),
                                            ("serve_mix", "serve_p95_ms")])
def test_a_config_with_unequal_outputs_is_added_by_files_and_entries(tiny_root, tmp_path, traffic,
                                                                    metric):
    """A heterotopic configuration (outputs of unequal lengths, as PM2.5's
    are) and its cell: a configuration file that states its data, a limits
    file and two entries, no file of the benchmark edited; the harness
    builds its data by the generator's name and runs it."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    base = root / "portbench"
    cfg = json.loads((base / "configs" / "ecog-m100.json").read_text())
    cfg.update(name="uneven", D=3, B=120,
               data={"generator": "sine", "lengths": [50, 30, 40], "period": 6.0, "x_max": 50.0})
    (base / "configs" / "uneven.json").write_text(json.dumps(cfg))
    cell = f"uneven.{traffic}"
    limits = "ecog.train.json" if traffic == "dsvi_epochs" else "ecog.serve.json"
    shutil.copy(base / "limits" / limits, base / "limits" / f"{cell}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "uneven", "source": "s", "file": "portbench/configs/uneven.json",
                             "reduced": ["D"], "why": "w"})
    bench["workloads"].append({"name": cell, "config": "uneven", "traffic": traffic, "chips": 1,
                               "why": "w"})
    for m in bench["end_to_end"]:
        if m["name"] == metric:
            m["workloads"].append(cell)
    for m in bench["per_layer"]:
        if m["moves"] == metric:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.cell_spec(run.benchmark(root), cell, root)
    x, _, idx, _ = data.observations(spec["config"], "cpu", root=root)
    assert x.shape[0] == 120 and idx.bincount().tolist() == [50, 30, 40]
    result = run.execute(Namespace(workload=cell, seed=2**35 + 3, seconds=0.5, trace=0), root=root,
                         device="cpu")
    assert result["correct"] and metric in result["metrics"], result["checks"]
