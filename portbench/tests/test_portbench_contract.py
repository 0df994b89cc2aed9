"""The result line of a run at tiny sizes on the CPU, the refusals, and the
imports: nothing the benchmark runs may load JAX or the JAX package,
compared by whole top-level module names."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from argparse import Namespace

import pytest

from portbench import run
from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def execute(root, cell, seed, trace, seconds=0.5):
    return run.execute(Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace),
                       root=root, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_untraced(tiny_root, cell):
    r = execute(tiny_root, cell, 2**33 + 5, 0)
    assert list(r)[-1] == "checks" and {"correct", "attempted", "failed", "metrics",
                                         "device"} <= set(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    spec = run.cell_spec(run.benchmark(tiny_root), cell, tiny_root)
    assert set(r["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["checks"]) == set(spec["limits"])
    assert json.loads(json.dumps(r)) == r


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_traced(tiny_root, cell):
    r = execute(tiny_root, cell, 11, 1)
    spec = run.cell_spec(run.benchmark(tiny_root), cell, tiny_root)
    assert set(r["metrics"]) <= {m["name"] for m in spec["per_layer"]} and r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"]) and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in r["breakdown"].values())
    assert r["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(tiny_root, cell):
    """Two cells built from one seed serve the same first units, answer for
    answer; another seed serves others."""
    import numpy as np
    import torch

    spec = run.cell_spec(run.benchmark(tiny_root), cell, tiny_root)
    kind = run.kind_module(spec["traffic"])

    def first_units(seed):
        c = kind.Cell(spec["config"], spec["traffic"], spec["limits"], seed,
                      torch.device("cpu"), root=tiny_root)
        c.setup()
        return [c.unit() for _ in range(3)], c

    (a, ca), (b, cb), (_, cc) = first_units(2**40 + 1), first_units(2**40 + 1), first_units(9)
    drop_time = lambda units: [{k: v for k, v in u.items() if k != "ms"} for u in units]  # noqa: E731
    assert drop_time(a) == drop_time(b)
    if cell == "ecog.serve":
        for x, y in zip(ca.served, cb.served):
            assert x["b"] == y["b"] and np.array_equal(x["got"], y["got"])
        assert [s["X"][0].tolist() for s in ca.served] != [s["X"][0].tolist() for s in cc.served]


def _run_cli(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Without a card the run prints no result and exits non-zero."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run_cli(["--workload", "ecog.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                 ROOT, env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and `portbench/` gives no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run_cli(["--workload", "ecog.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                 tmp_path, env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_names_are_compared_whole():
    port = run.PORT
    assert run.forbidden_modules([port, port + ".models", "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "flax", port[: -len("_torch")] + ".ops"]) == [
        "collaborative_nonstationary_multivariate_gaussian_process_tpu", "flax", "jax"]


def test_nothing_run_loads_jax(tiny_root):
    """A whole run of every cell, traced, in a fresh process: no module of
    JAX or the JAX package is loaded; the references import nothing of the
    port."""
    code = textwrap.dedent(f"""
        import sys
        from argparse import Namespace
        from pathlib import Path
        import portbench.reference.cnmgp, portbench.reference.svc
        port = [m for m in sys.modules if m.split(".")[0] == "{run.PORT}"]
        assert not port, port
        from portbench import run
        for cell in {CELLS!r}:
            run.execute(Namespace(workload=cell, seed=3, seconds=0.2, trace=1),
                        root=Path({str(tiny_root)!r}), device="cpu")
        import portbench.tools.calibrate, portbench.tools.chees_tuning
        print("forbidden:" + ",".join(run.forbidden_modules()))
    """)
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS",)}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "forbidden:"


def test_train_window_runs_fits_from_the_start(tiny_root):
    """Every `epochs_per_fit` epochs the trainer restarts from the set-up's
    starting state: the parameters as they began, Adam's moments and counts
    at zero."""
    import torch

    spec = run.cell_spec(run.benchmark(tiny_root), "ecog.train", tiny_root)
    kind = run.kind_module(spec["traffic"])
    cell = kind.Cell(spec["config"], spec["traffic"], spec["limits"], 21, torch.device("cpu"),
                     root=tiny_root)
    cell.setup()
    fit = spec["traffic"]["epochs_per_fit"]
    for _ in range(fit):
        cell.unit()
    assert any(not torch.equal(p, p0) for p, p0 in zip(cell.params, cell.p0))
    assert int(cell.run.step.count) == fit
    cell.unit()  # the next fit's first epoch
    assert int(cell.run.step.count) == 1
    state = [cell.opt.state[p]["step"] for p in cell.params if p in cell.opt.state]
    assert state and all(float(s) == 1.0 for s in state)
