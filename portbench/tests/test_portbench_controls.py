"""The controls on the card, at each cell's own size: the plain reference in
float32 with TF32 products in the port's place must read `correct` false
by the cell's own limits, where the port reads true.  A short window on
one seed a cell (about a minute each with the build):

    python -m pytest portbench/tests/test_portbench_controls.py -q -m cuda

`portbench/tools/calibrate.py` takes the same readings over many seeds."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.tests.conftest import ROOT
from portbench.tools import calibrate

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_fails_where_the_port_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())
    readings = {r["reading"]: r["numbers"] for r in calibrate.readings(
        cell, [2**32 + 17], 5.0, 1, kinds=("tf32",))}
    assert all(readings["port"][k] <= v for k, v in limits.items()), readings["port"]
    assert any(readings["tf32"][k] > v for k, v in limits.items() if k in readings["tf32"])
