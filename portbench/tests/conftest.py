"""Fixtures of the benchmark's own tests: a checkout-like root in a temporary
directory, with the real BENCHMARK.json and `portbench/` data files, the
configurations and mixes cut to a size the CPU runs in seconds.

Run them with `python -m pytest portbench/tests -q`; the tests marked
`cuda` need a card and skip without one.
"""

from __future__ import annotations

import json
import math
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = ROOT / "portbench"

# the cuts of a tiny root: one batch an epoch (the CPU check steps need it)
TINY_DATA = {"generator": "sine", "lengths": [40, 40, 40], "period": 4.0, "x_max": 40.0}
TINY_CONFIG = {"ecog-m100": dict(D=3, M=6, B=120, data=TINY_DATA),
               "svc-sim-n100": dict(N=12)}
TINY_TRAFFIC = {"serve_mix": dict(cycle=10, sample_draws=12, b_min=4, b_max=32, check_draws=4),
                "chees_c1024": dict(chains=16, check_iterations=3)}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


def tiny_tuning(cfg) -> dict:
    """A ChEES tuning of the tiny SVC density, by the port's warmup on the CPU."""
    from portbench.kinds import chees_sample

    chees, _, _ = chees_sample._port()
    lp = chees_sample.port_density(cfg, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    inits = 0.5 * torch.randn(4, 4 * cfg["N"] + 1, generator=gen)
    inits[:, -1] = math.log(cfg["sigma2_err"])
    state, tuning, info = chees.chees_warmup(lp, inits, gen, num_warmup=40)
    return dict(step_size=float(tuning.step_size), log_traj_length=float(tuning.log_traj_length),
                inv_mass=tuning.inv_mass.tolist(), positions=state.position.tolist(),
                halton_offset=info["halton_offset"])


def make_root(tmp: Path) -> Path:
    """A root holding BENCHMARK.json and a copy of `portbench/`'s data files
    (configurations cut by TINY_CONFIG, mixes by TINY_TRAFFIC)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits", "metrics", "generators"):
        shutil.copytree(PACKAGE / sub, tmp / "portbench" / sub)
    for name, cut in TINY_CONFIG.items():
        path = tmp / "portbench" / "configs" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **cut}))
    for name, cut in TINY_TRAFFIC.items():
        path = tmp / "portbench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **cut}))
    cfg = json.loads((tmp / "portbench" / "configs" / "svc-sim-n100.json").read_text())
    (tmp / "portbench" / "traffic" / "svc_chees_tuning.json").write_text(
        json.dumps(tiny_tuning(cfg)))
    return tmp


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("checkout"))
