"""The port's `utils/profiling.py` against the JAX package's: the
`PhaseTimer` report and the `print_mem` line in the same format (on the
CPU, where no card adds its fields), a `trace()` written as a Chrome
trace, the card-only probes empty here, the peak table, and `flops_of`
against `flops_of_jitted`: equal on a matmul chain (both count 2mnk a
product); on `negative_selbo` at the graft entry's size (D = 4, M = 32,
B = 256) the port counts 0.9054 of XLA's count, since FlopCounterMode
counts only matmul-like operators and XLA also counts elementwise work
(held within 0.85-0.95)."""

import json
import os
import re
import time

import jax
import numpy as np
import torch

import __graft_entry__ as jge
from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import profiling as jp
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
    graft_entry as tge,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
    profiling as tp,
)


def test_phase_timer_reports_as_the_jax_one(monkeypatch, capsys):
    ticks = iter(np.arange(0.0, 100.0, 0.125))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    reports = []
    for mod in (jp, tp):
        timer = mod.PhaseTimer(verbose=True)
        for name in ("reparameterization", "kl", "reparameterization"):
            with timer.phase(name):
                pass
        reports.append(timer.report())
    assert reports[0] == reports[1] == (
        "reparameterization: 0.2500s over 2 calls\nkl: 0.1250s over 1 calls")
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:]


def test_print_mem_prints_the_jax_line(capsys):
    for mod in (jp, tp):
        mb = mod.print_mem(3)
        line = capsys.readouterr().out.strip()
        assert re.fullmatch(r"epoch: 3, memory usage: \d+\.\d MiB", line), line
        assert mb > 0 and abs(mb - tp.rss_mb()) < 512
    tp.print_mem()
    assert capsys.readouterr().out.startswith("memory usage: ")


def test_trace_writes_a_chrome_trace(tmp_path):
    with tp.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = tmp_path.iterdir()
    assert path.name == f"trace_{os.getpid()}.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.get("name") == tp.REGION_NAME for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_card_probes_are_empty_on_the_cpu(monkeypatch):
    assert tp.device_memory_stats() == {}
    assert tp.peak_flops_per_s() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert tp.peak_flops_per_s() == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA A100-SXM4-40GB")
    assert tp.peak_flops_per_s() is None


def test_flops_of_matches_xla_on_a_matmul_chain():
    rng = np.random.default_rng(0)
    mats = [rng.standard_normal(s) for s in ((8, 16), (16, 32), (32, 4))]

    def chain(a, b, c):
        return a @ b @ c

    want = jp.flops_of_jitted(jax.jit(chain), *mats)
    got = tp.flops_of(chain, *map(torch.as_tensor, mats))
    assert got == want == 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4


def test_flops_of_negative_selbo_against_xla():
    jfn, jargs = jge.entry()
    tfn, targs = tge.entry(device="cpu")
    ratio = tp.flops_of(tfn, *targs) / jp.flops_of_jitted(jax.jit(jfn), *jargs)
    assert 0.85 <= ratio <= 0.95, ratio
