"""The port's spans and counters (`utils/profiling.span`, `count`): off
while no profiler records (the shared no-op, nothing recorded, the same
outputs bit for bit as with recording on), and under a CPU `torch.profiler`
the span tree of a request, a ChEES call and a DSVI epoch, each span a host
range of its name in the kineto trace on the same clock, and the size rule
that names an idle gap after its span: no span holds more than 300 host
events of its own (those in no child span and in no range of the autograd
engine) in one chunk of draws, one `predict_Y` and one SVC gradient at the
configuration's N = 100."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import (
    chees,
    dsvi,
    hmc,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
    cnmgp,
    predict,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
    logdensities as ld,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
    profiling,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import sim_mnts

torch.set_num_threads(1)
D, M, PER_OUTPUT = 3, 8, 16
CHAINS, DIM = 6, 5
OWN_EVENTS = 300


def _model():
    params = cnmgp.init_params(torch.Generator().manual_seed(0), D, M, dtype=torch.float32,
                               device="cpu")
    Z = torch.linspace(0.0, 1.0, M)
    rng = np.random.default_rng(1)
    X = [np.sort(rng.uniform(0.0, 1.0, PER_OUTPUT)).astype(np.float32) for _ in range(D)]
    return params, Z, X


def _predict_Y():
    params, Z, X = _model()
    return predict.predict_Y(params, Z, X, device="cpu")


def _sample_Y(n_sample=20, draws_per_chunk=8):
    params, Z, X = _model()
    return predict.sample_Y(params, Z, X, n_sample=n_sample, seed=3,
                            draws_per_chunk=draws_per_chunk, device="cpu")


def _normal(q):
    return -0.5 * torch.sum(q * q, dim=-1)


def _chees_sample(num_samples=4):
    gen = torch.Generator().manual_seed(5)
    q0 = torch.randn(CHAINS, DIM, generator=gen, dtype=torch.float64)
    lp0, g0 = hmc.value_and_grad(_normal, q0)
    tuning = chees.CheesTuning(torch.tensor(0.3, dtype=torch.float64),
                               torch.tensor(math.log(1.5), dtype=torch.float64),
                               torch.ones(DIM, dtype=torch.float64))
    draws = hmc.GeneratorDraws(gen, CHAINS, DIM, torch.float64, "cpu")
    state, pos, info = chees.chees_sample(_normal, chees.CheesState(q0, lp0, g0), tuning,
                                          num_samples=num_samples, draws=draws)
    return state.position, pos, info


def _scan_epochs(n_epochs=2, n=40, batch=16):
    gen = torch.Generator().manual_seed(7)
    x = torch.sort(torch.rand(n, generator=gen, dtype=torch.float64)).values
    idx = torch.randint(0, D, (n,), generator=gen)
    y = torch.sin(6 * x) + 0.1 * torch.randn(n, generator=gen, dtype=torch.float64)
    Z = torch.linspace(0.0, 1.0, M, dtype=torch.float64)
    params = cnmgp.init_params(torch.Generator().manual_seed(0), D, M, dtype=torch.float64,
                               device="cpu")
    params = cnmgp.CNMGPParams(*(t.clone().requires_grad_(True) for t in params))
    opt = dsvi.make_optimizer(params, "adam", 0.01)
    nb = -(-n // batch)
    run = dsvi.make_scan_epochs(opt, float(n), 1e-4, nb, batch)
    losses = run(params, dsvi.freeze_mask(params, True), Z, x, y, idx,
                 torch.Generator().manual_seed(9), n_epochs)
    return (losses,) + tuple(p.detach() for p in params)


def _svc_gradient(N=100, chains=4):
    out = sim_mnts(2, N, seed=0)
    x = torch.as_tensor(out[0], dtype=torch.float32)
    Y = torch.as_tensor(out[4], dtype=torch.float32)
    chol_l, chol_L = ld.svc_whiten_chols(x, 3.0, 0.4, 5.0, 1.0)

    def lp(q):
        return ld.svc_log_posterior_whitened(q, Y, x, chol_l, chol_L, mu_tilde_l=-3.0)

    q = 0.1 * torch.randn(chains, 4 * N + 1, generator=torch.Generator().manual_seed(2))
    return hmc.value_and_grad(lp, q)


def _flat(out):
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict):
        return [v for v in out.values() if torch.is_tensor(v)]
    return [t for o in out for t in _flat(o)]


def _profiled(fn):
    """`fn()` under a CPU profiler: (its output, the spans it recorded, the
    trace's kineto events)."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.spans(), prof.profiler.kineto_results.events()


@pytest.fixture(scope="module", autouse=True)
def _warm_profiler():
    """The profiler's first range in a process starts late; take it here."""
    _profiled(lambda: profiling.span("warm").__enter__().__exit__(None, None, None))
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def test_span_off_is_one_shared_noop():
    a, b = profiling.span("predict.request"), profiling.span("other", kind="x")
    assert a is b
    with a as entered:
        assert entered is a
        entered.set(points=3)
    with pytest.raises(KeyError):
        with profiling.span("raises"):
            raise KeyError("an error inside an off span propagates")
    assert profiling.spans() == []


def test_an_error_inside_a_span_propagates_and_closes_it():
    def raising():
        with pytest.raises(KeyError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    raise KeyError("k")
        with profiling.span("after"):
            pass

    _, recorded, _ = _profiled(raising)
    outer, inner, after = recorded
    assert inner.parent == outer.id and inner.end_ns <= outer.end_ns
    assert after.parent is None and after.request == after.id


@pytest.mark.parametrize("fn", [_predict_Y, _sample_Y, _chees_sample, _scan_epochs],
                         ids=["predict_Y", "sample_Y", "chees_sample", "scan_epochs"])
def test_off_records_nothing_and_on_gives_the_same_outputs(fn):
    profiling.clear_spans()
    off = _flat(fn())
    assert profiling.spans() == []
    on, recorded, _ = _profiled(fn)
    assert recorded and all(s.end_ns is not None for s in recorded)
    on = _flat(on)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def _names(recorded):
    return [s.name for s in recorded]


def _check_tree(recorded):
    """Every span's parent opened before it and encloses it, and every span
    carries its root's id as its request."""
    by_id = {s.id: s for s in recorded}
    for s in recorded:
        if s.parent is None:
            assert s.request == s.id
        else:
            p = by_id[s.parent]
            assert p.id < s.id and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.request == p.request


@pytest.mark.parametrize("n_sample, per_chunk", [(20, 8), (16, 8), (5, 2)])
def test_request_tree(n_sample, per_chunk):
    _, recorded, _ = _profiled(lambda: _sample_Y(n_sample, per_chunk))
    _check_tree(recorded)
    names = _names(recorded)
    (root,) = [s for s in recorded if s.parent is None]
    assert root.name == "predict.request" and root.attrs == {
        "kind": "sample_Y", "draws": n_sample, "points": D * PER_OUTPUT}
    assert names.count("predict.chunk") == math.ceil(n_sample / per_chunk)
    assert names.count("cnmgp.sample_y") == names.count("cnmgp.noise") == names.count(
        "predict.chunk")
    assert names.count("predict.inputs") == names.count("predict.concat") == 1


def test_predict_Y_tree():
    _, recorded, _ = _profiled(_predict_Y)
    _check_tree(recorded)
    assert [s.name for s in recorded if s.parent is None] == ["predict.request"]
    assert recorded[0].attrs == {"kind": "predict_Y", "draws": 0, "points": D * PER_OUTPUT}
    assert _names(recorded).count("cnmgp.predict_mean") == 1


def test_chees_tree():
    (_, _, info), recorded, _ = _profiled(lambda: _chees_sample(4))
    _check_tree(recorded)
    names = _names(recorded)
    start, root = [s for s in recorded if s.parent is None]  # the start's gradient, the call
    assert start.name == "hmc.gradient" and start.attrs == {"chains": CHAINS}
    assert root.name == "chees.call" and root.attrs == {"iterations": 4, "chains": CHAINS}
    assert names.count("hmc.leapfrog") == info["leapfrogs"] == names.count("hmc.gradient") - 1
    assert names.count("chees.steps_read") == names.count("chees.accept") == 4
    iterations = [s for s in recorded if s.name == "chees.iteration"]
    assert [s.attrs["leapfrogs"] for s in iterations] == info["num_steps"].tolist()


def test_dsvi_epoch_tree():
    n, batch, epochs = 40, 16, 2
    _, recorded, _ = _profiled(lambda: _scan_epochs(epochs, n, batch))
    _check_tree(recorded)
    roots = [s for s in recorded if s.parent is None]
    assert [s.name for s in roots] == ["dsvi.epoch"] * epochs
    for root in roots:
        steps = [s for s in recorded if s.name == "dsvi.step" and s.parent == root.id]
        assert len(steps) == -(-n // batch)
        assert [s.name for s in recorded if s.parent == root.id].count("dsvi.shuffle") == 1


def test_spans_are_host_ranges_on_the_profilers_clock():
    _, recorded, events = _profiled(lambda: _sample_Y(10, 8))
    ranges = {}
    for e in events:
        ranges.setdefault(e.name(), []).append(e)
    for s in recorded:
        starts = [e.start_ns() for e in ranges.get(s.name, [])]
        assert starts, s.name
        assert min(abs(t - s.start_ns) for t in starts) <= 50_000, s


def _own_events(recorded, events):
    """Each span's host events in no child span and in no range of the
    autograd engine, keyed by span id."""
    names = {s.name for s in recorded}
    engine = [(e.start_ns(), e.end_ns()) for e in events
              if e.name().startswith("autograd::engine::evaluate_function")]
    own = {s.id: 0 for s in recorded}
    for e in events:
        t = e.start_ns()
        if e.name() in names or any(a <= t <= b for a, b in engine):
            continue
        inner = [s for s in recorded if s.start_ns <= t <= s.end_ns]
        if inner:
            own[max(inner, key=lambda s: s.start_ns).id] += 1
    return own


@pytest.mark.parametrize("fn", [lambda: _sample_Y(8, 8), _predict_Y, _svc_gradient],
                         ids=["sample_Y_chunk", "predict_Y", "svc_gradient"])
def test_no_span_holds_more_than_300_events_of_its_own(fn):
    fn()
    _, recorded, events = _profiled(fn)
    own = _own_events(recorded, events)
    worst = max(recorded, key=lambda s: own[s.id])
    assert own[worst.id] <= OWN_EVENTS, (worst.name, own[worst.id])
    assert sum(own.values()) > OWN_EVENTS  # the unit is larger than one span's share


def test_phase_timer_phases_are_spans():
    timer = profiling.PhaseTimer()

    def phases():
        with timer.phase("reparameterization"):
            with timer.phase("kl"):
                pass

    _, recorded, _ = _profiled(phases)
    assert _names(recorded) == ["reparameterization", "kl"]
    assert recorded[1].parent == recorded[0].id
    assert timer.counts == {"reparameterization": 1, "kl": 1}


def test_counters(monkeypatch):
    monkeypatch.setitem(ck.LAUNCHES, "gibbs", 12)
    monkeypatch.setitem(ck.LAUNCHES, "chol_inv", 0)
    got = profiling.counters()
    assert got["kernel.gibbs.launches"] == 12 and got["kernel.chol_inv.launches"] == 0
    assert {f"kernel.{k}.launches" for k in ck.KERNELS} <= set(got)
    before = got.get("test.counted", 0)
    profiling.count("test.counted")
    profiling.count("test.counted", 2.5)
    assert profiling.counters()["test.counted"] == before + 3.5
    assert "dsvi.captures" not in profiling.counters()  # no graph captured on the CPU


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    import json

    profiling.clear_spans()
    with profiling.trace(str(tmp_path)):
        _predict_Y()
    (path,) = tmp_path.iterdir()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    recorded = {s.name for s in profiling.spans()}
    assert {"predict.request", "predict.inputs", "cnmgp.predict_mean"} <= recorded <= names
