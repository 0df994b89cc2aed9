"""The port's fused DSVI trainer, `infer/dsvi.make_scan_epochs`, against the
JAX package's on the CPU in float64: two epochs of every step, the losses
and the parameters at rtol 1e-8 and atol 1e-12 (the tolerance of
`test_adam_steps_match_jax_step_for_step`), with JAX's own randomness
passed in through `draws`: the epoch keys as the JAX `run` splits them
(dsvi.py:211-226), then per epoch k_perm, k_steps = split(key), the sort
keys bits(k_perm, (n,), uint32) and each step's noise from split(k_steps,
num_batches) (`jax_train_noise`).  Adam, Adam with the global-norm clip,
the `lr_decay` schedule (in float64, `_schedule64`) and the bf16-moment
Adam, at one batch and at three with a padded last batch (D = 2, M = 6,
N = 30).  Then `mesh` on one process, the signature, and which paths of
`inference()` take the fused trainer."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.infer import dsvi as jd
from collaborative_nonstationary_multivariate_gaussian_process_tpu.infer.optimizers import (
    adam_bf16_moments,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi as td
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp as tc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.mesh import (
    make_mesh,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import (
    sim_illustration_low_freq,
)
from torch_port_helpers import FAST_COMPILE, assert_close, jax_init_params, jax_train_noise

torch.set_num_threads(1)
D, M_IND, N, JITTER, LR = 2, 6, 30, 1e-4, 0.02
EPOCHS = 2


class JaxEpochDraws:
    """The draws of the JAX `run(..., key, n_epochs)`: keys = split(key,
    n_epochs); per epoch k_perm, k_steps = split(key_e), the sort keys
    bits(k_perm, (n,), uint32) (as int64) and the noise of each step key
    of split(k_steps, num_batches), handed out in the order an epoch
    asks for them."""

    def __init__(self, key, n_epochs, n, num_batches, batch_size):
        self.keys, self.noises = [], []
        for key_e in jax.random.split(key, n_epochs):
            k_perm, k_steps = jax.random.split(key_e)
            bits = np.asarray(jax.random.bits(k_perm, (n,), jnp.uint32)).astype(np.int64)
            self.keys.append(torch.as_tensor(bits))
            for k in jax.random.split(k_steps, num_batches):
                self.noises.append(jax_train_noise(k, M_IND, batch_size, D))

    def sort_keys(self, n):
        assert n == N
        return self.keys.pop(0)

    def noise(self):
        return self.noises.pop(0)


def _data(seed=0):
    r = np.random.default_rng(seed)
    x = np.sort(r.random(N))
    idx = r.integers(0, D, N)
    y = np.sin(6 * x) + 0.1 * r.standard_normal(N)
    return x, y, idx


def _schedule(num_batches):
    """The `lr_decay` schedule of the JAX `inference()`, decay 0.5 an epoch."""
    return optax.exponential_decay(init_value=LR, transition_steps=num_batches, decay_rate=0.5)


def _schedule64(num_batches):
    """That schedule evaluated in float64 from the int32 count, as an optax
    schedule: optax's own computes in float32 from its int32 count, and
    XLA's float32 pow is not correctly rounded and rounds differently
    inside and outside a compiled scan, so its last bit is no parity
    target (`test_exponential_decay_on_the_count_tensor` holds the port's
    `exponential_decay` to it within one float32 ulp)."""
    return lambda count: LR * 0.5 ** (count.astype(jnp.float64) / num_batches)


def _jax_optimizer(name, num_batches):
    if name == "adam":
        return optax.adam(LR)
    if name == "clip":
        return optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
    if name == "lr_decay":
        return optax.adam(_schedule64(num_batches))
    return adam_bf16_moments(LR)


def _port_trainer(name, params, num_batches, batch_size):
    """The port's trainer of the same options; under `lr_decay` the same
    float64 schedule of the port's int32 step count."""
    opt = td.make_optimizer(params, "adam_bf16" if name == "adam_bf16" else "adam", LR)
    extra = {"clip": dict(grad_clip_norm=1.0),
             "lr_decay": dict(lr=lambda count: LR * 0.5 ** (count.double() / num_batches))}
    return td.make_scan_epochs(opt, float(N), JITTER, num_batches, batch_size,
                               **extra.get(name, {}))


def test_exponential_decay_on_the_count_tensor():
    """`exponential_decay` of the step's int32 count computes in float32, as
    optax's schedule of its int32 count does, and lands within one float32
    ulp of it at every count (the port's pow is correctly rounded, XLA's
    is not quite: equal at most counts)."""
    sched, ours = _schedule(7), td.exponential_decay(LR, 0.5, 7)
    counts = np.arange(0, 400, dtype=np.int32)
    want = np.array(sched(jnp.asarray(counts)))
    got = np.stack([ours(torch.tensor(c)).numpy() for c in counts])
    assert got.dtype == want.dtype == np.float32
    gap = np.abs(got.view(np.int32) - want.view(np.int32))
    assert gap.max() <= 1 and (gap == 0).mean() > 0.8


@pytest.mark.parametrize("batch_size", [12, N])
@pytest.mark.parametrize("optimizer", ["adam", "clip", "lr_decay", "adam_bf16"])
def test_scan_epochs_match_jax(optimizer, batch_size):
    """Two epochs of the port's `make_scan_epochs` against the JAX one from
    the same parameters (the length-scale logs frozen) and the same draws:
    three batches a epoch with 6 padded rows, or one batch of the whole
    data."""
    num_batches = -(-N // batch_size)
    x, y, idx = _data()
    Z = np.linspace(0.0, 1.0, M_IND)
    p0 = jd.apply_hyperpars(jax_init_params(3, D, M_IND), {"length_scales_L0_log": -1.0})
    key = jax.random.PRNGKey(11)

    jopt = _jax_optimizer(optimizer, num_batches)
    mask = jd.freeze_mask(p0, True)
    run = jd.make_scan_epochs(jopt, float(N), JITTER, num_batches, batch_size)
    args = (p0, jopt.init(p0), mask, jnp.asarray(Z), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(idx), key)
    want_p, _, want_losses = run.lower(*args, n_epochs=EPOCHS).compile(FAST_COMPILE)(*args)

    pt = tc.CNMGPParams(*(torch.tensor(np.array(a), requires_grad=True) for a in p0))
    trainer = _port_trainer(optimizer, pt, num_batches, batch_size)
    T = torch.as_tensor
    losses = trainer(pt, td.freeze_mask(pt, True), T(Z), T(x), T(y), T(idx),
                     JaxEpochDraws(key, EPOCHS, N, num_batches, batch_size), EPOCHS)
    assert losses.shape == (EPOCHS * num_batches,)
    assert_close(losses, want_losses, rtol=1e-8)
    for name, t, a in zip(tc.CNMGPParams._fields, pt, want_p):
        assert_close(t, a, rtol=1e-8, atol=1e-12)
    for name in td.FROZEN_WHEN_FIXED:
        assert float(getattr(pt, name).detach()) == float(getattr(p0, name))


def test_mesh_raises_naming_the_roadmap_item():
    """`mesh`, which raised until the multi-device layer was ported (the
    test keeps its name), runs: on the 1 x 1 mesh of one process without a
    process group, two epochs give the losses and parameters of the run
    without a mesh bit for bit (tests/test_torch_parallel.py holds two
    ranks)."""
    x, y, idx = (torch.as_tensor(a) for a in _data())
    Z = torch.linspace(0.0, 1.0, 4, dtype=torch.float64)
    runs = []
    for mesh in (None, make_mesh()):
        pt = tc.init_params(torch.Generator().manual_seed(0), D, 4, dtype=torch.float64,
                            device="cpu")
        pt = tc.CNMGPParams(*(t.requires_grad_(True) for t in pt))
        run = td.make_scan_epochs(td.make_optimizer(pt, "adam", LR), float(N), JITTER, 3, 12,
                                  mesh=mesh)
        losses = run(pt, td.freeze_mask(pt, True), Z, x, y, idx,
                     torch.Generator().manual_seed(1), EPOCHS)
        runs.append((losses, pt))
    (l0, p0), (l1, p1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_scan_epochs_keeps_the_jax_signature():
    import inspect

    want = list(inspect.signature(jd.make_scan_epochs).parameters.items())
    got = list(inspect.signature(td.make_scan_epochs).parameters.items())
    assert [n for n, _ in got[:len(want)]] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.default == w.default and g.kind == w.kind


@pytest.mark.parametrize("options, fused", [
    ({}, True),
    ({"chunked_test_trace": True, "test": True}, True),
    ({"divergence_rollback": True}, True),
    ({"verbose": True}, False),
    ({"do_stop_criterion": True}, False),
    ({"test": True}, False),
])
def test_inference_takes_the_fused_trainer_where_jax_does(options, fused, monkeypatch):
    """The JAX condition (dsvi.py:456-460): no test set or the chunked trace,
    no stop criterion, not verbose.  The fused trainer runs every epoch of
    those runs, one a call; the other paths never build it."""
    calls, real = [], td.make_scan_epochs

    def recorded(*args, **kw):
        run = real(*args, **kw)

        def counted(*a):
            calls.append(a[-1])
            return run(*a)

        counted.step = run.step
        return counted

    monkeypatch.setattr(td, "make_scan_epochs", recorded)
    X, Y, Xt, Yt = sim_illustration_low_freq(seed=1)
    options = dict(options)
    test = dict(X_test_list=Xt, Y_test_list=Yt) if options.pop("test", False) else {}
    res = td.inference(X, Y, np.linspace(0, 1, 4), 64, 2, itnum=3, show_ELBO=False,
                       dtype=torch.float64, device="cpu", **test, **options)
    assert calls == ([1, 1, 1] if fused else [])
    assert len(res.loss_list) == 3 * -(-sum(len(a) for a in X) // 64)


class _ReplayedBody:
    """A stand-in for `torch.cuda.CUDAGraph` on the CPU: `dsvi._capture`
    keeps the body, and a replay runs it again op by op."""

    def __init__(self, keep_graph=False):
        pass

    def instantiate(self):
        pass

    def register_generator_state(self, generator):
        self.generator = generator

    def replay(self):
        self.body()


class _NoStream:
    def __init__(self, *args, **kwargs):
        pass

    def wait_stream(self, other):
        pass


@pytest.mark.parametrize("optimizer", ["adam", "lr_decay", "adam_bf16"])
def test_graph_path_replays_the_eager_epochs_on_the_cpu(optimizer, monkeypatch):
    """`_EpochGraphs`' control flow (the warmup steps and the state they
    restore, the shuffle, the cursor, the losses) with graphs whose replay
    reruns the captured body: two epochs equal two eager epochs from the
    same state bit for bit, the parameters too."""
    import contextlib

    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.dsvi import (
        _EpochGraphs,
        _eager_epoch,
    )

    for name, fake in (("CUDAGraph", _ReplayedBody), ("Stream", _NoStream),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("current_stream", lambda device=None: _NoStream()),
                       ("synchronize", lambda device=None: None), ("empty_cache", lambda: None),
                       ("memory_reserved", lambda device=None: 0)):
        monkeypatch.setattr(torch.cuda, name, fake)
    monkeypatch.setattr(td, "_capture", lambda graph, body: setattr(graph, "body", body))
    monkeypatch.setattr(td.profiling, "graph_kernel_nodes", lambda graph: 0)
    x, y, idx = (torch.as_tensor(a) for a in _data(2))
    Z = torch.linspace(0.0, 1.0, M_IND, dtype=torch.float64)
    runs = []
    for _ in range(2):
        p = tc.init_params(torch.Generator().manual_seed(4), D, M_IND, dtype=torch.float64,
                           device="cpu")
        p = tc.CNMGPParams(*(t.clone().requires_grad_(True) for t in p))
        runs.append((p, _port_trainer(optimizer, p, 3, 12)))
    (pg, run_g), (pe, run_e) = runs
    mask = td.freeze_mask(pg, True)
    graphs = _EpochGraphs(run_g.step, pg, mask, Z, x, y, idx,
                          td.EpochDraws(torch.Generator().manual_seed(5), M_IND, 12, D,
                                        torch.float64), 3, 12)
    got = torch.zeros(6, dtype=torch.float64)
    for e in range(2):
        graphs.epoch(got[3 * e:3 * e + 3])
    draws = td.EpochDraws(torch.Generator().manual_seed(5), M_IND, 12, D, torch.float64)
    want = torch.cat([_eager_epoch(run_e.step, pe, mask, Z, x, y, idx, draws, 3, 12)
                      for _ in range(2)])
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    assert all(torch.equal(a, b) for a, b in zip(pg, pe))
    assert int(run_g.step.count) == int(run_e.step.count) == 6
