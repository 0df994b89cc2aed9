"""DSVI training: Adam over the negative stochastic ELBO.

The JAX package's `infer/dsvi.py` (the reference's `inference()` entry point,
nmgp_dsvi.py:758-909):

  - Adam with a freeze mask over the three length-scale log hyperparameters
    (the reference's `fix_hyperpars`) and a zero for every non-finite
    gradient entry;
  - hyperparameter overrides by name, with the intended semantics (the
    reference writes `sigma2_L1_log` into `sigma2_L0_log`,
    nmgp_dsvi.py:784-785);
  - minibatch epochs shuffled on the device, the last batch padded with rows
    of weight 0;
  - the epoch-window stop criterion and the periodic ELBO probe;
  - checkpoint save/resume (nmgp_dsvi.py:789-792, 893-899) through
    `utils.checkpoint`, in the JAX package's file format;
  - the divergence rollback and the chunked test trace of the JAX fast path.

The JAX package's fused trainer, `make_scan_epochs`, runs many epochs in
one `lax.scan` with the shuffle on the device; its `inference()` takes it on
the fast path (no `verbose`, no stop criterion, no per-step test RMSE).
Here `make_scan_epochs` runs each epoch on a CUDA card as replays of two
CUDA graphs, the shuffle's and the step's (`_EpochGraphs`), so the host
launches one graph a step instead of its ~1,000 kernels; on the CPU the
same epoch runs op by op.  `inference()` takes it where the JAX package
does, one epoch a call, and the other paths keep `make_train_step`.  Losses
stay on the device until an epoch ends: the host reads them once an epoch.
The epoch is therefore the port's chunk, where the JAX package's is as many
epochs as fit its dispatch budget: the rollback guard checks each epoch and
the chunked test trace has one entry per epoch.

Data-parallel training (`mesh`, a `parallel.mesh.Mesh`): every rank holds
the whole data and the same generator state, so each builds the same
shuffle and draws the same noise of the whole minibatch; it takes its rows
of the minibatch and of that noise (the "data" coordinate's block), and
its -SELBO terms: the reconstruction scaled by n_total over the whole
minibatch's weight, the KLs on data rank 0 alone.  The gradients and the
loss are summed over "data" in one all-reduce, then every rank applies the
same masked Adam step: the JAX semantics, where GSPMD splits the rows and
inserts the gradient psum (dsvi.py:129-145).  With the "nccl" backend the
all-reduce is captured in the step's CUDA graph; "gloo" cannot be
captured, so its ranks (several may share one card) run the step eagerly,
a CUDA tensor staged through the host for the all-reduce.  Both run the
same kernels.

Spans (`utils.profiling.span`, recorded while a profiler records): each
epoch is the root `dsvi.epoch`, in it the shuffle `dsvi.shuffle`, each
step `dsvi.step` (a replay of the step's graph, or an eager step) and the
copy of the losses out `dsvi.losses` (also `inference()`'s host read of
them); a capture of the graphs is `dsvi.capture`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, DSVI_JITTER, resolve_device
from ..models import cnmgp
from ..models.cnmgp import CNMGPParams
from ..ops import cuda_kernels
from ..utils import checkpoint as ckpt
from ..utils import profiling
from ..utils.data import flatten_output_lists
from . import optimizers
from .optimizers import AdamBf16Moments

__all__ = [
    "FROZEN_WHEN_FIXED",
    "DSVIResult",
    "apply_hyperpars",
    "freeze_mask",
    "make_optimizer",
    "exponential_decay",
    "make_train_step",
    "EpochDraws",
    "make_scan_epochs",
    "inference",
]

FROZEN_WHEN_FIXED = (
    "length_scales_tildeell_log",
    "length_scales_L0_log",
    "length_scales_L1_log",
)
_HYPERPARS = (
    "sigma2_tildeell_log",
    "length_scales_tildeell_log",
    "sigma2_L0_log",
    "length_scales_L0_log",
    "sigma2_L1_log",
    "length_scales_L1_log",
    "sigma2_err_log",
)


@dataclass
class DSVIResult:
    params: CNMGPParams
    Z: torch.Tensor
    loss_list: List[float]
    time_list: List[float]
    elbo_trace: List[float] = field(default_factory=list)
    rmse_test_list: List[float] = field(default_factory=list)
    # (wall seconds, epochs done, rmse) after each epoch of
    # `chunked_test_trace`, and the rollbacks `divergence_rollback` took
    rmse_trace: List[tuple] = field(default_factory=list)
    rollbacks: int = 0


def apply_hyperpars(params: CNMGPParams, hyperpars: Optional[Dict[str, float]]) -> CNMGPParams:
    """Override the named log-hyperparameters (nmgp_dsvi.py:779-814), each
    by its own name."""
    if not hyperpars:
        return params
    like = params.mu_v
    return params._replace(**{
        name: torch.tensor(float(hyperpars[name]), dtype=like.dtype, device=like.device)
        for name in _HYPERPARS if name in hyperpars
    })


def freeze_mask(params: CNMGPParams, fix_hyperpars: bool) -> CNMGPParams:
    """0/1 multipliers of the gradients, one per parameter: 0 on the frozen
    length-scale logs when `fix_hyperpars`."""
    frozen = FROZEN_WHEN_FIXED if fix_hyperpars else ()
    return CNMGPParams(*(
        (torch.zeros_like if name in frozen else torch.ones_like)(t, requires_grad=False)
        for name, t in zip(CNMGPParams._fields, params)
    ))


def make_optimizer(params: CNMGPParams, name: str = "adam", lr: float = 0.01):
    """"adam" (`torch.optim.Adam`, the formula of `optax.adam`, eps 1e-8) or
    "adam_bf16" (`AdamBf16Moments`) over the parameter tensors.  For CUDA
    parameters the rate is a 0-d tensor on their device and Adam is
    capturable (its count on the device too), so that a CUDA graph of the
    step reads both anew at every replay; CPU parameters keep a float rate."""
    params = list(params)
    p0 = params[0]
    rate = torch.tensor(float(lr), dtype=p0.dtype, device=p0.device) if p0.is_cuda else float(lr)
    if name == "adam":
        return torch.optim.Adam(params, lr=rate, eps=1e-8, capturable=p0.is_cuda)
    if name == "adam_bf16":
        return AdamBf16Moments(params, lr=rate)
    raise ValueError(f"unknown optimizer {name!r}")


def exponential_decay(lr: float, decay_rate: float, transition_steps: int):
    """Step -> rate, lr * decay_rate ** (step / transition_steps): optax's
    `exponential_decay` with its default staircase=False, so the rate falls
    a little every step.  The step may be a number or a tensor (the count
    of `make_train_step`, on the device)."""
    return lambda t: lr * decay_rate ** (t / transition_steps)


def _noise_rows(noise: cnmgp.CNMGPNoise, rows: slice) -> cnmgp.CNMGPNoise:
    """The draws of the minibatch rows `rows`: the per-row noise sliced on
    its last dim, the inducing draws (z_v1, z_v2) whole."""
    return noise._replace(**{k: getattr(noise, k)[..., rows] for k in ("z_te", "z_diag", "z_off")})


class _TrainStep:
    """The step of `make_train_step`; `count` is the step count, int32 on
    the parameters' device, as optax's count.  With `mesh`, one rank's
    share of a data-parallel step (the module docstring)."""

    def __init__(self, optimizer, n_total, jitter, kl_mode, grad_clip_norm, lr, start,
                 mesh=None):
        self.optimizer, self.n_total, self.jitter, self.kl_mode = optimizer, n_total, jitter, kl_mode
        self.grad_clip_norm, self.lr, self.mesh = grad_clip_norm, lr, mesh
        p0 = optimizer.param_groups[0]["params"][0]
        self.count = torch.tensor(int(start), dtype=torch.int32, device=p0.device)

    def _shard_loss(self, params, Z, bx, by, bidx, bw, noise):
        """This rank's terms of the minibatch's -SELBO, backward, then the
        gradients and the loss summed over "data" in one all-reduce."""
        mesh = self.mesh
        rows = mesh.row_slice(bx.shape[0])
        loss = cnmgp.negative_selbo(params, Z, bx[rows], by[rows], bidx[rows], bw[rows],
                                    self.n_total, _noise_rows(noise, rows), self.jitter,
                                    self.kl_mode, batch_size=torch.sum(bw),
                                    with_kl=mesh.coordinate() == 0)
        loss.backward()
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        mesh.all_reduce_(flat)
        at = 0
        for p, g in zip(params, grads):
            p.grad = flat[at:at + g.numel()].view_as(g)
            at += g.numel()
        return flat[-1]

    def __call__(self, params: CNMGPParams, grad_mask: CNMGPParams, Z, bx, by, bidx, bw, noise):
        opt = self.optimizer
        opt.zero_grad(set_to_none=True)
        if self.mesh is None:
            loss = cnmgp.negative_selbo(params, Z, bx, by, bidx, bw, self.n_total, noise,
                                        self.jitter, self.kl_mode)
            loss.backward()
        else:
            loss = self._shard_loss(params, Z, bx, by, bidx, bw, noise)
        grads = []
        for p, m in zip(params, grad_mask):
            p.grad = torch.where(torch.isfinite(p.grad), p.grad, 0.0) * m
            grads.append(p.grad)
        if self.grad_clip_norm is not None:
            clip = self.grad_clip_norm
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / g_norm * clip))
        if self.lr is not None:
            optimizers.set_rate(opt, self.lr(self.count))
        opt.step()
        self.count.add_(1)
        return loss.detach()


def make_train_step(
    optimizer: torch.optim.Optimizer,
    n_total: float,
    jitter: float = DSVI_JITTER,
    kl_mode: str = "true",
    grad_clip_norm: Optional[float] = None,
    lr: Optional[Callable] = None,
    start: int = 0,
):
    """One DSVI step, (params, grad_mask, Z, bx, by, bidx, bw, noise) ->
    loss, a 0-d tensor left on the device.  `params` are the tensors
    `optimizer` updates, in place.  The JAX order (dsvi.py:90-110, 420-423):
    gradients of the negative SELBO, non-finite entries -> 0, the freeze
    mask, then, when `grad_clip_norm` is given, optax's global-norm clip,
    then the Adam update.  `lr`, when given, is the rate of each step from
    the step count (`start` for the first step: 0, or the count of a
    resumed checkpoint), as an optax schedule is read: it is called with
    the count as an int32 0-d tensor on the parameters' device (optax's
    count; `exponential_decay` of it computes in float32, as optax's does)
    and written into the optimizer's rate without a host read, so under a
    CUDA graph it must compute with tensor operations."""
    return _TrainStep(optimizer, n_total, jitter, kl_mode, grad_clip_norm, lr, start)


class EpochDraws:
    """The randomness of DSVI epochs from one `torch.Generator`, in the
    order an epoch takes it: the shuffle's sort keys (`sort_keys(n)`, n
    int64 keys in [0, 2^32), JAX's random 32-bit keys; not drawn at one
    batch an epoch), then each step's noise (`noise()`, a `CNMGPNoise` of
    one draw).  A test passes an object with the same two methods that
    gives the JAX package's draws instead; under a CUDA graph the object
    must also carry the `generator` its draws come from."""

    def __init__(self, generator: torch.Generator, num_inducing: int, batch_size: int,
                 dim_outputs: int, dtype=DEFAULT_DTYPE):
        self.generator = generator
        self.shape = (num_inducing, batch_size, dim_outputs)
        self.dtype = dtype

    def sort_keys(self, n: int) -> torch.Tensor:
        return torch.randint(0, 2**32, (n,), generator=self.generator, dtype=torch.int64,
                             device=self.generator.device)

    def noise(self) -> cnmgp.CNMGPNoise:
        return cnmgp.draw_train_noise(self.generator, 1, *self.shape, dtype=self.dtype)


def _epoch_arrays(x, y, idx, keys, num_batches: int, batch_size: int):
    """An epoch's batches, (num_batches, batch_size, ...) each, and their
    0/1 weights (JAX `epoch_body`, dsvi.py:159-175): at one batch the data
    as it is, else the rows in the order of a stable sort of `keys` (a
    uniform permutation), zero-padded to num_batches * batch_size rows of
    weight 0."""
    n = x.shape[0]
    if num_batches == 1:
        return x[None], y[None], idx[None], torch.ones((1, n), dtype=x.dtype, device=x.device)
    order = torch.sort(keys, stable=True).indices
    pad = num_batches * batch_size - n

    def padded(a):
        a = torch.cat([a[order], a.new_zeros((pad,) + a.shape[1:])])
        return a.reshape((num_batches, batch_size) + a.shape[1:])

    w = torch.cat([x.new_ones(n), x.new_zeros(pad)]).reshape(num_batches, batch_size)
    return padded(x), padded(y), padded(idx), w


def _eager_epoch(step, params, grad_mask, Z, x, y, idx, draws, num_batches: int,
                 batch_size: int, after_step: Optional[Callable[[], None]] = None):
    """One epoch, op by op: the body of `make_scan_epochs` on the CPU, and
    the loop of `inference()`'s other paths (`after_step`, if given, is
    called after each step).  Returns the (num_batches,) losses."""
    with profiling.span("dsvi.epoch"):
        with profiling.span("dsvi.shuffle"):
            keys = draws.sort_keys(x.shape[0]) if num_batches > 1 else None
            ex, ey, ei, ew = _epoch_arrays(x, y, idx, keys, num_batches, batch_size)
        losses = []
        for b in range(num_batches):
            with profiling.span("dsvi.step"):
                losses.append(step(params, grad_mask, Z, ex[b], ey[b], ei[b], ew[b],
                                   draws.noise()))
            if after_step is not None:
                after_step()
        with profiling.span("dsvi.losses"):
            return torch.stack(losses)


# Steps run before a capture (the PyTorch whole-network-capture recipe),
# on a side stream, their effects then undone.
_WARMUP_STEPS = 3


def _capture(graph: torch.cuda.CUDAGraph, body: Callable[[], None]) -> None:
    """Capture `body` into `graph`."""
    with torch.cuda.graph(graph):
        body()


class _EpochGraphs:
    """The two CUDA graphs of one run's tensors: the shuffle (the sort keys
    drawn, the rows sorted into the static epoch buffers, the cursor reset)
    and the step (batch `cursor` gathered from those buffers, the noise
    drawn, forward, backward and the optimizer, the loss written at
    `cursor`, the cursor incremented).  Both draw from the run's generator,
    which is registered with each, so every replay draws anew.

    Captured after `_WARMUP_STEPS` steps on a side stream (which load the
    libraries and create the optimizer's state), whose effects on the
    parameters, the optimizer, the step count and the generator are then
    restored in place.  `step_launches` are the port kernel launches a step
    replay makes, `step_kernels` every kernel node of the step's graph
    (`profiling.graph_kernel_nodes`, counted once, at capture; None where
    the CUDA runtime cannot be loaded to read them),
    `capture_s` the seconds of warmup and capture (the span `dsvi.capture`
    of `make_scan_epochs`; the counters `dsvi.captures`, `dsvi.capture_s`
    and `dsvi.step_graph_kernels` add each capture's), and `pool_bytes` the
    memory the two graphs' pools reserved.  The object keeps every tensor
    the graphs address alive as long as it lives."""

    def __init__(self, step: _TrainStep, params, grad_mask, Z, x, y, idx, draws, num_batches: int,
                 batch_size: int):
        t0 = time.perf_counter()
        gen, dev = draws.generator, x.device
        n = x.shape[0]
        bufs = _epoch_arrays(x, y, idx, x.new_zeros(n, dtype=torch.int64), num_batches,
                             batch_size)
        ex, ey, ei, ew = (b.clone() for b in bufs)
        cursor = torch.zeros((), dtype=torch.int64, device=dev)
        losses = torch.zeros(num_batches, dtype=params[0].dtype, device=dev)
        self.losses, self.num_batches = losses, num_batches

        def shuffle():
            keys = draws.sort_keys(n) if num_batches > 1 else None
            for buf, a in zip((ex, ey, ei, ew), _epoch_arrays(x, y, idx, keys, num_batches,
                                                              batch_size)):
                buf.copy_(a)
            cursor.zero_()

        def one_step():
            at = cursor.view(1)
            bx, by, bi, bw = (a.index_select(0, at)[0] for a in (ex, ey, ei, ew))
            loss = step(params, grad_mask, Z, bx, by, bi, bw, draws.noise())
            losses.index_copy_(0, at, loss.view(1))
            cursor.add_(1)

        opt = step.optimizer
        snap = _snapshot(params, opt, gen, step)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            shuffle()
            for _ in range(_WARMUP_STEPS):
                cursor.zero_()
                one_step()
        torch.cuda.current_stream(dev).wait_stream(side)
        _restore(snap, params, opt, gen, step)

        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        # the step's graph is kept past its capture, so that its nodes can be read
        self.shuffle_graph = torch.cuda.CUDAGraph()
        self.step_graph = torch.cuda.CUDAGraph(keep_graph=True)
        cuda_kernels.take_captured()
        for graph, body in ((self.shuffle_graph, shuffle), (self.step_graph, one_step)):
            graph.register_generator_state(gen)
            _capture(graph, body)
        self.step_graph.instantiate()
        self.step_launches = cuda_kernels.take_captured()
        self.step_kernels = profiling.graph_kernel_nodes(self.step_graph)
        # the graphs read and write these tensors by address: the two bodies
        # keep them (the epoch buffers, the cursor, the inputs) alive, and
        # refer to no attribute of this object, so it is freed, with the
        # graphs' memory, as soon as its owner drops it
        self._bodies = (shuffle, one_step)
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0
        profiling.count("dsvi.captures")
        profiling.count("dsvi.capture_s", self.capture_s)
        if self.step_kernels is not None:
            profiling.count("dsvi.step_graph_kernels", self.step_kernels)

    def epoch(self, out: torch.Tensor) -> None:
        """Replay one epoch: the shuffle, then each step; the losses go to `out`."""
        with profiling.span("dsvi.epoch"):
            with profiling.span("dsvi.shuffle"):
                self.shuffle_graph.replay()
            for _ in range(self.num_batches):
                with profiling.span("dsvi.step"):
                    self.step_graph.replay()
                    cuda_kernels.count_replay(self.step_launches)
            with profiling.span("dsvi.losses"):
                out.copy_(self.losses)


class _ScanEpochs:
    """The `run` of `make_scan_epochs`; `graphs` holds its captured
    `_EpochGraphs`, one per set of input tensors."""

    def __init__(self, step: _TrainStep, num_batches: int, batch_size: int):
        self.step, self.num_batches, self.batch_size = step, num_batches, batch_size
        self.graphs: Dict[tuple, _EpochGraphs] = {}
        # a gloo all-reduce cannot be captured in a CUDA graph
        self.eager = step.mesh is not None and step.mesh.backend == "gloo"

    def __call__(self, params, grad_mask, Z, x, y, idx, draws, n_epochs: int) -> torch.Tensor:
        params, grad_mask = CNMGPParams(*params), CNMGPParams(*grad_mask)
        if isinstance(draws, torch.Generator):
            draws = EpochDraws(draws, Z.shape[0], self.batch_size, params.num_outputs, x.dtype)
        nb = self.num_batches
        if not x.is_cuda or self.eager:
            return torch.cat([
                _eager_epoch(self.step, params, grad_mask, Z, x, y, idx, draws, nb,
                             self.batch_size)
                for _ in range(n_epochs)])
        gen = getattr(draws, "generator", None)
        if not isinstance(gen, torch.Generator):
            raise TypeError("make_scan_epochs on CUDA tensors draws from a torch.Generator: pass "
                            "one, or a draws object with its `generator`")
        inputs = (*params, *grad_mask, Z, x, y, idx)
        key = (tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in inputs), str(x.device),
               id(gen))
        if key not in self.graphs:
            with profiling.span("dsvi.capture"):
                self.graphs[key] = _EpochGraphs(self.step, params, grad_mask, Z, x, y, idx, draws,
                                                nb, self.batch_size)
        graphs = self.graphs[key]
        out = torch.empty(n_epochs * nb, dtype=graphs.losses.dtype, device=x.device)
        for e in range(n_epochs):
            graphs.epoch(out[e * nb:(e + 1) * nb])
        return out


def make_scan_epochs(
    optimizer: torch.optim.Optimizer,
    n_total: float,
    jitter: float,
    num_batches: int,
    batch_size: int,
    mesh=None,
    kl_mode: str = "true",
    grad_clip_norm: Optional[float] = None,
    lr: Optional[Callable] = None,
    start: int = 0,
):
    """The fused multi-epoch trainer (JAX `make_scan_epochs`,
    dsvi.py:113-227): returns run(params, grad_mask, Z, x, y, idx, draws,
    n_epochs), which trains `n_epochs` epochs and returns their
    (n_epochs * num_batches,) losses as a tensor on the device.

    Each epoch is JAX's `epoch_body`: at one batch the whole data,
    unshuffled, with weight 1; else the rows shuffled by one stable sort on
    random 32-bit keys and zero-padded to num_batches * batch_size rows of
    weight 0; then the step of `make_train_step` on each batch in turn.
    The parameters and `optimizer`'s state are updated in place: that is
    the port's counterpart of the (params, opt_state) JAX returns.  optax's
    chained clip and schedule are `grad_clip_norm` and `lr` (with the
    count `start`), as `make_train_step` takes them.  `draws` is a
    `torch.Generator` (`EpochDraws` of it) or a draws object with the
    methods of `EpochDraws`.

    On CUDA tensors an epoch is one replay of a CUDA graph of the shuffle,
    then `num_batches` replays of a CUDA graph of the step (`_EpochGraphs`;
    a graph of a whole epoch would hold num_batches times a step's ~1,000
    kernels, captured anew for every shape).  The graphs are captured at
    the first call on a set of input tensors and kept, keyed by their
    addresses, shapes and dtypes, the device and the generator; the
    optimizer, `kl_mode`, the clip and the schedule are the factory's.  A
    capture that fails raises.  On CPU tensors the same epoch runs op by
    op.

    `mesh` (a `parallel.mesh.Mesh`) makes each step data-parallel over its
    "data" axis (the module docstring): every rank calls `run` with the
    whole data, the same parameters and the same draws, and takes its rows
    of each minibatch, which must split evenly.  The parameters stay equal
    on every rank, and the losses are the whole minibatches'.  Under the
    "nccl" backend the step's graph holds the all-reduce; under "gloo" the
    epochs run op by op."""
    step = _TrainStep(optimizer, n_total, jitter, kl_mode, grad_clip_norm, lr, start, mesh)
    return _ScanEpochs(step, num_batches, batch_size)


def _diverged(losses: List[float], n_before: int) -> bool:
    """The JAX guard's test of a chunk (dsvi.py:511-517): a non-finite loss,
    or, once a finite loss exists before it, a loss above 10x |the least
    of them| (an escape from the loss basin)."""
    new = np.asarray(losses[n_before:], dtype=np.float64)
    if not np.all(np.isfinite(new)):
        return True
    prev = np.asarray(losses[:n_before], dtype=np.float64)
    prev = prev[np.isfinite(prev)]
    return bool(prev.size) and float(np.max(new)) > 10.0 * abs(float(np.min(prev)))


def _clone(v):
    return v.clone() if isinstance(v, torch.Tensor) else v


def _snapshot(params, opt: torch.optim.Optimizer, gen: torch.Generator, step: _TrainStep):
    """Copies, on the device, of the parameters, the optimizer's state and
    rates and the step count, and the generator's state."""
    state = {p: {k: _clone(v) for k, v in opt.state[p].items()} for p in params if p in opt.state}
    rates = [_clone(group["lr"]) for group in opt.param_groups]
    return ([p.detach().clone() for p in params], state, rates, step.count.clone(),
            gen.get_state())


def _restore(snap, params, opt: torch.optim.Optimizer, gen: torch.Generator, step: _TrainStep):
    """Write a `_snapshot` back in place, into the tensors a CUDA graph of
    the step captured: the parameters, each optimizer state tensor (zeroed,
    as a fresh optimizer's, where the snapshot had no state), the rate
    tensors and the count.  The generator's `set_state` writes its seed and
    offset into the state object that the graphs registered, so the next
    replay draws from there (`graphsafe_set_state` would swap that object
    for another, which the graphs do not see)."""
    values, state, rates, count, rng = snap
    with torch.no_grad():
        for p, v in zip(params, values):
            p.copy_(v)
        for p in params:
            saved = state.get(p, {})
            for k, v in opt.state.get(p, {}).items():
                if not isinstance(v, torch.Tensor):
                    opt.state[p][k] = saved.get(k, v)
                elif k in saved:
                    v.copy_(saved[k])
                else:
                    v.zero_()
        for group, rate in zip(opt.param_groups, rates):
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].copy_(rate)
            else:
                group["lr"] = rate
        step.count.copy_(count)
    gen.set_state(rng)


def _roll_back(snap, params, opt: torch.optim.Optimizer, gen: torch.Generator,
               step: _TrainStep, factor: float):
    """`_restore` a snapshot and scale every param group's rate by `factor`."""
    _restore(snap, params, opt, gen, step)
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].mul_(factor)
        else:
            group["lr"] *= factor


def _resume(path: str, params, opt, inject: bool, schedule: bool, hyperpars) -> int:
    """Load a checkpoint into `params` (in place) and `opt`, then re-apply
    `hyperpars` (the JAX order, dsvi.py:426-433).  Returns the step count."""
    loaded, leaves = ckpt.load_train_state(
        path, params, optimizers.optax_state(opt, params, inject, schedule))
    loaded = apply_hyperpars(loaded, hyperpars)
    with torch.no_grad():
        for p, v in zip(params, loaded):
            p.copy_(v)
    return optimizers.load_optax_state(opt, params, leaves, inject, schedule)


def inference(
    X_train_list,
    Y_train_list,
    z,
    batch_size: int,
    dim_outputs: int,
    hyperpars: Optional[Dict[str, float]] = None,
    fix_hyperpars: bool = True,
    mu_v=None,
    mu_W=None,
    mu_U=None,
    sqrt_v=None,
    sqrt_W=None,
    sqrt_U=None,
    lr: Union[float, Callable] = 0.01,
    itnum: int = 1000,
    do_stop_criterion: bool = False,
    seed: int = 22,
    verbose: bool = False,
    PATH: Optional[str] = None,
    continuous_training: bool = False,
    show_ELBO: bool = True,
    save_model: bool = False,
    X_test_list=None,
    Y_test_list=None,
    dtype=None,
    jitter: float = 1e-4,
    elbo_every: int = 100,
    elbo_samples: int = 100,
    mesh=None,
    kl_mode: str = "true",
    grad_clip_norm: Optional[float] = None,
    lr_decay: Optional[float] = None,
    chunked_test_trace: bool = False,
    divergence_rollback: bool = False,
    rollback_lr_factor: float = 0.5,
    max_rollbacks: int = 5,
    optimizer: str = "adam",
    ckpt_moments_dtype=None,
    device=None,
) -> DSVIResult:
    """Train a CNMGP by DSVI; the signature of the JAX `inference()` (and of
    the reference's, nmgp_dsvi.py:758-761).  Runs on the first CUDA card
    unless `device` names another.

    `lr` is a float or a callable step -> rate (given the step count as a
    0-d tensor on the device, see `make_train_step`); `lr_decay` multiplies the
    rate by lr_decay per epoch, smoothly every step (optax's
    exponential_decay, transition_steps = batches per epoch, staircase
    off).  `batch_size <= 0` or above the data size means full batch.
    Randomness (initialization, shuffles, noise, ELBO probes) comes from one
    `torch.Generator` seeded with `seed` on the device; the same seed gives
    other numbers than the JAX package.  `time_list` holds, for each step,
    the seconds since the start at the end of its epoch, when its loss was
    read.  On a CUDA card a float32 run goes through the kernels and a
    float64 one (`dtype=torch.float64`) through their plain versions, as
    the JAX package takes Pallas only for float32.

    Checkpoints (`utils.checkpoint`, the JAX package's file, so either
    package resumes the other's): with `PATH` and `continuous_training`
    the run starts from the parameters and optimizer state saved there
    (the length-scale hyperparameters of `hyperpars` re-applied when
    `fix_hyperpars`; under `divergence_rollback` the saved rate); with
    `PATH` and `save_model` it saves them at the end, the optimizer state's
    floats cast to `ckpt_moments_dtype` when given.  Without `PATH` these
    options do nothing, as in the JAX package.

    `divergence_rollback` (a constant float `lr` only) checks each epoch:
    one with a non-finite loss, or with a loss above 10x |the least
    earlier loss|, is undone (parameters, optimizer state and generator,
    so the retry sees the same shuffle and noise) and retried with every
    rate scaled by `rollback_lr_factor`, at most `max_rollbacks` times in
    a run.  `chunked_test_trace` with `X_test_list` computes the test RMSE
    once an epoch into `rmse_test_list` and `rmse_trace` ((wall seconds,
    epochs done, rmse)) instead of every step.  The JAX package applies
    both only on its fast path, so here too they do nothing with `verbose`,
    `do_stop_criterion`, or a test set without `chunked_test_trace`
    (`rollbacks` 0, `rmse_trace` empty).  The JAX chunk is as many epochs
    as fit its dispatch budget, the port's one epoch: its `rmse_trace` has
    an entry per epoch, the JAX one fewer.

    `mesh` (a `parallel.mesh.Mesh` with a "data" axis) trains
    data-parallel on the fast path, as the JAX package does (see
    `make_scan_epochs`); every rank of the mesh calls `inference()` with the
    same arguments, the initial parameters are broadcast from rank 0, every
    rank returns the same result, and only rank 0 saves a checkpoint.  The
    other paths ignore it.  The ELBO probe also prints the memory in use
    (`utils.profiling.print_mem`).
    """
    if divergence_rollback and (lr_decay is not None or callable(lr)):
        raise ValueError(
            "divergence_rollback scales a constant injected learning rate; "
            "it cannot be combined with lr_decay or a schedule (a schedule "
            "recomputes the rate from the step count every update)"
        )
    if lr_decay is not None and callable(lr):
        raise ValueError("lr_decay decays a constant lr; pass one or the other")

    device = resolve_device(device)
    dtype = dtype or DEFAULT_DTYPE
    data = flatten_output_lists(X_train_list, Y_train_list)
    n_total = data.n
    if batch_size <= 0 or batch_size > n_total:
        batch_size = n_total
    num_batches = -(-n_total // batch_size)
    x = torch.as_tensor(data.x, dtype=dtype, device=device)
    y = torch.as_tensor(data.y, dtype=dtype, device=device)
    idx = torch.as_tensor(data.idx, dtype=torch.int64, device=device)
    Z = torch.as_tensor(np.asarray(z).reshape(-1), dtype=dtype, device=device)
    M, D = Z.shape[0], dim_outputs

    gen = torch.Generator(device=device).manual_seed(seed)
    params = cnmgp.init_params(gen, D, M, dtype=dtype, device=device, mu_v=mu_v, mu_W=mu_W,
                               mu_U=mu_U, sqrt_v=sqrt_v, sqrt_W=sqrt_W, sqrt_U=sqrt_U)
    params = apply_hyperpars(params, hyperpars)
    params = CNMGPParams(*(t.detach().clone().requires_grad_(True) for t in params))

    if lr_decay is not None:
        schedule = exponential_decay(float(lr), float(lr_decay), num_batches)
    else:
        schedule = lr if callable(lr) else None
    opt = make_optimizer(params, optimizer, float(lr) if schedule is None else 0.0)
    # the optax state of the same options: inject_hyperparams under the
    # rollback, a schedule's count with a schedule
    layout = dict(inject=divergence_rollback, schedule=schedule is not None)
    start = 0
    if continuous_training and PATH is not None:
        lengthscales = {k: v for k, v in (hyperpars or {}).items() if k.startswith("length_scales")}
        start = _resume(PATH, params, opt, **layout,
                        hyperpars=lengthscales if fix_hyperpars else None)
    if mesh is not None:
        with torch.no_grad():
            for p in params:
                mesh.broadcast_(p.detach(), 0)
    grad_mask = freeze_mask(params, fix_hyperpars)
    draws = EpochDraws(gen, M, batch_size, D, dtype)

    if X_test_list is not None:
        test = flatten_output_lists(X_test_list, Y_test_list)
        xt = torch.as_tensor(test.x, dtype=dtype, device=device)
        it = torch.as_tensor(test.idx, dtype=torch.int64, device=device)
        yt = torch.as_tensor(test.y, dtype=dtype, device=device)

    def test_rmse():
        with torch.no_grad():
            est = cnmgp.predict_y_mean(params, Z, xt, it, jitter)
            return torch.sqrt(torch.mean((est - yt) ** 2))

    # the JAX fast path (dsvi.py:456-460), the only one with the guard and
    # the chunked trace: its epochs run through make_scan_epochs, one an
    # epoch (replays of CUDA graphs on a card), the others through
    # make_train_step
    fast = (X_test_list is None or chunked_test_trace) and not do_stop_criterion and not verbose
    guard = divergence_rollback and fast
    train = dict(grad_clip_norm=grad_clip_norm, lr=schedule, start=start)
    if fast:
        run_epochs = make_scan_epochs(opt, float(n_total), jitter, num_batches, batch_size,
                                      mesh=mesh, kl_mode=kl_mode, **train)
        step = run_epochs.step
    else:
        step = make_train_step(opt, float(n_total), jitter, kl_mode, **train)
    loss_list: List[float] = []
    time_list: List[float] = []
    elbo_trace: List[float] = []
    rmse_test_list: List[float] = []
    rmse_trace: List[tuple] = []
    rollbacks = 0
    ts = time.time()

    def train_epoch(epoch: int) -> List[float]:
        rmses = []
        if fast:
            losses = run_epochs(params, grad_mask, Z, x, y, idx, draws, 1)
        else:
            after = None if X_test_list is None else (lambda: rmses.append(test_rmse()))
            losses = _eager_epoch(step, params, grad_mask, Z, x, y, idx, draws, num_batches,
                                  batch_size, after)
        with profiling.span("dsvi.losses"):
            epoch_losses = losses.tolist()  # the host waits here, once an epoch
        loss_list.extend(epoch_losses)
        time_list.extend([time.time() - ts] * num_batches)
        if rmses:
            rmse_test_list.extend(torch.stack(rmses).tolist())
        if X_test_list is not None and fast:
            rmse = float(test_rmse())
            rmse_trace.append((time.time() - ts, epoch + 1, rmse))
            rmse_test_list.append(rmse)
        return epoch_losses

    epoch = itnum - 1
    for epoch in range(itnum):
        while True:
            if guard:
                snap = _snapshot(params, opt, gen, step)
                marks = [len(a) for a in (loss_list, time_list, rmse_trace, rmse_test_list)]
            epoch_losses = train_epoch(epoch)
            if not guard or rollbacks >= max_rollbacks or not _diverged(loss_list, marks[0]):
                break
            _roll_back(snap, params, opt, gen, step, rollback_lr_factor)
            for a, n in zip((loss_list, time_list, rmse_trace, rmse_test_list), marks):
                del a[n:]
            rollbacks += 1
            print(f"divergence rollback #{rollbacks}: retrying 1 epoch(s) from epoch {epoch} at "
                  f"lr={float(opt.param_groups[0]['lr']):.3g}")
        if verbose:
            for b, loss in enumerate(epoch_losses):
                print(f"epoch: {epoch}/{itnum}, batch: {b + 1}/{num_batches}, loss: {loss:.4f}")

        if do_stop_criterion and epoch % 5 == 4 and epoch > 5:
            la, bn = np.array(loss_list), num_batches
            if la[-bn:].sum() > la[-bn * 6 : -bn * 5].sum():
                print("Stop criteria is satisfied.")
                break

        if show_ELBO and epoch % elbo_every == elbo_every - 1:
            with torch.no_grad():
                noise = cnmgp.draw_train_noise(gen, elbo_samples, M, n_total, D, dtype=dtype)
                elbo = float(cnmgp.elbo_estimate(params, Z, x, y, idx, noise, jitter, kl_mode))
            elbo_trace.append(elbo)
            print(f"epoch: {epoch + 1}, ELBO: {elbo:.4f}")
            profiling.print_mem(epoch + 1)

    if verbose or show_ELBO:
        print(f"training takes {time.time() - ts:.2f}s")
    if save_model and PATH is not None and (mesh is None or mesh.rank == 0):
        ckpt.save_train_state(PATH, params, optimizers.optax_state(opt, params, **layout),
                              epoch=epoch, loss=loss_list[-1], moments_dtype=ckpt_moments_dtype)
    return DSVIResult(
        params=CNMGPParams(*(t.detach() for t in params)),
        Z=Z,
        loss_list=loss_list,
        time_list=time_list,
        elbo_trace=elbo_trace,
        rmse_test_list=rmse_test_list,
        rmse_trace=rmse_trace,
        rollbacks=rollbacks,
    )
