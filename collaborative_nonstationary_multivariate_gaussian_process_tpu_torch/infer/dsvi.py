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

The JAX package runs epochs inside one `lax.scan` per dispatch window; that
was a workaround for a limit of its TPU worker.  Here a step is a plain
Python loop over batches, and losses stay on the device until an epoch ends
(or a probe needs them): the host does not wait for the card on every step.
The epoch is therefore the port's chunk, where the JAX package's is as many
epochs as fit its dispatch budget: the rollback guard checks each epoch and
the chunked test trace has one entry per epoch.
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
from ..utils import checkpoint as ckpt
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
    "adam_bf16" (`AdamBf16Moments`) over the parameter tensors."""
    if name == "adam":
        return torch.optim.Adam(list(params), lr=lr, eps=1e-8)
    if name == "adam_bf16":
        return AdamBf16Moments(list(params), lr=lr)
    raise ValueError(f"unknown optimizer {name!r}")


def exponential_decay(lr: float, decay_rate: float, transition_steps: int):
    """Step -> rate, lr * decay_rate ** (step / transition_steps): optax's
    `exponential_decay` with its default staircase=False, so the rate falls
    a little every step."""
    return lambda t: lr * decay_rate ** (t / transition_steps)


def make_train_step(
    optimizer: torch.optim.Optimizer,
    n_total: float,
    jitter: float = DSVI_JITTER,
    kl_mode: str = "true",
    grad_clip_norm: Optional[float] = None,
    lr: Optional[Callable[[int], float]] = None,
    start: int = 0,
):
    """One DSVI step, (params, grad_mask, Z, bx, by, bidx, bw, noise) ->
    loss, a 0-d tensor left on the device.  `params` are the tensors
    `optimizer` updates, in place.  The JAX order (dsvi.py:90-110, 420-423):
    gradients of the negative SELBO, non-finite entries -> 0, the freeze
    mask, then, when `grad_clip_norm` is given, optax's global-norm clip,
    then the Adam update.  `lr`, when given, is the rate of each step from
    the step count (`start` for the first step: 0, or the count of a
    resumed checkpoint), as an optax schedule is read."""
    count = start

    def step(params: CNMGPParams, grad_mask: CNMGPParams, Z, bx, by, bidx, bw, noise):
        nonlocal count
        optimizer.zero_grad(set_to_none=True)
        loss = cnmgp.negative_selbo(params, Z, bx, by, bidx, bw, n_total, noise, jitter, kl_mode)
        loss.backward()
        grads = []
        for p, m in zip(params, grad_mask):
            p.grad = torch.where(torch.isfinite(p.grad), p.grad, 0.0) * m
            grads.append(p.grad)
        if grad_clip_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < grad_clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / g_norm * grad_clip_norm))
        if lr is not None:
            rate = float(lr(count))
            for group in optimizer.param_groups:
                group["lr"] = rate
        optimizer.step()
        count += 1
        return loss.detach()

    return step




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


def _snapshot(params, opt: torch.optim.Optimizer, gen: torch.Generator):
    """Copies, on the device, of the parameters and the optimizer's state,
    and the generator's state."""
    state = {p: {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in st.items()}
             for p, st in opt.state.items()}
    return [p.detach().clone() for p in params], state, gen.get_state()


def _roll_back(snap, params, opt: torch.optim.Optimizer, gen: torch.Generator, factor: float):
    """Restore a `_snapshot` (the parameters in place: the optimizer holds
    them) and scale every param group's rate by `factor`."""
    values, state, rng = snap
    with torch.no_grad():
        for p, v in zip(params, values):
            p.copy_(v)
    opt.state.clear()
    opt.state.update(state)
    gen.set_state(rng)
    for group in opt.param_groups:
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
    lr: Union[float, Callable[[int], float]] = 0.01,
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

    `lr` is a float or a callable step -> rate; `lr_decay` multiplies the
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
    an entry per epoch, the JAX one fewer.  `mesh` (multi-device) is not
    ported: it raises NotImplementedError naming ROADMAP.md, Queue 1 item
    10.
    """
    if mesh is not None:
        raise NotImplementedError("inference(mesh=...) is not ported yet: ROADMAP.md, Queue 1 item 10")
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
    grad_mask = freeze_mask(params, fix_hyperpars)
    step = make_train_step(opt, float(n_total), jitter, kl_mode, grad_clip_norm, schedule, start)

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
    # the chunked trace
    fast = (X_test_list is None or chunked_test_trace) and not do_stop_criterion and not verbose
    guard = divergence_rollback and fast
    loss_list: List[float] = []
    time_list: List[float] = []
    elbo_trace: List[float] = []
    rmse_test_list: List[float] = []
    rmse_trace: List[tuple] = []
    rollbacks = 0
    ts = time.time()

    def train_epoch(epoch: int) -> List[float]:
        if num_batches == 1:
            batch_idx = torch.arange(n_total, device=device)[None]
            batch_w = torch.ones((1, n_total), dtype=dtype, device=device)
        else:
            pad = num_batches * batch_size - n_total
            perm = torch.randperm(n_total, generator=gen, device=device)
            batch_idx = torch.cat([perm, perm.new_zeros(pad)]).reshape(num_batches, batch_size)
            batch_w = torch.cat([torch.ones(n_total, dtype=dtype, device=device),
                                 torch.zeros(pad, dtype=dtype, device=device)])
            batch_w = batch_w.reshape(num_batches, batch_size)
        losses, rmses = [], []
        for b in range(num_batches):
            sel = batch_idx[b]
            noise = cnmgp.draw_train_noise(gen, 1, M, batch_size, D, dtype=dtype)
            losses.append(step(params, grad_mask, Z, x[sel], y[sel], idx[sel], batch_w[b], noise))
            if X_test_list is not None and not fast:
                rmses.append(test_rmse())
        epoch_losses = torch.stack(losses).tolist()  # the host waits here, once an epoch
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
                snap = _snapshot(params, opt, gen)
                marks = [len(a) for a in (loss_list, time_list, rmse_trace, rmse_test_list)]
            epoch_losses = train_epoch(epoch)
            if not guard or rollbacks >= max_rollbacks or not _diverged(loss_list, marks[0]):
                break
            _roll_back(snap, params, opt, gen, rollback_lr_factor)
            for a, n in zip((loss_list, time_list, rmse_trace, rmse_test_list), marks):
                del a[n:]
            rollbacks += 1
            print(f"divergence rollback #{rollbacks}: retrying 1 epoch(s) from epoch {epoch} at "
                  f"lr={opt.param_groups[0]['lr']:.3g}")
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

    if verbose or show_ELBO:
        print(f"training takes {time.time() - ts:.2f}s")
    if save_model and PATH is not None:
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
