"""Adam with both moments stored in bfloat16 (the JAX package's
`infer/optimizers.py:32-87`, `adam_bf16_moments`).

The CNMGP parameter set is dominated by the (G, M, M) `sqrt_U` table
(31.9M parameters at D=78, M=100), so Adam's two f32 moments are ~255 MB
that every step reads and writes.  Storing them in bf16 halves that
traffic; every arithmetic operation (the moment updates, the bias
correction, the update) stays in float32, and so do the parameters.  Only
the storage dtype changes.  The plain "adam" of `inference()` is
`torch.optim.Adam`, which applies the same formula as `optax.adam`.

Both keep every value a CUDA graph replays on the device: the step count
and, for CUDA parameters, the learning rate are tensors there, updated in
place (`torch.optim.Adam(..., capturable=True)` and `AdamBf16Moments`), so
a captured step reads the count, the rate and the moments anew at every
replay.  `set_rate` writes a rate into such a tensor, or into the float
rate of CPU parameters.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["AdamBf16Moments", "set_rate", "optax_state", "load_optax_state"]

# The hyperparameters `optax.inject_hyperparams` keeps in the state of
# `optax.adam` and of the JAX `adam_bf16_moments`, in its (sorted) order.
_INJECTED = {"adam": ("b1", "b2", "eps", "eps_root", "learning_rate"),
             "adam_bf16": ("b1", "b2", "eps", "learning_rate")}


class AdamBf16Moments(torch.optim.Optimizer):
    """`optax.adam` with both moment EMAs stored in bfloat16:

      mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2     (in f32)
      p += -lr * mu / ((1 - b1^t) (sqrt(nu / (1 - b2^t)) + eps))

    with g, mu and nu upcast to float32 and mu, nu stored back as bf16.
    """

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["count"] = torch.zeros((), dtype=torch.int32, device=p.device)
                    state["mu"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    state["nu"] = torch.zeros_like(p, dtype=torch.bfloat16)
                state["count"].add_(1)
                # the bias corrections in f32 from the count on the device,
                # as optax computes them
                c = state["count"].to(torch.float32)
                bc1 = 1.0 - torch.pow(_f32(b1), c)
                bc2 = 1.0 - torch.pow(_f32(b2), c)
                g = p.grad.to(torch.float32)
                mu = b1 * state["mu"].to(torch.float32) + (1.0 - b1) * g
                nu = b2 * state["nu"].to(torch.float32) + (1.0 - b2) * (g * g)
                # (mu / bc1) / (sqrt(nu / bc2) + eps) as XLA evaluates it: its
                # simplifier turns (a / b) / c into a / (b c)
                upd = mu / (bc1 * (_sqrt32(nu / bc2) + group["eps"]))
                p.add_((-group["lr"] * upd).to(p.dtype))
                state["mu"].copy_(mu)
                state["nu"].copy_(nu)
        return loss


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as optax's: on the CPU
    through float64, since torch's float32 kernel there rounds ~0.7% of
    entries the other way; the card's `sqrtf` is IEEE."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).to(torch.float32)


def _f32(v: float) -> float:
    """v rounded to float32 (the value optax's f32 arithmetic uses)."""
    return float(torch.tensor(v, dtype=torch.float32))


def set_rate(opt: torch.optim.Optimizer, rate) -> None:
    """Make `rate` (a float or a 0-d tensor) the learning rate of every
    param group: written in place into a group's rate tensor (no host
    read, so a CUDA graph replays it), or as a float."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].copy_(rate)
        else:
            group["lr"] = float(rate)


def _moments(opt: torch.optim.Optimizer, p: torch.Tensor):
    """(count, mu, nu) of parameter p: optax's names for `torch.optim.Adam`'s
    (step, exp_avg, exp_avg_sq) and `AdamBf16Moments`' own; zeros before
    the first step, as optax's init has them."""
    st = opt.state.get(p) or {}
    if isinstance(opt, AdamBf16Moments):
        zero = torch.zeros_like(p, dtype=torch.bfloat16)
        return int(st.get("count", 0)), st.get("mu", zero), st.get("nu", zero)
    if not st:
        return 0, torch.zeros_like(p), torch.zeros_like(p)
    return int(st["step"]), st["exp_avg"], st["exp_avg_sq"]


def _kind(opt) -> str:
    return "adam_bf16" if isinstance(opt, AdamBf16Moments) else "adam"


def optax_state(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor], inject: bool = False,
                schedule: bool = False) -> List[torch.Tensor]:
    """The state of `opt` over `params` (one param group, in `CNMGPParams`
    order) as the leaves, in optax's order, of the state that the JAX
    `inference()` builds for the same options:

      [inject count, injected hyperparameters (sorted)]   divergence_rollback
      count, mu (one per parameter), nu (one per parameter)
      [schedule count]                                     lr_decay or a callable lr

    count is int32, the hyperparameters in the parameters' float dtype, mu
    and nu in the optimizer's storage dtype.  A global-norm clip adds no
    leaf (its optax state is empty)."""
    params = list(params)
    moments = [_moments(opt, p) for p in params]
    count = torch.tensor(moments[0][0] if moments else 0, dtype=torch.int32)
    leaves = []
    if inject:
        group = opt.param_groups[0]
        values = dict(b1=group["betas"][0], b2=group["betas"][1], eps=group["eps"], eps_root=0.0,
                      learning_rate=float(group["lr"]))
        leaves += [count] + [torch.tensor(values[k], dtype=params[0].dtype)
                             for k in _INJECTED[_kind(opt)]]
    leaves += [count] + [m[1] for m in moments] + [m[2] for m in moments]
    return leaves + [count] if schedule else leaves


def load_optax_state(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                     leaves: Sequence[torch.Tensor], inject: bool = False,
                     schedule: bool = False) -> int:
    """Set the state of `opt` from optax leaves laid out as `optax_state`
    lays them (a checkpoint of either package, restored to this state's
    dtypes); an injected learning rate becomes the rate of every param
    group.  Returns the step count (the count of a schedule, where there
    is one)."""
    params, leaves = list(params), list(leaves)
    if inject:
        names = _INJECTED[_kind(opt)]
        hyper = dict(zip(names, leaves[1:1 + len(names)]))
        set_rate(opt, float(hyper["learning_rate"]))
        leaves = leaves[1 + len(names):]
    n = len(params)
    count = int(leaves[0])
    mu, nu = leaves[1:1 + n], leaves[1 + n:1 + 2 * n]
    for p, m, v in zip(params, mu, nu):
        if isinstance(opt, AdamBf16Moments):
            opt.state[p] = {"count": torch.tensor(count, dtype=torch.int32, device=p.device),
                            "mu": m.to(p.device, torch.bfloat16),
                            "nu": v.to(p.device, torch.bfloat16)}
        else:
            # a capturable Adam keeps its count on the parameters' device
            on = p.device if opt.defaults.get("capturable") else "cpu"
            opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32, device=on),
                            "exp_avg": m.to(p.device, p.dtype),
                            "exp_avg_sq": v.to(p.device, p.dtype)}
    return int(leaves[-1]) if schedule else count
