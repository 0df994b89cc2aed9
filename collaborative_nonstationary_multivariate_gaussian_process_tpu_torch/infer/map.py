"""MAP estimation over the fully-Bayesian log-posteriors (the JAX package's
`infer/map.py`).

  - `run_map`: Adam on the negative log posterior (`torch.optim.Adam`, the
    formula of `optax.adam`), with the non-finite-gradient -> 0 guard, for
    every chain of a (C, dim) start at once (a chain's loss depends on its
    own parameters only, so the summed loss gives each chain its gradient);
  - `run_map_scipy`: scipy's L-BFGS-B with torch gradients (the reference's
    adapter, nmgp_dsvi.py:62-83, including its non-finite-gradient guard).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device
from .hmc import initial_positions, value_and_grad

__all__ = ["run_map", "run_map_scipy"]


def run_map(
    neg_log_prob: Callable,
    init_position,
    num_steps: int = 2000,
    learning_rate: float = 1e-2,
    optimizer: Optional[Callable] = None,
    device=None,
):
    """Adam MAP optimization.  `neg_log_prob` maps (C, dim) to (C,) (or
    (dim,) to a scalar); `optimizer`, if given, builds a `torch.optim`
    optimizer from the parameter list.  Returns (position, loss trace
    (num_steps,) + the chain shape); the losses stay on the device."""
    q = initial_positions(init_position, device).detach().clone().requires_grad_(True)
    opt = (torch.optim.Adam([q], lr=learning_rate, eps=1e-8) if optimizer is None
           else optimizer([q]))
    losses = []
    for _ in range(num_steps):
        opt.zero_grad(set_to_none=True)
        loss = neg_log_prob(q)
        (g,) = torch.autograd.grad(loss.sum(), q)
        q.grad = torch.where(torch.isfinite(g), g, 0.0)
        opt.step()
        losses.append(loss.detach())
    return q.detach(), torch.stack(losses)


def run_map_scipy(
    neg_log_prob: Callable,
    init_position,
    method: str = "L-BFGS-B",
    maxiter: int = 1000,
    verbose: bool = False,
    device=None,
    dtype=None,
):
    """scipy.optimize MAP of one chain (`init_position` (dim,)) with torch
    gradients, evaluated on `device` (the card unless the CPU is asked for)
    in `dtype` (float32 by default).  Returns (x, scipy result)."""
    device = resolve_device(device)
    dtype = DEFAULT_DTYPE if dtype is None else dtype

    def fun(q):
        lp, g = value_and_grad(neg_log_prob, torch.as_tensor(q, dtype=dtype, device=device))
        loss = float(lp)
        g = g.double().cpu().numpy()
        finite = np.isfinite(g)
        if not finite.all():
            if verbose:
                print("Warning: inf or nan in gradient: replacing with zeros.")
            g = np.where(finite, g, 0.0)
        if verbose:
            print(f"loss: {loss}.")
        return loss, g

    from scipy.optimize import minimize

    res = minimize(fun, np.asarray(init_position, dtype=np.float64), jac=True, method=method,
                   options={"maxiter": maxiter})
    return res.x, res
