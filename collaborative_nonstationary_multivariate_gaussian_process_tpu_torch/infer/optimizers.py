"""Adam with both moments stored in bfloat16 (the JAX package's
`infer/optimizers.py:32-87`, `adam_bf16_moments`).

The CNMGP parameter set is dominated by the (G, M, M) `sqrt_U` table
(31.9M parameters at D=78, M=100), so Adam's two f32 moments are ~255 MB
that every step reads and writes.  Storing them in bf16 halves that
traffic; every arithmetic operation (the moment updates, the bias
correction, the update) stays in float32, and so do the parameters.  Only
the storage dtype changes.  The plain "adam" of `inference()` is
`torch.optim.Adam`, which applies the same formula as `optax.adam`.
"""

from __future__ import annotations

import torch

__all__ = ["AdamBf16Moments"]


class AdamBf16Moments(torch.optim.Optimizer):
    """`optax.adam` with both moment EMAs stored in bfloat16:

      mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2     (in f32)
      p += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

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
                    state["count"] = 0
                    state["mu"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    state["nu"] = torch.zeros_like(p, dtype=torch.bfloat16)
                state["count"] += 1
                # the bias corrections in f32, as optax computes them
                c = torch.tensor(float(state["count"]), dtype=torch.float32)
                bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** c)
                bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** c)
                g = p.grad.to(torch.float32)
                mu = b1 * state["mu"].to(torch.float32) + (1.0 - b1) * g
                nu = b2 * state["nu"].to(torch.float32) + (1.0 - b2) * (g * g)
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])
                p.add_((-group["lr"] * upd).to(p.dtype))
                state["mu"] = mu.to(torch.bfloat16)
                state["nu"] = nu.to(torch.bfloat16)
        return loss
