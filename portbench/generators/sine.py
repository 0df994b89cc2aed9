"""The sine surrogate of a recorded series: output d holds `lengths[d]`
evenly spaced inputs on [0, x_max), y = sin(x / period).  At 78 outputs of
800 steps on [0, 800) it is the JAX package's ECoG bench surrogate
(`scripts/bench_ecog.py:46-52`); outputs of unequal lengths state a
heterotopic study such as PM2.5's."""

from __future__ import annotations

import torch


def make(spec: dict, dev, dtype=torch.float32):
    """Flat (x, y, idx) of every output's observations, output by output."""
    xs, idxs = [], []
    for d, n in enumerate(spec["lengths"]):
        xs.append(torch.arange(n, dtype=dtype, device=dev) * (spec["x_max"] / n))
        idxs.append(torch.full((n,), d, dtype=torch.int64, device=dev))
    x = torch.cat(xs)
    return x, torch.sin(x / spec["period"]), torch.cat(idxs)
