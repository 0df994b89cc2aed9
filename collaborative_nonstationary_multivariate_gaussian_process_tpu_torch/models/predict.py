"""Posterior-predictive entry points: `sample_Y`, `sample_FY`, `predict_Y`.

The JAX package's `models/predict.py:59-122`.  Its vmap over S keys becomes
a leading draw dimension, run `draws_per_chunk` draws at a time: every
draw holds per-group intermediates of O(D^2 M^2) floats (the (S, G, M, M)
whitened factors are ~120 MB per draw at D=78, M=100), so the chunk bounds
device memory.  The entry points run on the first CUDA card unless
`device` names another (the tests pass "cpu").

Spans (`utils.profiling.span`, recorded while a profiler records): each
call is the root `predict.request` (attributes `kind`, `points`, `draws`);
in it `predict.inputs` (the NumPy inputs concatenated and copied to the
device), each chunk of draws `predict.chunk`, and the draws' final
concatenation `predict.concat`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DSVI_JITTER, resolve_device
from ..utils import profiling
from . import cnmgp
from .cnmgp import CNMGPNoise, CNMGPParams

__all__ = ["DRAWS_PER_CHUNK", "sample_Y", "sample_FY", "predict_Y"]

DRAWS_PER_CHUNK = 8


def _flat_inputs(X_list: Sequence, index: Optional[Sequence[int]], dtype, device):
    xs, idxs = [], []
    for d, x in enumerate(X_list):
        x = np.asarray(x).reshape(-1)
        xs.append(x)
        idxs.append(np.full(x.shape[0], index[d] if index is not None else d, dtype=np.int64))
    x = torch.as_tensor(np.concatenate(xs), dtype=dtype, device=device)
    return x, torch.as_tensor(np.concatenate(idxs), device=device)


def _setup(params: CNMGPParams, Z, device):
    device = resolve_device(device)
    params = cnmgp.params_to(params, device)
    Z = torch.as_tensor(Z if torch.is_tensor(Z) else np.asarray(Z), dtype=params.mu_v.dtype,
                        device=device).reshape(-1)
    return params, Z, device


def _chunked_draws(
    draw_fn: Callable[[CNMGPNoise], Tuple[torch.Tensor, ...]],
    noise: Optional[CNMGPNoise],
    make_noise: Callable[[torch.Generator, int], CNMGPNoise],
    n_sample: int,
    seed: int,
    device: torch.device,
    draws_per_chunk: int,
):
    """Run `draw_fn` on `draws_per_chunk` draws at a time and concatenate
    along the draw dimension.  Noise is sliced from `noise` when given, else
    drawn chunk by chunk from a generator seeded with `seed` on `device`."""
    if noise is not None and noise.z_v1.shape[0] != n_sample:
        raise ValueError(f"noise holds {noise.z_v1.shape[0]} draws, n_sample={n_sample}")
    generator = None
    if noise is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    outs = []
    for start in range(0, n_sample, draws_per_chunk):
        stop = min(start + draws_per_chunk, n_sample)
        with profiling.span("predict.chunk", draws=stop - start):
            if noise is None:
                chunk = make_noise(generator, stop - start)
            else:
                chunk = CNMGPNoise(*(None if z is None else z[start:stop].to(device)
                                     for z in noise))
            outs.append(draw_fn(chunk))
    with profiling.span("predict.concat"):
        return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def sample_Y(
    params: CNMGPParams,
    Z,
    X_list: Sequence,
    index: Optional[Sequence[int]] = None,
    n_sample: int = 1000,
    seed: int = 0,
    jitter: float = DSVI_JITTER,
    kl_mode: str = "true",
    noise: Optional[CNMGPNoise] = None,
    draws_per_chunk: int = DRAWS_PER_CHUNK,
    device=None,
):
    """S = n_sample posterior predictive draws at heterotopic inputs.

    Returns (Ys (S, B), Ls (S, B, D), Gs (S, D, B), tilde_ells (S, B)) as
    tensors on the device, the contents of reference `NMGP.sample_Y`
    (nmgp_dsvi.py:406-491).  `noise` (leading dim S) replaces the draws from
    `seed`; the same `seed` gives other draws than the JAX `sample_Y`.
    """
    with profiling.span("predict.request", kind="sample_Y", draws=n_sample) as request:
        with profiling.span("predict.inputs"):
            params, Z, device = _setup(params, Z, device)
            x, idx = _flat_inputs(X_list, index, Z.dtype, device)
        M, B, D = Z.shape[0], x.shape[0], params.num_outputs
        request.set(points=B)

        def make_noise(gen, s):
            return cnmgp.draw_noise(gen, s, M, B, D, dtype=Z.dtype)

        def draw(chunk):
            return cnmgp.sample_y_once(params, Z, x, idx, chunk, jitter, kl_mode)

        return _chunked_draws(draw, noise, make_noise, n_sample, seed, device, draws_per_chunk)


def sample_FY(
    params: CNMGPParams,
    Z,
    x,
    n_sample: int = 1000,
    seed: int = 0,
    jitter: float = DSVI_JITTER,
    kl_mode: str = "true",
    noise: Optional[CNMGPNoise] = None,
    draws_per_chunk: int = DRAWS_PER_CHUNK,
    device=None,
):
    """S draws of (tilde_ell, all-output Y, correlation process) at common
    inputs x, the contents of reference `NMGP.sample_FY` (nmgp_dsvi.py:
    493-580): returns (tilde_ells (S, B), Ys (S, B, D), corrs (S, B, D, D)).
    `noise` and `seed` as in `sample_Y`."""
    with profiling.span("predict.request", kind="sample_FY", draws=n_sample) as request:
        with profiling.span("predict.inputs"):
            params, Z, device = _setup(params, Z, device)
            x = torch.as_tensor(np.asarray(x).reshape(-1), dtype=Z.dtype, device=device)
        M, B, D = Z.shape[0], x.shape[0], params.num_outputs
        request.set(points=B)

        def make_noise(gen, s):
            return cnmgp.draw_noise(gen, s, M, B, D, all_outputs=True, dtype=Z.dtype)

        def draw(chunk):
            return cnmgp.sample_fy_once(params, Z, x, chunk, jitter, kl_mode)

        return _chunked_draws(draw, noise, make_noise, n_sample, seed, device, draws_per_chunk)


def predict_Y(
    params: CNMGPParams,
    Z,
    X_list: Sequence,
    index: Optional[Sequence[int]] = None,
    jitter: float = DSVI_JITTER,
    device=None,
):
    """Plug-in posterior-mean prediction (reference predict_Y,
    nmgp_dsvi.py:666-722,927-930).  Returns (B,) on the device."""
    with profiling.span("predict.request", kind="predict_Y", draws=0) as request:
        with profiling.span("predict.inputs"):
            params, Z, device = _setup(params, Z, device)
            x, idx = _flat_inputs(X_list, index, Z.dtype, device)
        request.set(points=x.shape[0])
        return cnmgp.predict_y_mean(params, Z, x, idx, jitter)
