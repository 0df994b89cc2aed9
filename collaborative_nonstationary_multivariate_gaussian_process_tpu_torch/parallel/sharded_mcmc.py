"""MCMC diagnostics of the JAX package's `parallel/sharded_mcmc.py:297-329`:
effective sample size and split R-hat over (chains, samples, dim) draws.
The chain-sharded runners of that module wait for the port's multi-device
layer."""

from __future__ import annotations

import math

import torch

__all__ = ["effective_sample_size", "potential_scale_reduction"]


def _as_draws(chains_samples):
    if isinstance(chains_samples, torch.Tensor):
        return chains_samples
    return torch.as_tensor(chains_samples)


def effective_sample_size(chains_samples):
    """ESS by the autocorrelation method (Geyer's initial positive sequence,
    FFT autocovariances), over (C, S, dim) draws.  Returns (dim,)."""
    x = _as_draws(chains_samples)
    c, n, d = x.shape
    x = x - x.mean(dim=1, keepdim=True)
    nfft = 2 ** math.ceil(math.log2(2 * n))
    f = torch.fft.rfft(x, n=nfft, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=1)[:, :n, :] / n
    rho = acov.mean(dim=0) / torch.clamp(acov[:, 0, :].mean(dim=0), min=1e-30)
    n_pairs = (n - 1) // 2
    pair = rho[1:1 + 2 * n_pairs].reshape(n_pairs, 2, d).sum(dim=1)  # (P, dim)
    positive = torch.cumprod((pair > 0).to(rho.dtype), dim=0)
    tau = 1.0 + 2.0 * torch.sum(pair * positive, dim=0)
    return c * n / torch.clamp(tau, min=1.0)


def potential_scale_reduction(chains_samples):
    """Split R-hat over (C, S, dim) draws.  Returns (dim,)."""
    x = _as_draws(chains_samples)
    c, n, d = x.shape
    half = n // 2
    x = torch.cat([x[:, :half], x[:, half:2 * half]], dim=0)  # (2C, half, dim)
    nn = x.shape[1]
    chain_means = x.mean(dim=1)
    W = torch.var(x, dim=1, correction=1).mean(dim=0)
    B = nn * torch.var(chain_means, dim=0, correction=1)
    var_plus = (nn - 1) / nn * W + B / nn
    return torch.sqrt(var_plus / W)
