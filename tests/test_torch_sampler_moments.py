"""The Gaussian-moment tests of `tests/test_samplers.py:42-80` and
:137-165, re-run on the port's samplers (statistically: other draws than
the JAX package's), with the chains on the leading axis where the JAX tests
run one chain or vmap several.  Tolerances as there."""

import numpy as np
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.hmc import run_hmc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.nuts import run_nuts
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.sharded_mcmc import (
    effective_sample_size,
    potential_scale_reduction,
)

torch.set_num_threads(1)

DIM = 4
RNG = np.random.default_rng(4)  # the target of tests/test_samplers.py
A = RNG.standard_normal((DIM, DIM))
COV = A @ A.T + DIM * np.eye(DIM)
MEAN = np.array([1.0, -2.0, 0.5, 3.0])
PREC = torch.as_tensor(np.linalg.inv(COV))


def gauss_lp(q):
    d = q - torch.as_tensor(MEAN)
    return -0.5 * torch.sum(d * (d @ PREC), dim=-1)


def _check_moments(samples, mean_tol, cov_tol):
    np.testing.assert_allclose(samples.mean(axis=0), MEAN, atol=mean_tol)
    np.testing.assert_allclose(np.cov(samples.T), COV, atol=cov_tol * np.max(np.abs(COV)))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_hmc_gaussian_moments():
    """Eight chains pooled: with 16 leapfrogs of the adapted step a chain
    can land near a half period of the widest direction, where it hardly
    moves along it (the JAX sampler does the same, chain by chain); pooling
    keeps the moments of the test within its tolerance."""
    q0 = torch.zeros(8, DIM, dtype=torch.float64)
    samples, info = run_hmc(gauss_lp, q0, _gen(0), num_warmup=300, num_samples=300, num_steps=16)
    assert 0.4 < float(info["accept_prob"].mean()) <= 1.0
    _check_moments(samples.reshape(-1, DIM).numpy(), mean_tol=0.4, cov_tol=0.25)


def test_nuts_gaussian_moments_and_rhat():
    q0 = torch.as_tensor(RNG.standard_normal((4, DIM)))
    samples, info = run_nuts(gauss_lp, q0, _gen(1), num_warmup=300, num_samples=500, max_depth=8)
    assert float(info["diverging"].double().mean()) < 0.02
    assert 0.5 < float(info["accept_prob"].mean()) <= 1.0
    _check_moments(samples.reshape(-1, DIM).numpy(), mean_tol=0.3, cov_tol=0.2)
    rhat = potential_scale_reduction(samples)
    assert bool((rhat < 1.1).all()), rhat
    assert bool((effective_sample_size(samples) > 200).all())
    assert info["host_reads"] > 0 and info["leapfrogs"] >= int(info["num_steps"].max(0).values.sum())


def test_nuts_dense_mass_on_correlated_gaussian():
    """The dense metric recovers the moments of a rho = 0.99 Gaussian and
    needs far fewer leapfrogs per draw than the diagonal one."""
    prec = torch.as_tensor(np.linalg.inv(np.array([[1.0, 0.99], [0.99, 1.0]])))

    def lp(q):
        return -0.5 * torch.sum(q * (q @ prec), dim=-1)

    q0 = torch.zeros(2, 2, dtype=torch.float64)
    s_dense, i_dense = run_nuts(lp, q0, _gen(2), num_warmup=150, num_samples=400, max_depth=10,
                                dense_mass=True)
    s_diag, i_diag = run_nuts(lp, q0, _gen(3), num_warmup=100, num_samples=40, max_depth=10)
    sd = s_dense.reshape(-1, 2).numpy()
    np.testing.assert_allclose(sd.mean(axis=0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(sd.T), [[1.0, 0.99], [0.99, 1.0]], atol=0.15)
    assert float(i_dense["diverging"].double().mean()) < 0.02
    steps_dense = float(i_dense["num_steps"].double().mean())
    steps_diag = float(i_diag["num_steps"].double().mean())
    assert steps_dense < 0.5 * steps_diag, (steps_dense, steps_diag)
