"""CNMGP in PyTorch and CUDA: DSVI training, posterior prediction and the
fully-Bayesian samplers (NUTS, HMC, ChEES-HMC, SMC model comparison) of the
Collaborative Nonstationary Multivariate Gaussian Process on an NVIDIA H100.

Mirrors the layout of the JAX package
`collaborative_nonstationary_multivariate_gaussian_process_tpu`, which stays
the numerical reference; `drivers/` holds the ports of its scripts.  This
package imports neither JAX nor that package.  Plain tensor code is
PyTorch; the eight Pallas kernels (Gibbs and RBF grams, Cholesky, fused
Cholesky + triangular inverse, Kronecker matvec, variance quadratic form
and its two backward kernels) are hand-written CUDA kernels under `csrc/`,
with three of the port's own (the quadform's fused backward, the whitened
coefficient factors and their backward), built with `nvcc` at first use.
"""

from . import config, infer, models, ops, utils  # noqa: F401

__version__ = "0.1.0"
