"""CNMGP in PyTorch and CUDA: DSVI training and posterior prediction of the
Collaborative Nonstationary Multivariate Gaussian Process on an NVIDIA H100.

Mirrors the layout of the JAX package
`collaborative_nonstationary_multivariate_gaussian_process_tpu`, which stays
the numerical reference.  This package imports neither JAX nor that package.
Plain tensor code is PyTorch; the five Pallas kernels of the path (Gibbs
gram, fused Cholesky + triangular inverse, variance quadratic form and its
two backward kernels) are hand-written CUDA kernels under `csrc/`, built
with `nvcc` at first use.
"""

from . import config, infer, models, ops, utils  # noqa: F401

__version__ = "0.1.0"
