"""The Kronecker matvec on the operand layouts the fully-Bayesian path
passes it, on the CPU: a transposed K (the eigenvectors' transposes of
`mvn_logpdf_kron`, and K^T in the backward) and one K shared by the
chains, against the JAX package's `ops.kron.kron_mv`, values and the
y-gradient, in float64 (values rtol 1e-10, gradients 1e-8).

The CUDA wrapper reads K in place in either layout; how it lays the
operands out for the kernel (`_kron_mv_operands`: strides, chain strides,
no copy of K) is held here by rebuilding the kernel's view of each operand
from its strides, which the CPU can run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import kron as jkron
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import kron as tkron
from torch_port_helpers import assert_close

torch.set_num_threads(1)
C, M, N = 3, 2, 11


def _operands(layout, seed):
    """B (C, M, M), y (M N,) and K as `layout` gives it: a (C, N, N) tensor
    or its transposed view, or one (N, N) K (or its transposed view) for
    every chain; and the dense (C, N, N) K it stands for."""
    r = np.random.default_rng(seed)
    B = r.standard_normal((C, M, M))
    K = torch.as_tensor(r.standard_normal((C, N, N)))
    y = r.standard_normal(M * N)
    if "shared" in layout:
        K = K[0]
    if "transposed" in layout:
        K = K.mT
    dense = K.expand(C, N, N).numpy()
    return B, K, y, dense


@pytest.mark.parametrize("layout", ["transposed", "shared", "shared transposed"])
def test_kron_mv_layouts_match_jax_values_and_y_gradient(layout):
    B, K, y, dense = _operands(layout, seed=len(layout))
    Wc = np.random.default_rng(1).standard_normal((C, M * N))
    tB, ty = torch.tensor(B, requires_grad=True), torch.tensor(y, requires_grad=True)
    out = tkron.kron_mv(tB, K, ty)
    (torch.as_tensor(Wc) * out).sum().backward()
    gy = np.zeros_like(y)
    for c in range(C):
        want = jkron.kron_mv(jnp.asarray(B[c]), jnp.asarray(dense[c]), jnp.asarray(y))
        assert_close(out[c], want, rtol=1e-10)
        g = jax.grad(lambda v: jnp.sum(Wc[c] * jkron.kron_mv(B[c], dense[c], v)))(jnp.asarray(y))
        gy += np.asarray(g)
    assert_close(ty.grad, gy, rtol=1e-8)


@pytest.mark.parametrize("layout", ["rows", "transposed", "shared", "shared transposed"])
@pytest.mark.parametrize("chains", [None, C])
def test_cuda_operand_layout_reads_k_in_place(layout, chains):
    """The kernel's view of each operand, rebuilt from the strides the
    wrapper passes (K's element (c, r, n) at c sc + r sr + n sn with sn == 1
    or sr == 1; B and y at their chain strides), gives `kron_mv_plain`'s
    result, and K is never copied."""
    B, K, y, _ = _operands(layout, seed=7)
    if chains is None:
        B, K = B[0], K if K.ndim == 2 else K[0]
    Bt, yt = torch.as_tensor(B), torch.as_tensor(y)
    Kc, Bc, yc, args, batched = ck._kron_mv_operands(Bt, K, yt)
    c, n1, n2, m1, m2, sc, sr, sn, b_sc, y_sc = args
    assert Kc.data_ptr() == K.data_ptr() and 1 in (sr, sn)
    assert (sc == 0) == (c == 1 or K.ndim == 2) and batched == (chains is not None)
    Kv = torch.as_strided(Kc, (c, n1, n2), (sc, sr, sn))
    Bv = torch.as_strided(Bc, (c, m1, m2), (b_sc, m2, 1))
    yv = torch.as_strided(yc, (c, m2 * n2), (y_sc, 1))
    got = ck.kron_mv_plain(Bv, Kv, yv)
    assert_close(got if batched else got[0], ck.kron_mv_plain(Bt, K, yt), rtol=1e-12)


def test_cuda_operand_layout_copies_only_a_k_in_neither_layout():
    K = torch.randn(4, 6, dtype=torch.float64)[:, ::2][:3]  # (3, 3), strides (6, 2)
    Kc, _, _, args, _ = ck._kron_mv_operands(torch.eye(2, dtype=torch.float64), K,
                                             torch.randn(6, dtype=torch.float64))
    assert Kc.data_ptr() != K.data_ptr() and args[5:8] == (0, 3, 1)
    assert torch.equal(Kc[0], K)
