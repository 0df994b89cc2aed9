"""The port's CUDA kernels against their plain versions, on a CUDA card.

These tests need the card and skip without one.  They import neither JAX
nor the JAX package, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

from contextlib import ExitStack
from unittest import mock

import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
    logdensities as ld,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import kernels, kron, linalg
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import sim_mnts

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

# the kernels a DSVI training step launches (the quadform's backward as the
# fused kernel: both gradients, M within its limit; the whitened factors and
# their backward)
TRAIN_KERNELS = ("gibbs", "chol_inv", "quadform_diag", "quadform_diag_bwd", "whitened_factors",
                 "whitened_factors_bwd")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _close(a, b, tol):
    """max |a - b| <= tol * max |b| (sums run in another order)."""
    return float((a.double() - b.double()).abs().max()) <= tol * float(b.double().abs().max())


@pytest.mark.parametrize("S, n, m, d", [(1, 1, 1, 1), (3, 37, 70, 1), (2, 129, 33, 2), (1, 64, 64, 4)])
def test_gibbs_kernel_matches_plain(dev, S, n, m, d):
    g = _gen(dev, n)
    x1 = torch.rand(n, d, device=dev, generator=g)
    x2 = torch.rand(m, d, device=dev, generator=g)
    l1 = torch.exp(0.3 * torch.randn(S, n, device=dev, generator=g))
    l2 = torch.exp(0.3 * torch.randn(S, m, device=dev, generator=g))
    before = ck.LAUNCHES["gibbs"]
    K = ck.gibbs_cuda(x1, x2, l1, l2, 1.3)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["gibbs"] == before + 1
    assert torch.allclose(K, ck.gibbs_plain(x1, x2, l1, l2, 1.3), rtol=1e-5, atol=1e-30)
    K1 = ck.gibbs_cuda(x1[:, 0], x2[:, 0], l1[0], l2[0])  # no draw dim, 1-D inputs
    assert K1.shape == (n, m)
    assert torch.allclose(K1, ck.gibbs_plain(x1[:, 0], x2[:, 0], l1[0], l2[0]), rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize(
    "S, n, m, d",
    [(1, 5, 7, 1), (2, 33, 101, 1), (3, 17, 6, 2), (1, 40, 99, 3), (2, 64, 3, 4), (1, 512, 100, 1),
     (4, 100, 100, 1), (8, 512, 100, 1), (1, 2, 1, 2), (4, 1024, 1024, 1)],
)
def test_gibbs_kernel_rows_and_tails(dev, S, n, m, d):
    """The flat-output kernel: M % 4 != 0 (four outputs that cross a row,
    and a scalar tail of S N M mod 4), M below 4, d = 1..4, S = 1, the
    path's (4, 100, 100), (8, 512, 100) and SNMGP's (4, 1024, 1024); rtol
    1e-5 against the plain version, as chip_smoke.py holds it."""
    g = _gen(dev, n * m + d)
    x1 = 3.0 * torch.rand(n, d, device=dev, generator=g)
    x2 = 3.0 * torch.rand(m, d, device=dev, generator=g)
    l1 = torch.exp(0.3 * torch.randn(S, n, device=dev, generator=g))
    l2 = torch.exp(0.3 * torch.randn(S, m, device=dev, generator=g))
    before = ck.LAUNCHES["gibbs"]
    K = ck.gibbs_cuda(x1, x2, l1, l2, 0.7)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["gibbs"] == before + 1 and K.shape == (S, n, m)
    ref = ck.gibbs_plain(x1, x2, l1, l2, 0.7)
    assert torch.isfinite(K).all()
    assert float(((K - ref).abs() - 1e-5 * ref.abs() - 1e-30).max()) <= 0.0
    # lengthscales that start one float into their storage (no 16-byte alignment)
    l1s = torch.cat([l1.new_ones(1), l1[0]])[1:]
    l2s = torch.cat([l2.new_ones(1), l2[0]])[1:]
    K1 = ck.gibbs_cuda(x1, x2, l1s, l2s, 0.7)
    assert torch.equal(K1, K[0])


def _spd(dev, batch, m, seed):
    g = _gen(dev, seed)
    A = torch.randn(batch, m, m, device=dev, generator=g)
    return A @ A.transpose(-1, -2) / m + 0.5 * torch.eye(m, device=dev)


@pytest.mark.parametrize("batch, m", [(1, 1), (5, 13), (3, 100), (2, "max")])
def test_chol_inv_kernel_matches_plain(dev, batch, m):
    if m == "max":
        m = ck.max_m("chol_inv")
    K = _spd(dev, batch, m, m)
    L, Linv = ck.chol_inv_cuda(K)
    L_ref, Linv_ref = ck.chol_inv_plain(K)
    torch.cuda.synchronize()
    assert _close(L, L_ref, 1e-5) and _close(Linv, Linv_ref, 1e-4)
    assert torch.equal(L, L.tril()) and torch.equal(Linv, Linv.tril())


def test_chol_inv_kernel_nan_semantics(dev):
    K = _spd(dev, 3, 9, 1)
    K[1, 4, 4] = -1.0
    L, Linv = ck.chol_inv_cuda(K)
    L_ref, Linv_ref = ck.chol_inv_plain(K)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(L), torch.isnan(L_ref))
    assert torch.equal(torch.isnan(Linv), torch.isnan(Linv_ref))
    assert torch.isnan(L[1]).any() and torch.isfinite(L[[0, 2]]).all()


@pytest.mark.parametrize(
    "S, M, N, G",
    [(1, 1, 1, 1), (2, 13, 70, 5), (1, 100, 300, 3), (3, 24, 129, 2), (1, "max", 65, 2)],
)
def test_quadform_kernel_matches_plain(dev, S, M, N, G):
    if M == "max":
        M = ck.max_m("quadform_diag")
    g = _gen(dev, M * N)
    A = torch.randn(S, M, N, device=dev, generator=g)
    W = torch.randn(S, G, M, M, device=dev, generator=g)
    Wl = W.tril()  # the kernel reads only the lower triangle of W
    V = ck.quadform_diag_cuda(A, W)
    torch.cuda.synchronize()
    assert _close(V, ck.quadform_diag_plain(A, Wl), 1e-4)
    V0 = ck.quadform_diag_cuda(A[0], W[0])
    assert V0.shape == (G, N) and _close(V0, ck.quadform_diag_plain(A[0], Wl[0]), 1e-4)


def _path_qf_inputs(dev, M, N, G, seed):
    """A = Lp^-1 K_zx and W_g = Lp^-1 tril(S_g) of the RBF prior of
    lengthscale 40 on Z = linspace(0, 800, M) (+ 1e-4 jitter), inputs on
    the ECoG time axis: the path's kind of inputs, where C = A^T W cancels
    (W's entries ~100x C's); float32 on the card."""
    r = np.random.default_rng(seed)
    Z = np.linspace(0.0, 800.0, M)
    x = np.sort(r.uniform(0.0, 800.0, N))
    k = lambda a, b: np.exp(-0.5 * ((a[:, None] - b[None, :]) / 40.0) ** 2)  # noqa: E731
    Lp_inv = np.linalg.solve(np.linalg.cholesky(k(Z, Z) + 1e-4 * np.eye(M)), np.eye(M))
    S = np.tril(0.1 * r.standard_normal((G, M, M))) + np.eye(M)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return f32(Lp_inv @ k(Z, x)), f32(np.tril(Lp_inv @ S))


@pytest.mark.parametrize(
    "S, G, M, N",
    [(1, 15, 100, 2000), (1, 6, 100, 2000), (1, 78, 100, 512), (1, 3003, 100, 512),
     (2, 40, 200, 512), (1, 78, 200, 512), (1, 4, 512, 300), (1, 2, 10, 200), (1, 1, 10, 200),
     (3, 7, 45, 129), (1, 9, 16, 1), (2, 5, 131, 75), (8, 78, 100, 64)],
)
def test_quadform_forward_against_float64(dev, S, G, M, N):
    """6a at the path's shapes (PM2.5-sub's G = 15 and 6 at N = 2000, ECoG's
    78 and 3003 groups, sample_FY's N = 64, the illustration fit's M = 10)
    and at M = 200 and 512, an N that is no multiple of the tile and an M
    that is no multiple of 4 or 16, on random lower-triangular W: at most 3x
    as far from float64 as the plain float32 version, + 1e-6 of max (the
    gate of chip_smoke.py); 1e-4 of max against the plain version; two runs
    bitwise equal."""
    g = _gen(dev, M * N + G + S)
    A = torch.randn(S, M, N, device=dev, generator=g)
    W = 0.1 * torch.randn(S, G, M, M, device=dev, generator=g).tril()
    before = ck.LAUNCHES["quadform_diag"]
    V = ck.quadform_diag_cuda(A, W)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["quadform_diag"] == before + 1 and V.shape == (S, G, N)
    plain = ck.quadform_diag_plain(A, W)
    ref = ck.quadform_diag_plain(A.double(), W.double())
    scale = float(ref.abs().max())
    err_k = float((V.double() - ref).abs().max()) / scale
    err_p = float((plain.double() - ref).abs().max()) / scale
    assert err_k <= 3 * err_p + 1e-6, (err_k, err_p)
    assert _close(V, plain, 1e-4)
    assert torch.equal(V, ck.quadform_diag_cuda(A, W))


@pytest.mark.parametrize("M, N, G", [(100, 512, 78), (200, 512, 78), (100, 2000, 15),
                                     (100, 512, 3003), (200, 512, 3003)])
def test_quadform_forward_on_the_path_inputs(dev, M, N, G):
    """6a on the path's kind of inputs (C cancels), with either register
    tile: the float64 gate, 3x the plain float32 error + 1e-6 of max.  The
    kernel picks the tile from the shape (`fills_card` in the source): G =
    3003 at N = 512 fills the card with the 8-column tile, the smaller G
    take the 4-column one."""
    A, W = _path_qf_inputs(dev, M, N, G, M + G)
    V = ck.quadform_diag_cuda(A, W)
    ref = ck.quadform_diag_plain(A.double(), W.double())
    scale = float(ref.abs().max())
    err_k = float((V.double() - ref).abs().max()) / scale
    err_p = float((ck.quadform_diag_plain(A, W).double() - ref).abs().max()) / scale
    assert err_k <= 3 * err_p + 1e-6, (err_k, err_p)


def test_quadform_forward_reads_only_the_lower_triangle(dev):
    """Garbage above W's diagonal (NaN, inf, huge values) changes nothing:
    the kernel reads the lower triangle and takes the rest as zero."""
    g = _gen(dev, 7)
    for M, N in ((100, 512), (37, 75)):
        A = torch.randn(2, M, N, device=dev, generator=g)
        W = 0.1 * torch.randn(2, 11, M, M, device=dev, generator=g).tril()
        upper = torch.ones(M, M, dtype=torch.bool, device=dev).triu(1)
        junk = torch.randn(2, 11, M, M, device=dev, generator=g) * 1e30
        junk[..., 0, -1] = float("nan")
        junk[..., 1, -1] = float("inf")
        Wj = torch.where(upper, junk, W)
        assert torch.equal(ck.quadform_diag_cuda(A, Wj), ck.quadform_diag_cuda(A, W))
        assert _close(ck.quadform_diag_cuda(A, Wj), ck.quadform_diag_plain(A, W), 1e-4)


def test_quadform_forward_takes_m_512(dev):
    """max_m("quadform_diag") >= 512 on the H100, and the kernel at its
    largest M against the plain version."""
    assert ck.max_m("quadform_diag") >= 512
    M = ck.max_m("quadform_diag")
    A, W, _ = _qf_inputs(dev, 1, M, 70, 2, M)
    assert _close(ck.quadform_diag_cuda(A, W), ck.quadform_diag_plain(A, W), 1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.rand(5, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        ck.gibbs_cuda(x, x, x, x)
    with pytest.raises(ValueError):
        ck.gibbs_cuda(torch.rand(4, 5, device=dev), torch.rand(4, 5, device=dev),
                      torch.ones(4, device=dev), torch.ones(4, device=dev))
    m = ck.max_m("chol_inv") + 1
    with pytest.raises(ValueError):
        ck.chol_inv_cuda(torch.eye(m, device=dev))
    with pytest.raises(ValueError):
        ck.chol_inv_cuda(torch.eye(4, 5, device=dev))
    with pytest.raises(ValueError):
        ck.cholesky_cuda(torch.eye(ck.max_m("cholesky") + 1, device=dev))
    with pytest.raises(TypeError):
        ck.cholesky_cuda(torch.eye(4, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):  # the RBF kernel takes 1-D inputs
        ck.rbf_cuda(torch.rand(4, 2, device=dev), torch.rand(4, 2, device=dev), 1.0, 0.5)
    with pytest.raises(ValueError):  # task dims above 16
        ck.kron_mv_cuda(torch.ones(17, 17, device=dev), torch.ones(3, 3, device=dev),
                        torch.ones(51, device=dev))
    with pytest.raises(ValueError):  # y does not match B kron K
        ck.kron_mv_cuda(torch.ones(2, 2, device=dev), torch.ones(3, 3, device=dev),
                        torch.ones(5, device=dev))
    m = ck.max_m("quadform_diag") + 1
    with pytest.raises(ValueError):
        ck.quadform_diag_cuda(torch.ones(m, 3, device=dev), torch.ones(1, m, m, device=dev))


def _qf_inputs(dev, S, M, N, G, seed):
    g = _gen(dev, seed)
    A = torch.randn(S, M, N, device=dev, generator=g)
    W = torch.randn(S, G, M, M, device=dev, generator=g).tril()
    vbar = torch.randn(S, G, N, device=dev, generator=g)
    return A, W, vbar


@pytest.mark.parametrize(
    "S, M, N, G",
    [(1, 1, 1, 1), (2, 13, 70, 5), (1, 100, 512, 40), (3, 24, 129, 2), (1, 9, 65, 33),
     (1, 139, 65, 3), (1, 161, 100, 7), (2, 200, 300, 5), (1, 256, 64, 2), (1, 200, 512, 200),
     (1, "max", 65, 3)],
)
def test_quadform_backward_kernels_match_plain(dev, S, M, N, G):
    """dW (lower triangle, zeros above) and dA against the plain versions,
    ragged N tiles and k-panels, M above the one-block limits of the first
    kernels (138, 160), G below the SM count, and the largest M included;
    sums of M products of N terms, in another order, so 1e-4 of max."""
    if M == "max":
        M = min(ck.max_m("quadform_diag_dw"), ck.max_m("quadform_diag_da"))
    A, W, vbar = _qf_inputs(dev, S, M, N, G, M * N + G)
    before = dict(ck.LAUNCHES)
    dW = ck.quadform_diag_dw_cuda(A, W, vbar)
    dA = ck.quadform_diag_da_cuda(A, W, vbar)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["quadform_diag_dw"] == before["quadform_diag_dw"] + 1
    assert ck.LAUNCHES["quadform_diag_da"] == before["quadform_diag_da"] + 1
    assert _close(dW, ck.quadform_diag_dw_plain(A, W, vbar), 1e-4)
    assert torch.equal(dW, dW.tril())
    assert _close(dA, ck.quadform_diag_da_plain(A, W, vbar), 1e-4)
    dW0 = ck.quadform_diag_dw_cuda(A[0], W[0], vbar[0])  # no draw dimension
    dA0 = ck.quadform_diag_da_cuda(A[0], W[0], vbar[0])
    assert dW0.shape == (G, M, M) and dA0.shape == (M, N)
    assert torch.equal(dW0, dW[0]) and torch.equal(dA0, dA[0])  # deterministic


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("G", [1, 3003])
@pytest.mark.parametrize("N", [512, 75])
@pytest.mark.parametrize("M", [100, 200, 37, 131])
def test_quadform_backward_kernels_against_float64(dev, M, N, G, S):
    """The tensor-core backward kernels (split operands, csrc/qf_mma.cuh) at
    the path's M = 100 and 200, M not a multiple of 4 or 16, N not a
    multiple of 4 (4-byte copies), one group and ECoG's 3003: each at most
    3x as far from float64 as the plain float32 version, + 1e-6 of max (the
    floor of chip_smoke.backward_kernels); two runs bitwise equal."""
    g = _gen(dev, M * N + G + S)
    A = torch.randn(S, M, N, device=dev, generator=g)
    W = 0.1 * torch.randn(S, G, M, M, device=dev, generator=g).tril()
    vbar = torch.randn(S, G, N, device=dev, generator=g)
    for name in ("quadform_diag_dw", "quadform_diag_da"):
        kern, plain = getattr(ck, f"{name}_cuda"), getattr(ck, f"{name}_plain")
        got = kern(A, W, vbar)
        ref = plain(A.double(), W.double(), vbar.double())
        scale = float(ref.abs().max())
        err_k = float((got.double() - ref).abs().max()) / scale
        err_p = float((plain(A, W, vbar).double() - ref).abs().max()) / scale
        assert err_k <= 3 * err_p + 1e-6, (name, err_k, err_p)
        assert torch.equal(got, kern(A, W, vbar))  # deterministic
        del got, ref


@pytest.mark.parametrize(
    "S, M, N, G",
    [(1, 1, 1, 1), (2, 13, 70, 5), (1, 100, 512, 40), (3, 24, 129, 2), (1, 9, 65, 33),
     (1, 112, 600, 3), (1, 113, 65, 3), (2, 200, 300, 5), (1, 100, 1000, 7), (1, "max", 65, 3)],
)
def test_quadform_fused_backward_matches_plain(dev, S, M, N, G):
    """The fused backward's (dA, dW) against its plain version: ragged N
    tiles, k-panels and clusters, N beyond one cluster (several supers),
    both variants (M up to 112, and above) and the largest M; one launch
    counted; two launches bitwise equal; without a draw dimension the
    plain version's values (the launch is cut by S, so the order of its
    sums may differ)."""
    if M == "max":
        M = ck.max_m("quadform_diag_bwd")
    A, W, vbar = _qf_inputs(dev, S, M, N, G, M * N + G)
    before = dict(ck.LAUNCHES)
    dA, dW = ck.quadform_diag_bwd_cuda(A, W, vbar)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["quadform_diag_bwd"] == before["quadform_diag_bwd"] + 1
    pA, pW = ck.quadform_diag_bwd_plain(A, W, vbar)
    assert _close(dA, pA, 1e-4) and _close(dW, pW, 1e-4)
    assert torch.equal(dW, dW.tril())
    again = ck.quadform_diag_bwd_cuda(A, W, vbar)
    assert torch.equal(again[0], dA) and torch.equal(again[1], dW)  # deterministic
    dA0, dW0 = ck.quadform_diag_bwd_cuda(A[0], W[0], vbar[0])  # no draw dimension
    assert dA0.shape == (M, N) and dW0.shape == (G, M, M)
    assert _close(dA0, pA[0], 1e-4) and _close(dW0, pW[0], 1e-4)


@pytest.mark.parametrize("G, M, N", [(3003, 100, 512), (15, 100, 2000)])
def test_quadform_fused_backward_against_float64(dev, G, M, N):
    """chip_smoke.py's gate at ECoG's and PM2.5-sub's offdiagonal shapes:
    dA and dW each at most 3x as far from float64 as the plain float32
    version, + 1e-6 of max; dW zero above the diagonal; two launches
    bitwise equal."""
    g = _gen(dev, M * N + G)
    A = torch.randn(M, N, device=dev, generator=g)
    W = 0.1 * torch.randn(G, M, M, device=dev, generator=g).tril()
    vbar = torch.randn(G, N, device=dev, generator=g)
    got = ck.quadform_diag_bwd_cuda(A, W, vbar)
    again = ck.quadform_diag_bwd_cuda(A, W, vbar)
    plain = ck.quadform_diag_bwd_plain(A, W, vbar)
    ref = ck.quadform_diag_bwd_plain(A.double(), W.double(), vbar.double())
    for what, k, p, r in zip(("dA", "dW"), got, plain, ref):
        scale = float(r.abs().max())
        err_k = float((k.double() - r).abs().max()) / scale
        err_p = float((p.double() - r).abs().max()) / scale
        assert err_k <= 3 * err_p + 1e-6, (what, err_k, err_p)
    assert torch.equal(got[1], got[1].tril())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_fused_backward_wrapper_refuses_what_the_kernel_does_not_take(dev):
    A, W, vbar = _qf_inputs(dev, 1, 6, 10, 2, 0)
    with pytest.raises(TypeError):
        ck.quadform_diag_bwd_cuda(A.double(), W.double(), vbar.double())
    with pytest.raises(ValueError):
        ck.quadform_diag_bwd_cuda(A, W, vbar[..., :-1])
    with pytest.raises(ValueError):
        ck.quadform_diag_bwd_cuda(A, W[..., :-1, :-1], vbar)
    m = ck.max_m("quadform_diag_bwd") + 1
    with pytest.raises(ValueError):
        ck.quadform_diag_bwd_cuda(torch.ones(m, 3, device=dev), torch.ones(1, m, m, device=dev),
                                  torch.ones(1, 3, device=dev))
    assert ck.max_m("quadform_diag_bwd") >= 200  # ECoG's M = 200


def _whitened_inputs(dev, S, sizes, M, seed, dtype=torch.float32):
    """A factor parameter X (G, M, M) of the group sets `sizes`, one prior
    inverse factor (S, M, M) a set from a random SPD gram (float64, rounded),
    and cotangents of every output: dW lower-triangular, the traces' and the
    log-determinants'."""
    g = _gen(dev, seed)
    G = sum(sizes)
    X = 0.1 * torch.randn(G, M, M, device=dev, generator=g, dtype=torch.float64)
    Ps = []
    for _ in sizes:
        B = torch.randn(S, M, M, device=dev, generator=g, dtype=torch.float64)
        K = B @ B.mT / M + 0.1 * torch.eye(M, device=dev, dtype=torch.float64)
        L = torch.linalg.cholesky(K)
        Ps.append(torch.linalg.solve_triangular(L, torch.eye(M, device=dev, dtype=torch.float64)
                                                .expand_as(L), upper=False))
    dWs = [torch.randn(S, n, M, M, device=dev, generator=g, dtype=torch.float64).tril()
           for n in sizes]
    dtrs = [torch.randn(S, n, device=dev, generator=g, dtype=torch.float64) for n in sizes]
    dlds = [torch.randn(n, device=dev, generator=g, dtype=torch.float64) for n in sizes]
    cast = lambda ts: tuple(t.to(dtype) for t in ts)  # noqa: E731
    return X.to(dtype), cast(Ps), cast(dWs), cast(dtrs), cast(dlds)


def _whitened_run(fwd, bwd, X, Ps, sizes, dWs, dtrs, dlds):
    Ws, trs, lds = fwd(X, Ps, sizes, 1e-4)
    dX, dPs = bwd(X, Ps, sizes, 1e-4, Ws, dWs, dtrs, dlds)
    return [*Ws, *trs, *lds, dX, *dPs]


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300) if b.numel() else 0.0


@pytest.mark.parametrize("S, sizes, M", [
    (1, (3003, 78), 100), (1, (15, 6), 100), (1, (78,), 100), (3, (15, 6), 100), (1, (15, 6), 200),
])
def test_whitened_factors_kernels_against_float64(dev, S, sizes, M):
    """The two kernels in float32 at ECoG's (3003 + 78 groups), PM2.5's
    (15 + 6) and sqrt_W's sets, three draws and M = 200: every output and
    gradient within float32 rounding of the float64 plain version (at most
    3x the float32 plain version's error, or 2e-6 of its largest entry), one
    launch of each kernel a call, and two runs bitwise equal."""
    X, Ps, dWs, dtrs, dlds = _whitened_inputs(dev, S, sizes, M, 40 + M + S)
    before = dict(ck.LAUNCHES)
    got = _whitened_run(ck.whitened_factors_cuda, ck.whitened_factors_bwd_cuda, X, Ps, sizes,
                        dWs, dtrs, dlds)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["whitened_factors"] == before["whitened_factors"] + 1
    assert ck.LAUNCHES["whitened_factors_bwd"] == before["whitened_factors_bwd"] + 1
    again = _whitened_run(ck.whitened_factors_cuda, ck.whitened_factors_bwd_cuda, X, Ps, sizes,
                          dWs, dtrs, dlds)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = _whitened_run(ck.whitened_factors_plain, ck.whitened_factors_bwd_plain, X, Ps, sizes,
                          dWs, dtrs, dlds)
    f64 = lambda ts: tuple(t.double() for t in ts)  # noqa: E731
    ref = _whitened_run(ck.whitened_factors_plain, ck.whitened_factors_bwd_plain, X.double(),
                        f64(Ps), sizes, f64(dWs), f64(dtrs), f64(dlds))
    for k, (a, p, r) in enumerate(zip(got, plain, ref)):
        assert a.shape == r.shape and a.dtype == torch.float32
        assert _rel(a, r) <= max(3 * _rel(p, r), 2e-6), (k, _rel(a, r), _rel(p, r))
    k = len(sizes)
    for W in got[:k]:  # zeros above the diagonal, written
        assert torch.equal(W, W.tril())


def test_whitened_factors_kernel_nan_above_the_diagonal(dev):
    """A NaN strictly above X's diagonal: W's column below it and the trace
    NaN, as in the plain version; the other groups' untouched."""
    X, Ps, _, _, _ = _whitened_inputs(dev, 1, (4, 3), 12, 5)
    X[1, 2, 7] = float("nan")
    X[5, 3, 3] = 0.0
    Ws, trs, lds = ck.whitened_factors_cuda(X, Ps, (4, 3), 1e-4)
    pW, ptr, pld = ck.whitened_factors_plain(X, Ps, (4, 3), 1e-4)
    for a, b in zip(Ws + trs + lds, pW + ptr + pld):
        a, b = (a.tril() if a.ndim == 4 else a), (b.tril() if b.ndim == 4 else b)
        assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.isnan(Ws[0][0, 1, 7:, 7]).all() and torch.isnan(trs[0][0, 1])
    assert torch.isfinite(Ws[1]).all() and torch.isfinite(lds[0]).all()


def test_whitened_factors_wrappers_refuse_what_the_kernels_do_not_take(dev):
    X, Ps, dWs, dtrs, dlds = _whitened_inputs(dev, 1, (3, 2), 8, 6)
    with pytest.raises(TypeError):
        ck.whitened_factors_cuda(X.double(), tuple(P.double() for P in Ps), (3, 2), 1e-4)
    with pytest.raises(ValueError):
        ck.whitened_factors_cuda(X, Ps, (3, 3), 1e-4)  # the sets do not cut X
    with pytest.raises(ValueError):
        ck.whitened_factors_cuda(X, (Ps[0][..., :-1, :-1], Ps[1]), (3, 2), 1e-4)
    Ws, _, _ = ck.whitened_factors_cuda(X, Ps, (3, 2), 1e-4)
    with pytest.raises(ValueError):
        ck.whitened_factors_bwd_cuda(X, Ps, (3, 2), 1e-4, Ws, (dWs[0][:, :-1], dWs[1]), dtrs, dlds)
    m = ck.max_m("whitened_factors") + 1
    with pytest.raises(ValueError):
        ck.whitened_factors_cuda(torch.ones(1, m, m, device=dev), (torch.ones(1, m, m, device=dev),),
                                 (1,), 1e-4)
    assert min(ck.max_m("whitened_factors"), ck.max_m("whitened_factors_bwd")) >= 200  # ECoG's M


def test_float64_inference_on_the_card_launches_no_kernel(dev):
    """dtype=float64 takes the plain versions by the dispatch rule
    (`cuda_kernels.use_kernel`), as the JAX package takes Pallas only for
    float32; a float32 run of the same fit launches all five training
    kernels."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import (
        sim_illustration_low_freq,
    )

    X, Y, _, _ = sim_illustration_low_freq(seed=1)
    fits = {}
    for dtype in (torch.float64, torch.float32):
        ck.reset_launches()
        res = dsvi.inference(X, Y, np.linspace(0, 1, 10), 64, 2, itnum=2, show_ELBO=False,
                             dtype=dtype, seed=0, device=dev)
        torch.cuda.synchronize()
        fits[dtype] = (dict(ck.LAUNCHES), res)
        assert np.all(np.isfinite(res.loss_list)) and len(res.loss_list) == 2 * 4
        assert res.params.mu_v.dtype == dtype and res.params.mu_v.is_cuda
    assert sum(fits[torch.float64][0].values()) == 0, fits[torch.float64][0]
    assert all(fits[torch.float32][0][k] > 0 for k in TRAIN_KERNELS), fits[torch.float32][0]


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(dev):
    A, W, vbar = _qf_inputs(dev, 1, 6, 10, 2, 0)
    for fn in (ck.quadform_diag_dw_cuda, ck.quadform_diag_da_cuda):
        with pytest.raises(TypeError):
            fn(A.double(), W.double(), vbar.double())
        with pytest.raises(ValueError):
            fn(A, W, vbar[..., :-1])  # vbar does not match V
        with pytest.raises(ValueError):
            fn(A, W[..., :-1, :-1], vbar)  # W does not match A
    for name, fn in (("quadform_diag_dw", ck.quadform_diag_dw_cuda),
                     ("quadform_diag_da", ck.quadform_diag_da_cuda)):
        m = ck.max_m(name) + 1
        with pytest.raises(ValueError):
            fn(torch.ones(m, 3, device=dev), torch.ones(1, m, m, device=dev),
               torch.ones(1, 3, device=dev))


def _plain_versions():
    stack = ExitStack()
    for name in ck.KERNELS:
        stack.enter_context(mock.patch.object(ck, f"{name}_cuda", getattr(ck, f"{name}_plain")))
    return stack


def test_negative_selbo_backward_on_the_card_matches_plain(dev):
    """loss.backward() through all the step's kernels against the plain versions
    on the same noise and batch, draw by draw (the first draw, then three
    more).  Both float32 runs are held against a float64 run of the plain
    versions: the kernels may be at most 3x as far off as the plain versions
    or as the draw's float64 witness, + 1e-5 of max (f32 through the prior
    factorization).

    The witness: the variance and length-scale logs' gradients are sums
    over the prior grams of terms that cancel (the prior's Cholesky-inverse
    backward at these length scales), so merely storing the prior stack's
    gradient dK in float32 moves them, and two float32 orderings of the same
    math land a coin's toss apart (about one draw in five differs by more
    than 3x).  The witness is the float64 vector-Jacobian product of the
    prior stack toward each leaf with cotangent |fl32(dK) - dK|: for those
    leaves, whose grams grow with them, the most that the float32 storage
    of dK can move their gradient.  Leaves that do not reach the grams have
    a witness of 0 and keep the plain versions' bound alone."""
    D, M, B = 3, 12, 40
    g = _gen(dev, 0)
    params = cnmgp.init_params(g, D, M, device=dev)
    params = params._replace(
        mu_v=torch.full((M,), -1.5, device=dev),
        length_scales_tildeell_log=torch.tensor(-1.5, device=dev),
        length_scales_L0_log=torch.tensor(-1.2, device=dev),
        length_scales_L1_log=torch.tensor(-1.0, device=dev),
    )
    Z = torch.linspace(0.0, 1.0, M, device=dev)
    x = torch.rand(B, device=dev, generator=g)
    idx = torch.randint(0, D, (B,), device=dev, generator=g)
    y = torch.sin(6 * x)
    w = torch.ones(B, device=dev)
    noises = [cnmgp.draw_train_noise(g, 1, M, B, D) for _ in range(4)]

    def grads(dtype, noise, witness=False):
        p = cnmgp.CNMGPParams(*(t.detach().to(dtype).clone().requires_grad_(True) for t in params))
        nz = cnmgp.CNMGPNoise(*(None if z is None else z.to(dtype) for z in noise))
        stacks = []

        def keep(factor):
            def run(K, *args):
                stacks.append(K)
                return factor(K, *args)
            return run

        with mock.patch.object(cnmgp, "chol_tri_inv", keep(cnmgp.chol_tri_inv)), \
                mock.patch.object(cnmgp, "chol_tri_inv_robust", keep(cnmgp.chol_tri_inv_robust)):
            loss = cnmgp.negative_selbo(p, Z.to(dtype), x.to(dtype), y.to(dtype), idx,
                                        w.to(dtype), 1000.0, nz)
        if not witness:
            loss.backward()
            return [t.grad for t in p]
        (K,) = stacks
        dK, *got = torch.autograd.grad(loss, (K, *p), retain_graph=True)
        moved = torch.autograd.grad(K, tuple(p), (dK.float().double() - dK).abs(),
                                    allow_unused=True)
        return got, [0.0 if m is None else float(m.abs().max()) for m in moved]

    ck.reset_launches()
    g_kernel = [grads(torch.float32, nz) for nz in noises]
    torch.cuda.synchronize()
    assert all(ck.LAUNCHES[k] > 0 for k in TRAIN_KERNELS), ck.LAUNCHES
    with _plain_versions():
        g_plain = [grads(torch.float32, nz) for nz in noises]
        g_64 = [grads(torch.float64, nz, witness=True) for nz in noises]
    for draw, (gk_all, gp_all, (g64_all, wit_all)) in enumerate(zip(g_kernel, g_plain, g_64)):
        for name, gk, gp, g64, wit in zip(cnmgp.CNMGPParams._fields, gk_all, gp_all, g64_all,
                                          wit_all):
            scale = float(g64.abs().max())
            err_k = float((gk.double() - g64).abs().max())
            err_p = float((gp.double() - g64).abs().max())
            assert err_k <= 3 * max(err_p, wit) + 1e-5 * scale, (draw, name, err_k, err_p, wit,
                                                                  scale)


# ---------------------------------------------------------------------------
# The fully-Bayesian path's kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S, n, m", [(None, 1, 1), (None, 100, 100), (4, 37, 70), (3, 200, 33)])
def test_rbf_kernel_matches_plain(dev, S, n, m):
    g = _gen(dev, n + m)
    x1, x2 = torch.rand(n, device=dev, generator=g), torch.rand(m, device=dev, generator=g)
    if S is None:
        s2, ls = 2.0, 0.4
    else:
        s2 = torch.rand(S, device=dev, generator=g) + 0.5
        ls = torch.rand(S, device=dev, generator=g) + 0.1
    before = ck.LAUNCHES["rbf"]
    K = ck.rbf_cuda(x1, x2, s2, ls)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["rbf"] == before + 1
    K_ref = ck.rbf_plain(x1, x2, s2, ls)
    assert K.shape == K_ref.shape and torch.allclose(K, K_ref, rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("S, n, m", [(70_001, 3, 5), (70_000, 2, 4), (2, 1023, 1021), (1, 1, 3),
                                     (5, 7, 2), (3, 130, 66)])
def test_rbf_kernel_flat_rows_and_tails(dev, S, n, m):
    """The flat-output kernel: more pairs than the 65,535 a grid dimension
    holds, M % 4 != 0 (four outputs that cross a row and a pair, and a
    scalar tail of S N M mod 4), M below 4; an x2 that starts one float
    into its storage (no 16-byte alignment) gives the same gram.  rtol
    1e-5 against the plain version, as chip_smoke.py holds it."""
    g = _gen(dev, S + n * m)
    x1, x2 = 3.0 * torch.rand(n, device=dev, generator=g), 3.0 * torch.rand(m, device=dev, generator=g)
    s2 = torch.rand(S, device=dev, generator=g) + 0.5
    ls = torch.rand(S, device=dev, generator=g) + 0.1
    before = ck.LAUNCHES["rbf"]
    K = ck.rbf_cuda(x1, x2, s2, ls)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["rbf"] == before + 1 and K.shape == (S, n, m)
    ref = ck.rbf_plain(x1, x2, s2, ls)
    assert torch.isfinite(K).all()
    assert float(((K - ref).abs() - 1e-5 * ref.abs() - 1e-30).max()) <= 0.0
    x2s = torch.cat([x2.new_ones(1), x2])[1:]
    assert torch.equal(ck.rbf_cuda(x1, x2s, s2, ls), K)


def test_rbf_kernel_rounds_as_the_plain_version(dev):
    """The kernel divides by the division's fast path without its branch
    (`quotient` in csrc/rbf.cu) where the operands allow it, and by IEEE
    division elsewhere: at lengthscales from 2^-80 to 2^80, inputs whose
    quotients land on the body of the exponential (so that an ulp of a
    quotient shows in K), and some beyond 2^60 (the other branch), the gram
    equals the plain version's bit for bit."""
    g = _gen(dev, 11)
    u = 12.0 * torch.rand(1024, device=dev, generator=g) - 6.0
    v = 12.0 * torch.rand(64, device=dev, generator=g) - 6.0
    for e in range(-80, 81, 5):
        ls = torch.tensor([2.0**e * (1.0 + 0.37 * (e % 3))], device=dev)
        x1, x2 = u * ls, v * ls
        K = ck.rbf_cuda(x1, x2, torch.ones(1, device=dev), ls)
        assert torch.equal(K, ck.rbf_plain(x1, x2, torch.ones(1, device=dev), ls)), e


def test_rbf_kernel_nan_and_inf_as_the_plain_version(dev):
    """NaN and Inf in the inputs, a zero lengthscale and an infinite scale
    come out where and as the plain version has them (each step an IEEE
    operation, no reordering)."""
    x1 = torch.tensor([0.0, float("nan"), float("inf"), -float("inf"), 0.3, 1.0, 2.0], device=dev)
    x2 = torch.tensor([0.1, float("inf"), 0.5, float("nan"), -1.0], device=dev)
    s2 = torch.tensor([1.0, float("inf"), 2.0, float("nan")], device=dev)
    ls = torch.tensor([0.5, 0.5, 0.0, 1.0], device=dev)
    for a, b in ((x1, x2), (x1, x1), (x2, x1[:4])):
        K, ref = ck.rbf_cuda(a, b, s2, ls), ck.rbf_plain(a, b, s2, ls)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(K), torch.isnan(ref))
        assert torch.equal(torch.isinf(K), torch.isinf(ref))
        fin = torch.isfinite(ref)
        assert torch.allclose(K[fin], ref[fin], rtol=1e-5, atol=1e-30)


# The RBF gram's shapes on the paths, as chip_smoke.py's RBF_PATH_SHAPES:
# predict_y_mean's cross and inducing grams at ECoG width (inputs on the
# time axis [0, 800], lengthscale 40, a 0-d scale and lengthscale), the SVC
# whitening pairs at N = 100 and the SNMGP ones at N = 1024 (inputs on [0, 1])
RBF_PATH_CASES = [((1, 512, 100), 800.0, None), ((1, 100, 100), 800.0, None),
                  ((2, 100, 100), 1.0, ((9.0, 0.4), (25.0, 1.0))),
                  ((2, 1024, 1024), 1.0, ((9.0, 0.4), (1.0, 0.4)))]


@pytest.mark.parametrize("shape, span, pairs", RBF_PATH_CASES)
def test_rbf_kernel_against_float64_at_the_path_shapes(dev, shape, span, pairs):
    """At each path shape the kernel's f32 gram is at most 3x as far from a
    float64 run of the plain version as the plain f32 one, + 1e-6 of max
    (chip_smoke.py's gate)."""
    S, n, m = shape
    g = _gen(dev, n + m + S)
    x1 = span * torch.rand(n, device=dev, generator=g)
    x2 = torch.linspace(0.0, span, m, device=dev) if n != m else x1
    if pairs is None:
        s2, ls = torch.tensor(1.0, device=dev), torch.tensor(40.0, device=dev)
    else:
        s2, ls = (torch.tensor(v, device=dev) for v in zip(*pairs))
    K = ck.rbf_cuda(x1, x2, s2, ls)
    plain = ck.rbf_plain(x1, x2, s2, ls)
    ref = ck.rbf_plain(x1.double(), x2.double(), s2.double(), ls.double())
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err_k = float((K.double() - ref).abs().max()) / scale
    err_p = float((plain.double() - ref).abs().max()) / scale
    assert K.shape == (shape[1:] if pairs is None else shape)
    assert err_k <= 3 * err_p + 1e-6, (err_k, err_p)


def _grad_pair(fn, inputs, weights):
    """Gradients of sum(w * fn(*inputs)) by the kernels and by the plain
    versions, float32, and by the plain versions in float64."""
    out = []
    for dtype, plain in ((torch.float32, False), (torch.float32, True), (torch.float64, True)):
        leaves = [t.detach().to(dtype).requires_grad_(True) for t in inputs]
        with _plain_versions() if plain else ExitStack():
            (weights.to(dtype) * fn(*leaves)).sum().backward()
        out.append([t.grad for t in leaves])
    return out


def _assert_witnessed(k, p, r, floor):
    """The kernels' error against float64 is at most 3x the plain f32
    version's + floor x max (sums in another order)."""
    for gk, gp, g64 in zip(k, p, r):
        scale = float(g64.abs().max())
        err_k = float((gk.double() - g64).abs().max())
        err_p = float((gp.double() - g64).abs().max())
        assert err_k <= 3 * err_p + floor * scale, (err_k, err_p, scale)


def test_rbf_function_gradients_on_the_card(dev):
    g = _gen(dev, 1)
    x = torch.sort(torch.rand(60, device=dev, generator=g)).values
    s2 = torch.rand(3, device=dev, generator=g) + 0.5
    ls = torch.rand(3, device=dev, generator=g) + 0.1
    w = torch.randn(3, 60, 60, device=dev, generator=g)
    _assert_witnessed(*_grad_pair(lambda a, s, l: kernels.rbf(a, a, s, l), (x, s2, ls), w), 1e-5)


@pytest.mark.parametrize("batch, m", [(1, 1), (3, 13), (4, 100), (2, 200), (2, 512), (1, 1024)])
def test_cholesky_kernel_matches_plain(dev, batch, m):
    K = _spd(dev, batch, m, m + 1)
    before = ck.LAUNCHES["cholesky"]
    L = ck.cholesky_cuda(K)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cholesky"] == before + 1
    assert _close(L, ck.cholesky_plain(K), 1e-4)
    assert (L.triu(1) == 0).all()


@pytest.mark.parametrize("route", sorted(ck.CHOLESKY_ROUTES))
@pytest.mark.parametrize("batch, m", [(1, 1), (4, 31), (2, 100), (1, 401), (3, 1024), (2, 2048),
                                      (1, 3400)])
def test_cholesky_routes_match_plain_with_nan_members(dev, route, batch, m):
    """Each route of csrc/cholesky.cu against float64 (at most 3x the plain
    f32 error + 1e-6 of max), zeros above the diagonal, and with one more
    member that is not PD: NaN in its lower triangle, zero above, the
    others unchanged."""
    K = _spd(dev, batch + 1, m, m + 3)
    K[-1, m // 2, m // 2] = -1.0
    L = ck.cholesky_cuda(K, route)
    torch.cuda.synchronize()
    Lp, L64 = ck.cholesky_plain(K[:-1]), ck.cholesky_plain(K[:-1].double())
    err_k = float((L[:-1].double() - L64).abs().max())
    err_p = float((Lp.double() - L64).abs().max())
    assert err_k <= 3 * err_p + 1e-6 * float(L64.abs().max()), (err_k, err_p)
    assert (L.triu(1) == 0).all()
    lower = torch.ones(m, m, dtype=torch.bool, device=dev).tril()
    assert torch.isnan(L[-1][lower]).all() and torch.isfinite(L[:-1]).all()


def test_cholesky_kernel_nan_semantics_and_gradient(dev):
    K = _spd(dev, 3, 40, 2)
    K[1, 20, 20] = -1.0
    L = ck.cholesky_cuda(K)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(L), torch.isnan(ck.cholesky_plain(K)))
    lower = torch.ones(40, 40, dtype=torch.bool, device=dev).tril()
    assert torch.isnan(L[1][lower]).all() and (L[1][~lower] == 0).all()
    assert torch.isfinite(L[[0, 2]]).all()
    w = torch.randn(2, 40, 40, device=dev, generator=_gen(dev, 3)).tril()
    _assert_witnessed(*_grad_pair(lambda k: linalg.cholesky(0.5 * (k + k.mT)), (K[[0, 2]],), w), 1e-4)


@pytest.mark.parametrize("m", [171, 200, 512, 1024])
def test_blocked_chol_inv_matches_plain(dev, m):
    """The blocked kernel at the path's larger sizes, one launch: (L, L^-1)
    against the plain version, zeros above the diagonal, NaN on a non-PD
    member (L lower triangle, all of L^-1)."""
    K = _spd(dev, 3, m, m + 2)
    K[1, m // 3, m // 3] = -1.0
    before = dict(ck.LAUNCHES)
    L, Linv = ck.chol_inv_cuda(K)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["chol_inv"] == before["chol_inv"] + 1
    L_ref, Linv_ref = ck.chol_inv_plain(K)
    good = [0, 2]
    assert _close(L[good], L_ref[good], 1e-4) and _close(Linv[good], Linv_ref[good], 1e-3)
    assert (L[good].triu(1) == 0).all() and (Linv[good].triu(1) == 0).all()
    assert torch.equal(torch.isnan(L), torch.isnan(L_ref))
    assert torch.isnan(Linv[1]).all() and torch.isfinite(Linv[good]).all()


@pytest.mark.parametrize("C, N, M", [(None, 300, 2), (4, 1024, 2), (3, 37, 5), (2, 129, 16)])
def test_kron_mv_kernel_matches_plain(dev, C, N, M):
    g = _gen(dev, N + M)
    lead = () if C is None else (C,)
    B = torch.randn(lead + (M, M), device=dev, generator=g)
    K = torch.randn(lead + (N, N), device=dev, generator=g)
    y = torch.randn(M * N, device=dev, generator=g)  # shared by the chains
    before = ck.LAUNCHES["kron_mv"]
    out = ck.kron_mv_cuda(B, K, y)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["kron_mv"] == before + 1
    ref = ck.kron_mv_plain(B.double(), K.double(), y.double())
    assert out.shape == ref.shape and _close(out, ref, 1e-5)


@pytest.mark.parametrize("layout", ["rows", "transposed", "shared", "shared transposed"])
@pytest.mark.parametrize("N, M", [(300, 2), (1024, 2), (37, 5), (129, 16), (2050, 3)])
def test_kron_mv_layouts_match_plain(dev, layout, N, M):
    """K as stored, transposed (a view), and one K for 3 chains (stride
    0), read in place: one launch, no copy of K, against float64."""
    g = _gen(dev, 7 * N + M)
    C = 3
    B = torch.randn(C, M, M, device=dev, generator=g)
    K = torch.randn(C, N, N, device=dev, generator=g)
    K = K[0] if "shared" in layout else K
    K = K.mT if "transposed" in layout else K
    y = torch.randn(C, M * N, device=dev, generator=g)
    Kc = ck._kron_mv_operands(B, K, y)[0]
    assert Kc.data_ptr() == K.data_ptr()
    before = ck.LAUNCHES["kron_mv"]
    out = ck.kron_mv_cuda(B, K, y)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["kron_mv"] == before + 1
    ref = ck.kron_mv_plain(B.double(), K.double(), y.double())
    assert out.shape == ref.shape and _close(out, ref, 1e-5)


def test_kron_mv_function_gradients_on_the_card(dev):
    g = _gen(dev, 2)
    B = torch.randn(3, 2, 2, device=dev, generator=g)
    K = torch.randn(3, 80, 80, device=dev, generator=g)
    y = torch.randn(160, device=dev, generator=g)
    w = torch.randn(3, 160, device=dev, generator=g)
    _assert_witnessed(*_grad_pair(kron.kron_mv, (B, K, y), w), 1e-5)


def test_svc_whitened_backward_on_the_card_matches_plain(dev):
    """One svc_log_posterior_whitened backward (N=100, M=2: NM = 200, the
    Cholesky-inverse; the Gibbs gram of 4 chains) by the kernels,
    against the plain versions, both f32, and float64 on the plain
    versions: the kernels at most 3x as far off + 1e-4 of max."""
    x, _, _, _, Y = sim_mnts(M=2, N=100, seed=0)
    xt, Yt = torch.as_tensor(x, device=dev), torch.as_tensor(Y, device=dev)
    with _plain_versions():  # float64 factors (the kernels take float32), shared by all three
        chols = ld.svc_whiten_chols(xt.double(), 3.0, 0.4, 5.0, 1.0)
    pars = 0.3 * torch.randn(4, 100 * 4 + 1, device=dev, generator=_gen(dev, 4), dtype=torch.float64)
    res = []
    for dtype, plain in ((torch.float32, False), (torch.float32, True), (torch.float64, True)):
        q = pars.to(dtype).requires_grad_(True)
        args = (Yt.to(dtype), xt.to(dtype)) + tuple(c.to(dtype) for c in chols)
        ck.reset_launches()
        with _plain_versions() if plain else ExitStack():
            lp = ld.svc_log_posterior_whitened(q, *args, mu_tilde_l=-3.0)
            lp.sum().backward()
        torch.cuda.synchronize()
        if not plain:
            assert ck.LAUNCHES["gibbs"] > 0 and ck.LAUNCHES["chol_inv"] > 0, ck.LAUNCHES
        res.append((lp.detach(), q.grad))
    for i in range(2):
        scale = float(res[2][i].abs().max())
        err_k = float((res[0][i].double() - res[2][i]).abs().max())
        err_p = float((res[1][i].double() - res[2][i]).abs().max())
        assert err_k <= 3 * err_p + 1e-4 * scale, (i, err_k, err_p, scale)


# ---------------------------------------------------------------------------
# The fused Cholesky-inverse on its two routes
# ---------------------------------------------------------------------------


def _witnessed_chol_inv(K, L, Linv, floor=1e-6):
    """(L, L^-1) of the f32 K against float64 factors of the same input: at
    most 3x the plain f32 version's error + floor of max, each output."""
    Lp, Lip = ck.chol_inv_plain(K)
    L64, Li64 = ck.chol_inv_plain(K.double())
    for got, plain, ref in ((L, Lp, L64), (Linv, Lip, Li64)):
        err_k = float((got.double() - ref).abs().max())
        err_p = float((plain.double() - ref).abs().max())
        assert err_k <= 3 * err_p + floor * float(ref.abs().max()), (err_k, err_p)


@pytest.mark.parametrize(
    "route, batch, m",
    [(r, b, m) for r in sorted(ck.CHOL_INV_ROUTES)
     for b, m in [(1, 1), (3, 37), (2, 100), (4, 200), (2, 240), (2, 1024)]
     if not (r == "resident" and m > 240)],
)
def test_chol_inv_routes_against_float64(dev, route, batch, m):
    """Each route on both sides of the crossover, at M = 1, a ragged M, the
    path's 100 and 200, the resident route's limit 240 and (multi-CTA) 1024:
    one launch of chol_inv and none of cholesky, zeros above the diagonal,
    both outputs held against float64."""
    K = _spd(dev, batch, m, m + 7)
    before = dict(ck.LAUNCHES)
    L, Linv = ck.chol_inv_cuda(K, route)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["chol_inv"] == before["chol_inv"] + 1
    assert ck.LAUNCHES["cholesky"] == before["cholesky"]
    assert torch.equal(L, L.tril()) and torch.equal(Linv, Linv.tril())
    _witnessed_chol_inv(K, L, Linv)


def test_chol_inv_multi_cta_at_the_dense_kronecker_size(dev):
    K = _spd(dev, 4, 2048, 11)
    L, Linv = ck.chol_inv_cuda(K, "multi_cta")
    torch.cuda.synchronize()
    assert torch.equal(L, L.tril()) and torch.equal(Linv, Linv.tril())
    _witnessed_chol_inv(K, L, Linv)


@pytest.mark.parametrize("route", sorted(ck.CHOL_INV_ROUTES))
@pytest.mark.parametrize("m, where", [(100, 0), (100, 99), (200, 199), (37, 0), (37, 36), (200, 64)])
def test_chol_inv_failed_member_on_each_route(dev, route, m, where):
    """A member whose pivot fails at the first column, in the last block or
    in between, beside healthy members: NaN in its L's lower triangle (zero
    above) and in all of its L^-1, as the plain version gives; the
    neighbours unchanged from a batch without it."""
    K = _spd(dev, 3, m, m + where)
    Kbad = K.clone()
    Kbad[1, where, where] = -1.0
    L, Linv = ck.chol_inv_cuda(Kbad, route)
    L_ref, Linv_ref = ck.chol_inv_plain(Kbad)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(L), torch.isnan(L_ref))
    assert torch.equal(torch.isnan(Linv), torch.isnan(Linv_ref))
    lower = torch.ones(m, m, dtype=torch.bool, device=dev).tril()
    assert torch.isnan(L[1][lower]).all() and (L[1][~lower] == 0).all()
    assert torch.isnan(Linv[1]).all()
    Lg, Linvg = ck.chol_inv_cuda(K[[0, 2]], route)
    assert torch.equal(L[[0, 2]], Lg) and torch.equal(Linv[[0, 2]], Linvg)


def test_chol_inv_refactors_a_float32_failure_in_float64(dev):
    """The tilde_ell prior gram at HCP width (Z on linspace(0, 4799, 100),
    length scale e^5, + 1e-4) at trained variances e^5-e^6.5, which float32
    factorizations fail on some of (cuSOLVER's among them) and whose float32
    rounding stays positive-definite up to about e^6.3-6.5 (the card's exp
    rounds otherwise than the CPU's), and at e^8, indefinite: the resident
    route refactors a float32 failure in float64,
    as the plain version does, so every member the float64 factorization
    takes is finite and held against float64 as any other (3x the plain
    version's error + 1e-6 of max), and only the indefinite one is NaN."""
    z = torch.linspace(0.0, 4799.0, 100, device=dev)
    d2 = (z[:, None] - z[None, :]) ** 2
    ls = torch.exp(torch.tensor(5.0, device=dev))
    s2_logs = (5.0, 5.8, 6.0, 6.2, 6.4, 6.5, 8.0)
    K = torch.stack([torch.exp(torch.tensor(s, device=dev)) * torch.exp(-d2 * (0.5 / (ls * ls)))
                     + 1e-4 * torch.eye(100, device=dev) for s in s2_logs])
    before = dict(ck.LAUNCHES)
    L, Linv = ck.chol_inv_cuda(K)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["chol_inv"] == before["chol_inv"] + 1
    f32_failed = torch.linalg.cholesky_ex(K)[1] != 0
    pd = torch.linalg.cholesky_ex(K.double())[1] == 0
    assert bool(pd[0]) and not bool(pd[-1]) and bool((f32_failed & pd).any())
    L_ref, Linv_ref = ck.chol_inv_plain(K)
    assert torch.equal(torch.isnan(L), torch.isnan(L_ref))
    assert torch.equal(torch.isnan(Linv), torch.isnan(Linv_ref))
    assert torch.isfinite(L[pd]).all() and torch.isfinite(Linv[pd]).all()
    assert torch.isnan(Linv[~pd]).all()
    _witnessed_chol_inv(K[pd], L[pd], Linv[pd])


@pytest.mark.parametrize("route", sorted(ck.CHOL_INV_ROUTES))
@pytest.mark.parametrize("m", [13, 100, 200])
def test_chol_inv_never_reads_above_the_diagonal(dev, route, m):
    K = _spd(dev, 2, m, m + 5)
    garbage = K + torch.full_like(K, float("nan")).triu(1)
    L, Linv = ck.chol_inv_cuda(K, route)
    Lg, Linvg = ck.chol_inv_cuda(garbage, route)
    torch.cuda.synchronize()
    assert torch.equal(L, Lg) and torch.equal(Linv, Linvg)


def test_chol_inv_max_m(dev):
    assert ck.max_m("chol_inv") >= 3400
    with pytest.raises(ValueError):  # above the resident route's limit
        ck.chol_inv_cuda(torch.eye(241, device=dev), "resident")


def _prior_stacks(dev):
    """The three priors the path factors: the serving chunk's (32, 100, 100)
    stack (RBF lengthscales 12, 16, 24 and a Gibbs gram per draw on
    Z = linspace(0, 800, 100), + 1e-4), the DSVI step's (4, 100, 100) at
    lengthscales 40, and an SVC-style (4, 200, 200) covariance B kron
    K(x, x) + 0.01 I, one per chain."""
    g = _gen(dev, 17)
    Z = torch.linspace(0.0, 800.0, 100, device=dev)
    eye = torch.eye(100, device=dev)
    ell = torch.exp(2.5 + 0.3 * torch.randn(8, 100, device=dev, generator=g))
    stat = torch.stack([kernels.rbf(Z, Z, 1.0, ls) for ls in (12.0, 16.0, 24.0)])
    serving = torch.cat([stat.expand(8, 3, 100, 100), ck.gibbs_plain(Z, Z, ell, ell)[:, None]], 1)
    serving = (serving + 1e-4 * eye).reshape(32, 100, 100)
    ell40 = torch.exp(torch.log(torch.tensor(40.0, device=dev))
                      + 0.1 * torch.randn(100, device=dev, generator=g))
    dsvi = torch.stack([kernels.rbf(Z, Z, 1.0, 40.0)] * 3 + [ck.gibbs_plain(Z, Z, ell40, ell40)])
    dsvi = dsvi + 1e-4 * eye
    x = torch.sort(torch.rand(100, device=dev, generator=g)).values
    A = torch.randn(4, 2, 2, device=dev, generator=g)
    B = A @ A.mT + 0.5 * torch.eye(2, device=dev)
    svc = torch.stack([torch.kron(B[c], kernels.rbf(x, x, 1.0, 0.3)) for c in range(4)])
    svc = svc + 0.01 * torch.eye(200, device=dev)
    return {"serving": serving, "dsvi": dsvi, "svc": svc}


@pytest.mark.parametrize("prior", ["serving", "dsvi", "svc"])
def test_chol_inv_float64_witness_at_the_path_priors(dev, prior):
    K = _prior_stacks(dev)[prior].contiguous()
    L, Linv = ck.chol_inv_cuda(K)
    torch.cuda.synchronize()
    assert torch.isfinite(L).all() and torch.isfinite(Linv).all()
    _witnessed_chol_inv(K, L, Linv)


# ---------------------------------------------------------------------------
# ChEES and SMC on the card (drivers.model_comparison's shapes)
# ---------------------------------------------------------------------------


def _smc_svc_model(dev, dtype=torch.float32, chols=None):
    """The model comparison's whitened SVC at its defaults, N = 48, and its
    whitening factors (computed in f32 unless given)."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
        model_comparison,
    )

    x, _, _, _, Y = sim_mnts(M=2, N=48, seed=0)
    xt = torch.as_tensor(x, dtype=dtype, device=dev)
    Yt = torch.as_tensor(Y, dtype=dtype, device=dev)
    if chols is None:
        chols = ld.svc_whiten_chols(xt, 3.0, 0.4, 1.0, 1.0)
    return model_comparison.make_models(xt, Yt, {"svc": chols})["svc"], chols


def test_chol_inv_and_gibbs_at_the_smc_shapes(dev):
    """chol_inv at (512, 96, 96), on the SVC covariances of 512 prior draws
    as the log-likelihood builds them, and gibbs at (512, 48, 48), on their
    lengthscales: against float64 runs of the plain versions (3x the plain
    f32 error + 1e-6 of max), the Gibbs gram also within rtol 1e-5 of the
    plain f32 one."""
    model, _ = _smc_svc_model(dev)
    q = model.prior_sampler(_gen(dev, 23), 512)
    calls = {}
    with ExitStack() as stack:
        for name in ("chol_inv", "gibbs"):
            def rec(*args, _real=getattr(ck, f"{name}_cuda"), _name=name):
                calls.setdefault(_name, args)
                return _real(*args)

            stack.enter_context(mock.patch.object(ck, f"{name}_cuda", rec))
        model.log_like(q)
    (K,) = calls["chol_inv"]
    assert K.shape == (512, 96, 96)
    L, Linv = ck.chol_inv_cuda(K)
    torch.cuda.synchronize()
    assert torch.isfinite(L).all() and torch.isfinite(Linv).all()
    _witnessed_chol_inv(K, L, Linv)
    x1, x2, l1, l2, s = calls["gibbs"]
    G = ck.gibbs_cuda(x1, x2, l1, l2, s)
    assert G.shape == (512, 48, 48)
    plain = ck.gibbs_plain(x1, x2, l1, l2, s)
    ref = ck.gibbs_plain(x1.double(), x2.double(), l1.double(), l2.double(), s)
    assert torch.allclose(G, plain, rtol=1e-5, atol=1e-30)
    err_k = float((G.double() - ref).abs().max())
    err_p = float((plain.double() - ref).abs().max())
    assert err_k <= 3 * err_p + 1e-6 * float(ref.abs().max()), (err_k, err_p)


class _FixedDraws:
    def __init__(self, z, u):
        self.z, self.u = z, u

    def momentum(self):
        return self.z

    def accept(self):
        return self.u


def test_chees_transition_on_the_card_launches_the_kernels(dev):
    """One `_chees_kernel` transition of 4 chains on the whitened SVC
    density (N = 100, dim 401), f32 with the kernels and with the plain
    versions, and float64: the kernels' positions, log-probs and ChEES
    gradient at most 3x the plain f32 error of float64 + 1e-4 of max (every
    proposal accepted, u = 0, so that no accept decision differs)."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import chees

    x, _, _, _, Y = sim_mnts(M=2, N=100, seed=0)
    with _plain_versions():
        chols = ld.svc_whiten_chols(torch.as_tensor(x, device=dev), 3.0, 0.4, 5.0, 1.0)
    g = _gen(dev, 29)
    q0 = 0.3 * torch.randn(4, 401, device=dev, generator=g, dtype=torch.float64)
    q0[:, -1] = -3.0
    z = torch.randn(4, 401, device=dev, generator=g, dtype=torch.float64)
    res = {}
    for tag, dtype, plain in (("kernels", torch.float32, False), ("plain", torch.float32, True),
                              ("float64", torch.float64, True)):
        xt, Yt = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (x, Y))
        cl, cL = (c.to(dtype) for c in chols)

        def lp(q):
            return ld.svc_log_posterior_whitened(q, Yt, xt, cl, cL, mu_tilde_l=-3.0)

        ck.reset_launches()
        with _plain_versions() if plain else ExitStack():
            state = chees.init_carry(lp, q0.to(dtype), 0.01, 0.01).state
            new, aps, _, grad_t, n = chees._chees_kernel(
                lp, state, _FixedDraws(z.to(dtype), torch.zeros(4, dtype=dtype, device=dev)),
                torch.tensor(0.01, dtype=dtype, device=dev), torch.tensor(0.05, dtype=dtype, device=dev),
                torch.ones(401, dtype=dtype, device=dev), 1024, lambda t: t.mean(0))
        torch.cuda.synchronize()
        launched = dict(ck.LAUNCHES)
        assert n == 5
        if plain:
            assert sum(launched.values()) == 0, launched
        else:
            assert launched["gibbs"] >= 6 and launched["chol_inv"] >= 6, launched
        res[tag] = (new.position, new.log_prob, grad_t)
    for i in range(3):
        ref = res["float64"][i]
        scale = float(ref.abs().max())
        err_k = float((res["kernels"][i].double() - ref).abs().max())
        err_p = float((res["plain"][i].double() - ref).abs().max())
        assert err_k <= 3 * err_p + 1e-4 * scale, (i, err_k, err_p, scale)


def test_smc_stage_on_the_card_launches_the_kernels(dev):
    """One tempering stage of the SVC model (N = 48, 512 particles, one
    mutation of 16 leapfrogs): finite, beta in (0, 1], chol_inv and gibbs
    launched every gradient; the particles' log-likelihoods against
    float64 (3x the plain f32 error + 1e-4 of max)."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.smc import run_smc

    model, chols = _smc_svc_model(dev)
    q = model.prior_sampler(_gen(dev, 31), 512)
    ck.reset_launches()
    pos, info = run_smc(model.log_prior, model.log_like, q, _gen(dev, 32), num_mutations=1,
                        max_stages=1)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["chol_inv"] >= 18 and ck.LAUNCHES["gibbs"] >= 18, ck.LAUNCHES
    assert info["num_stages"] == 1 and 0.0 < float(info["betas"][0]) <= 1.0
    assert torch.isfinite(pos).all() and bool(torch.isfinite(info["log_z"]))
    got = model.log_like(pos)
    with _plain_versions():
        plain = model.log_like(pos)
        ref = _smc_svc_model(dev, torch.float64, chols)[0].log_like(pos.double())
    scale = float(ref.abs().max())
    err_k = float((got.double() - ref).abs().max())
    err_p = float((plain.double() - ref).abs().max())
    assert err_k <= 3 * err_p + 1e-4 * scale, (err_k, err_p, scale)


# ---------------------------------------------------------------------------
# The fused DSVI trainer (`infer/dsvi.make_scan_epochs`) as CUDA graphs
# ---------------------------------------------------------------------------


def _scan_problem(dev, dtype, D=3, M=12, N=100, B=32, seed=0):
    """A small DSVI problem on the card (4 batches an epoch, the last one
    padded) and a fresh trainer over its parameters: (params, mask, Z, x, y,
    idx, trainer, optimizer)."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi

    g = _gen(dev, 100 + seed)
    x = torch.sort(torch.rand(N, device=dev, generator=g, dtype=dtype)).values
    idx = torch.randint(0, D, (N,), device=dev, generator=g)
    y = torch.sin(6 * x) + 0.1 * torch.randn(N, device=dev, generator=g, dtype=dtype)
    Z = torch.linspace(0.0, 1.0, M, device=dev, dtype=dtype)
    params = cnmgp.init_params(_gen(dev, seed), D, M, dtype=dtype, device=dev)
    params = cnmgp.CNMGPParams(*(t.clone().requires_grad_(True) for t in params))
    opt = dsvi.make_optimizer(params, "adam", 0.01)
    trainer = dsvi.make_scan_epochs(opt, float(N), 1e-4, -(-N // B), B)
    return params, dsvi.freeze_mask(params, True), Z, x, y, idx, trainer, opt


@pytest.mark.parametrize("dtype, rtol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_scan_epochs_graph_equals_the_eager_epoch(dev, dtype, rtol):
    """Two graphed epochs and two epochs of the eager body from the same
    parameters, optimizer and generator state give the same losses and
    parameters (float32 through the kernels, all five in the step graph and
    each counted at every replay; float64 through the plain versions, no
    kernel launched)."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi

    p_g, mask, Z, x, y, idx, run, _ = _scan_problem(dev, dtype)
    p_e, _, _, _, _, _, run_e, _ = _scan_problem(dev, dtype)
    ck.reset_launches()
    losses_g = run(p_g, mask, Z, x, y, idx, _gen(dev, 7), 2)
    torch.cuda.synchronize()
    (graphs,) = run.graphs.values()
    replayed = dict(ck.REPLAYED)
    draws = dsvi.EpochDraws(_gen(dev, 7), 12, 32, 3, dtype)
    losses_e = torch.cat([dsvi._eager_epoch(run_e.step, p_e, mask, Z, x, y, idx, draws, 4, 32)
                          for _ in range(2)])
    torch.cuda.synchronize()
    assert losses_g.shape == (8,) and torch.isfinite(losses_g).all()
    assert torch.allclose(losses_g, losses_e, rtol=rtol, atol=0.0), (losses_g, losses_e)
    for a, b in zip(p_g, p_e):
        assert _close(a.detach(), b.detach(), rtol)
    if dtype == torch.float32:
        assert all(graphs.step_launches[k] > 0 for k in TRAIN_KERNELS), graphs.step_launches
        assert all(replayed[k] == 8 * graphs.step_launches[k] for k in ck.KERNELS), replayed
    else:
        assert sum(graphs.step_launches.values()) == 0 and sum(replayed.values()) == 0


def test_a_captured_dsvi_step_launches_the_fused_backward_three_times(dev):
    """The step graph of the fused trainer records the quadform's backward
    as the fused kernel once for each of the step's three quadforms
    (offdiagonal groups, diagonal groups, latent functions), and neither
    6b nor 6c; each replay launches it three times again."""
    p, mask, Z, x, y, idx, run, _ = _scan_problem(dev, torch.float32)
    ck.reset_launches()
    run(p, mask, Z, x, y, idx, _gen(dev, 7), 1)
    torch.cuda.synchronize()
    (graphs,) = run.graphs.values()
    assert graphs.step_launches["quadform_diag_bwd"] == 3, graphs.step_launches
    assert graphs.step_launches["quadform_diag_dw"] == graphs.step_launches["quadform_diag_da"] == 0
    assert ck.REPLAYED["quadform_diag_bwd"] == 3 * 4  # 4 steps an epoch
    assert ck.LAUNCHES["quadform_diag_dw"] == ck.LAUNCHES["quadform_diag_da"] == 0


def test_a_captured_dsvi_step_launches_the_whitened_factors_twice_each_way(dev):
    """The step graph records the whitened factors' kernel twice (sqrt_U's
    two group sets in one launch, sqrt_W's in another) and their backward
    twice; its kernel nodes are fewer than with the two routed to their
    plain versions."""
    p, mask, Z, x, y, idx, run, _ = _scan_problem(dev, torch.float32)
    run(p, mask, Z, x, y, idx, _gen(dev, 7), 1)
    (graphs,) = run.graphs.values()
    assert graphs.step_launches["whitened_factors"] == 2, graphs.step_launches
    assert graphs.step_launches["whitened_factors_bwd"] == 2, graphs.step_launches
    p2, mask2, _, _, _, _, run2, _ = _scan_problem(dev, torch.float32)
    with ck.plain_versions(("whitened_factors", "whitened_factors_bwd")):
        run2(p2, mask2, Z, x, y, idx, _gen(dev, 7), 1)
    (plain,) = run2.graphs.values()
    assert plain.step_launches["whitened_factors"] == plain.step_launches["whitened_factors_bwd"] == 0
    assert graphs.step_kernels is not None and plain.step_kernels is not None
    assert graphs.step_kernels < plain.step_kernels, (graphs.step_kernels, plain.step_kernels)


def test_scan_epochs_replays_draw_anew_from_the_generator(dev):
    """Two replays of the step graph draw different noise, each the draw an
    eager epoch takes from the generator at the same state (the shuffle's
    keys first, then the steps' noise)."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi

    class Recorded(dsvi.EpochDraws):
        def noise(self):
            self.last = super().noise()
            return self.last

    params, mask, Z, x, y, idx, run, _ = _scan_problem(dev, torch.float32)
    draws = Recorded(_gen(dev, 9), 12, 32, 3, torch.float32)
    run(params, mask, Z, x, y, idx, draws, 1)
    (graphs,) = run.graphs.values()
    draws.generator.manual_seed(11)
    graphs.shuffle_graph.replay()
    graphs.step_graph.replay()
    first = draws.last.z_v1.clone()
    graphs.step_graph.replay()
    second = draws.last.z_v1.clone()
    eager = dsvi.EpochDraws(_gen(dev, 11), 12, 32, 3, torch.float32)
    eager.sort_keys(x.shape[0])
    want = [eager.noise().z_v1 for _ in range(2)]
    assert not torch.equal(first, second)
    assert torch.equal(first, want[0]) and torch.equal(second, want[1])


def test_inference_on_the_graph_rolls_back_and_resumes(dev, tmp_path, monkeypatch):
    """`inference()`'s fast path on the card runs through the graphs (their
    launches counted as replays): a rollback of epoch 1 forced once at
    factor 1 gives the unguarded run's losses bit for bit (the parameters,
    the optimizer state and the generator restored in place), and a run
    resumed from a checkpoint starts below 0.7x a fresh start."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import (
        sim_illustration_low_freq,
    )

    X, Y, _, _ = sim_illustration_low_freq(seed=22)
    z = np.linspace(0, 1, 8)
    kw = dict(batch_size=64, dim_outputs=2, lr=0.02, show_ELBO=False, device=dev)
    real, seen = dsvi._diverged, []

    def diverged_at_epoch_1_once(losses, n_before):
        seen.append(n_before)
        return len(seen) == 2 or real(losses, n_before)

    monkeypatch.setattr(dsvi, "_diverged", diverged_at_epoch_1_once)
    ck.reset_launches()
    res = dsvi.inference(X, Y, z, itnum=3, divergence_rollback=True, rollback_lr_factor=1.0, **kw)
    assert sum(ck.REPLAYED.values()) > 0 and ck.REPLAYED["quadform_diag"] > 0
    monkeypatch.setattr(dsvi, "_diverged", real)
    base = dsvi.inference(X, Y, z, itnum=3, **kw)
    assert res.rollbacks == 1 and seen == [0, 4, 4, 8]
    assert res.loss_list == base.loss_list

    path = str(tmp_path / "ckpt.pkl")
    first = dsvi.inference(X, Y, z, itnum=20, PATH=path, save_model=True, **kw)
    resumed = dsvi.inference(X, Y, z, itnum=2, PATH=path, continuous_training=True, **kw)
    assert resumed.loss_list[0] < 0.7 * first.loss_list[0]


@pytest.mark.parametrize("family", ["svc", "snmgp_hadamard"])
def test_prediction_on_the_card_launches_the_kernels(dev, family):
    """`models/prediction.py` on the card: the SVC predictive of 32 draws
    around the study's truth (N = 60) on a 50-point grid, and the
    heterotopic SNMGP predictive on the flat form of the same data; gibbs,
    rbf and cholesky launched, no launch in float64, and the kernels' f32
    draws at most 3x the plain f32 error of float64 + 1e-4 of max, on the
    same noise."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
        prediction as pred,
    )

    N, S, G = 60, 32, 50
    x, l, L_vecs, s2e, Y = sim_mnts(M=2, N=N, seed=3)
    r = np.random.default_rng(4)
    grid = np.linspace(0.0, 1.0, G)
    g = _gen(dev, 31)
    if family == "svc":
        hists = (np.log(l) + 0.05 * r.standard_normal((S, N)),
                 linalg.lvec_to_uvec(torch.as_tensor(L_vecs.reshape(N, 3)), 2).numpy().reshape(-1)
                 + 0.02 * r.standard_normal((S, 3 * N)), np.log(s2e) + 0.05 * r.standard_normal(S))
        noise = pred.SVCNoise(*(torch.randn(*s, device=dev, generator=g)
                                for s in ((S, G), (S, G, 3), (S, G, 2))))

        def run(dtype):
            return pred.svc_predsample(hists, Y, x, grid, mu_tilde_l=-3.0, alpha_tilde_l=3.0,
                                       beta_tilde_l=0.4, noise=noise, dtype=dtype)
    else:
        xf, idx, yf = np.tile(x, 2), np.repeat([0, 1], N), Y.T.reshape(-1)
        tl = np.log(np.tile(l, 2))
        hists = (tl + 0.05 * r.standard_normal((S, 2 * N)), 0.05 * r.standard_normal((S, 2 * N)),
                 np.array([1.5, 0.3, 1.2]) + 0.02 * r.standard_normal((S, 3)),
                 np.log(s2e) + 0.05 * r.standard_normal(S))
        noise = pred.SNMGPNoise(*(torch.randn(*s, device=dev, generator=g)
                                  for s in ((S, G), (S, G), (S, G, 2))))

        def run(dtype):
            return pred.snmgp_hadamard_predsample(hists, xf, idx, yf, 2, grid, mu_tilde_l=-3.0,
                                                  alpha_tilde_l=3.0, beta_tilde_l=0.4,
                                                  beta_tilde_sigma=0.4, noise=noise, dtype=dtype)

    res = {}
    for tag, dtype, plain in (("kernels", torch.float32, False), ("plain", torch.float32, True),
                              ("float64", torch.float64, True)):
        ck.reset_launches()
        with _plain_versions() if plain else ExitStack():
            res[tag] = run(dtype)
        torch.cuda.synchronize()
        launched = dict(ck.LAUNCHES)
        if plain:
            assert sum(launched.values()) == 0, launched
        else:
            assert all(launched[k] > 0 for k in ("gibbs", "rbf", "cholesky")), launched
    assert res["kernels"].shape == (G, S, 2) and bool(torch.isfinite(res["kernels"]).all())
    ref = res["float64"]
    scale = float(ref.abs().max())
    err_k = float((res["kernels"].double() - ref).abs().max())
    err_p = float((res["plain"].double() - ref).abs().max())
    assert err_k <= 3 * err_p + 1e-4 * scale, (err_k, err_p, scale)


def test_run_workload_on_the_card_launches_the_training_kernels(dev, tmp_path):
    """`drivers/run_workload.py` at the PM2.5-sub surrogate's width with M =
    8 and one epoch: the JAX script's keys, finite, every training kernel
    launched."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
        run_workload,
    )

    ck.reset_launches()
    out = run_workload.run(["pm25", "--M", "8", "--itnum", "1", "--batchsize", "2000",
                            "--n-sample", "4"])
    torch.cuda.synchronize()
    assert all(ck.LAUNCHES[k] > 0 for k in TRAIN_KERNELS), dict(ck.LAUNCHES)
    assert out["first_nonfinite_step"] == -1 and out["rollbacks"] == 0
    for k in ("final_loss", "rmse_test", "ci_length", "coverage", "steps_per_s"):
        assert np.isfinite(out[k]), k


@pytest.mark.parametrize("kernel", ["exponential", "rbf"])
def test_baselines_on_the_card_match_plain(dev, kernel):
    """The exact marginal likelihood (n = 100) and the sparse ICM bound (N =
    400, 50 inducing points) with their gradients: cholesky (and rbf)
    launched, the kernels' f32 value and gradient at most 3x the plain f32
    error of float64 + 1e-4 of max."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
        baselines as tb,
    )

    r = np.random.default_rng(5)
    x = np.sort(r.random(400))
    y = np.sin(6 * x) + 0.1 * r.standard_normal(400)
    idx = np.repeat([0, 1], 200)
    theta = np.array([0.1, -1.5, -2.0, 0.5, -0.3, -1.0, -0.7])
    Z = np.linspace(0.01, 0.99, 50)
    kf = tb._KERNELS[kernel]

    def losses(dtype):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
        th = t(theta).requires_grad_(True)
        exact = tb._nlml(th[:3], t(x[:100]), t(y[:100]), kf)
        (bound, *_), _ = tb._sicm_parts(th, t(Z), torch.arange(50, device=dev) % 2, t(x), t(y),
                                        torch.as_tensor(idx, device=dev), 2, 1, kf)
        (g_exact,) = torch.autograd.grad(exact, th)
        (g_bound,) = torch.autograd.grad(bound, th)
        return [exact.detach(), g_exact, bound.detach(), g_bound]

    ck.reset_launches()
    got = losses(torch.float32)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cholesky"] >= 3 and (kernel != "rbf" or ck.LAUNCHES["rbf"] >= 3)
    with _plain_versions():
        plain = losses(torch.float32)
    ref = losses(torch.float64)
    for g, p, w in zip(got, plain, ref):
        err_k = float((g.double() - w).abs().max() / w.abs().max())
        err_p = float((p.double() - w).abs().max() / w.abs().max())
        assert bool(torch.isfinite(g).all()) and err_k <= 3 * err_p + 1e-4, (err_k, err_p)


def test_nccl_world1_mesh_inference_on_the_graph_equals_no_mesh(dev, monkeypatch):
    """`inference(mesh=make_mesh())` on an NCCL group of one rank, the
    gradient all-reduce captured in the step's CUDA graph, gives the losses
    and parameters of the run without a mesh bit for bit (chip_smoke.py's
    multidevice phase (a) at a small width)."""
    import os
    import torch.distributed as dist

    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.launch import (
        free_port,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.mesh import (
        make_mesh,
    )

    monkeypatch.setitem(os.environ, "TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    rng = np.random.default_rng(4)
    X = [np.sort(rng.uniform(0, 10, 120)) for _ in range(3)]
    Y = [np.sin(x) + 0.1 * rng.standard_normal(x.shape) for x in X]
    kw = dict(batch_size=60, dim_outputs=3, lr=0.01, itnum=2, seed=3, show_ELBO=False)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0)
    try:
        ck.reset_launches()
        with_mesh = dsvi.inference(X, Y, np.linspace(0, 10, 12), mesh=make_mesh(), **kw)
        torch.cuda.synchronize()
        replayed = dict(ck.REPLAYED)
        base = dsvi.inference(X, Y, np.linspace(0, 10, 12), **kw)
    finally:
        dist.destroy_process_group()
    assert all(replayed[k] > 0 for k in TRAIN_KERNELS)
    assert with_mesh.loss_list == base.loss_list
    assert all(torch.equal(a, b) for a, b in zip(with_mesh.params, base.params))


def test_gloo_two_ranks_on_the_card(dev):
    """Two gloo ranks on this card (`drivers/multidevice_check.card_ranks`
    at a small width): the data-parallel gradient within 3x the plain
    float32 error + 1e-5 of float64's, the five training kernels launched
    on each rank, the sharded samplers' adaptation equal on both ranks and
    their draws finite."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.launch import (
        spawn,
    )

    r0, r1 = spawn("collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers."
                   "multidevice_check:card_ranks", 2,
                   dict(device="cuda", D=5, M=16, B=64, dp_steps=2, svc_n=16, chees_warmup=8,
                        chees_samples=4, particles=64, smc_n=8, mutations=1, nuts_warmup=3,
                        nuts_samples=2), timeout=600)
    for e in r0["dp"]["grad_errors"].values():
        assert e["dp_kernels"] <= 3 * max(e["plain"]) + 1e-5
    for r in (r0, r1):
        assert all(r["dp"]["grad_launches"][k] > 0 for k in TRAIN_KERNELS)
        assert r["chees"]["finite"] and r["nuts"]["finite"]
    assert r0["dp"]["params_checksum"] == r1["dp"]["params_checksum"]
    assert r0["chees"]["step_size"] == r1["chees"]["step_size"]
    for name, m in r0["smc"]["models"].items():
        assert m["log_z"] == r1["smc"]["models"][name]["log_z"] and m["last_beta"] == 1.0


# ---------------------------------------------------------------------------
# The port's spans and counters on the card (`utils/profiling`)
# ---------------------------------------------------------------------------


def test_a_capture_counts_once(dev):
    """Capturing the trainer's graphs adds 1 to the counter `dsvi.captures`
    and its seconds to `dsvi.capture_s`; a second call on the same tensors
    replays them and adds nothing."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
        profiling,
    )

    params, mask, Z, x, y, idx, run, _ = _scan_problem(dev, torch.float32)
    before = profiling.counters()
    gen = _gen(dev, 3)
    run(params, mask, Z, x, y, idx, gen, 1)
    after = profiling.counters()
    assert after["dsvi.captures"] == before.get("dsvi.captures", 0) + 1
    (graphs,) = run.graphs.values()
    assert after["dsvi.capture_s"] == pytest.approx(before.get("dsvi.capture_s", 0.0)
                                                    + graphs.capture_s)
    run(params, mask, Z, x, y, idx, gen, 1)
    again = profiling.counters()
    assert again["dsvi.captures"] == after["dsvi.captures"]
    assert again["dsvi.capture_s"] == after["dsvi.capture_s"]


def test_a_capture_counts_the_step_graphs_kernels(dev):
    """A capture adds the step graph's kernel nodes to the counter
    `dsvi.step_graph_kernels`, once: more than the port's own launches in
    it, and as many as the kernels the profiler sees in one replay of that
    graph but two (a replay first fills the registered generator's seed and
    offset, two kernels outside the graph); a second call on the same
    tensors adds nothing."""
    from torch.profiler import ProfilerActivity, profile

    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
        profiling,
    )

    params, mask, Z, x, y, idx, run, _ = _scan_problem(dev, torch.float32)
    before = profiling.counters().get("dsvi.step_graph_kernels", 0)
    gen = _gen(dev, 4)
    run(params, mask, Z, x, y, idx, gen, 1)
    (graphs,) = run.graphs.values()
    added = profiling.counters()["dsvi.step_graph_kernels"] - before
    assert added == graphs.step_kernels > sum(graphs.step_launches.values()) > 0
    run(params, mask, Z, x, y, idx, gen, 1)
    assert profiling.counters()["dsvi.step_graph_kernels"] - before == added
    graphs.shuffle_graph.replay()  # the cursor back at the epoch's first batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graphs.step_graph.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    fills = [e for e in kernels if "FillFunctor<long>" in e.name]
    assert len(kernels) == added + 2 and len(fills) >= 2, sorted({e.name for e in kernels})


def test_a_kernel_span_encloses_its_launch(dev):
    """Under the profiler the span `kernel.gibbs` of one `gibbs_cuda` call
    encloses the call's kernel launch on the host, and the kernel starts on
    the card after the span starts: the spans are on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
        profiling,
    )

    g = _gen(dev, 5)
    x1, x2 = torch.rand(256, device=dev, generator=g), torch.rand(100, device=dev, generator=g)
    l1 = torch.exp(0.3 * torch.randn(4, 256, device=dev, generator=g))
    l2 = torch.exp(0.3 * torch.randn(4, 100, device=dev, generator=g))
    ck.gibbs_cuda(x1, x2, l1, l2)  # built and loaded
    torch.cuda.synchronize()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ck.gibbs_cuda(x1, x2, l1, l2)
        torch.cuda.synchronize()
    (span,) = [s for s in profiling.spans() if s.name == "kernel.gibbs"]
    events = prof.profiler.kineto_results.events()
    launches = [e for e in events if e.name().startswith("cudaLaunchKernel")]
    assert launches and all(span.start_ns <= e.start_ns() and e.end_ns() <= span.end_ns
                            for e in launches), (span, [(e.start_ns(), e.end_ns()) for e in launches])
    kernels = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
               and "gibbs_kernel" in e.name()]
    assert len(kernels) == 1 and kernels[0].start_ns() > span.start_ns
