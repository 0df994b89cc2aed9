"""The port's CUDA kernels against their plain versions, on a CUDA card.

These tests need the card and skip without one.  They import neither JAX
nor the JAX package, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

from contextlib import ExitStack
from unittest import mock

import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


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
     (1, "max", 65, 3)],
)
def test_quadform_backward_kernels_match_plain(dev, S, M, N, G):
    """dW (lower triangle, zeros above) and dA against the plain versions,
    ragged N tiles and the largest M included; sums of M products of N
    terms, in another order, so 1e-4 of max."""
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
    """loss.backward() through all five kernels against the plain versions
    on the same noise and batch.  Both float32 runs are held against a
    float64 run of the plain versions: the kernels may be at most 3x as far
    off as the plain versions, + 1e-5 of max (f32 through the prior
    factorization)."""
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
    noise = cnmgp.draw_train_noise(g, 1, M, B, D)

    def grads(dtype):
        p = cnmgp.CNMGPParams(*(t.detach().to(dtype).clone().requires_grad_(True) for t in params))
        nz = cnmgp.CNMGPNoise(*(None if z is None else z.to(dtype) for z in noise))
        loss = cnmgp.negative_selbo(p, Z.to(dtype), x.to(dtype), y.to(dtype), idx, w.to(dtype),
                                    1000.0, nz)
        loss.backward()
        return [t.grad for t in p]

    ck.reset_launches()
    g_kernel = grads(torch.float32)
    torch.cuda.synchronize()
    assert all(ck.LAUNCHES[k] > 0 for k in ck.KERNELS), ck.LAUNCHES
    with _plain_versions():
        g_plain = grads(torch.float32)
        g_64 = grads(torch.float64)
    for name, gk, gp, g64 in zip(cnmgp.CNMGPParams._fields, g_kernel, g_plain, g_64):
        scale = float(g64.abs().max())
        err_k = float((gk.double() - g64).abs().max())
        err_p = float((gp.double() - g64).abs().max())
        assert err_k <= 3 * err_p + 1e-5 * scale, (name, err_k, err_p, scale)
