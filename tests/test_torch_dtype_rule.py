"""The port's dispatch rule on the CPU: an op of `ops/` runs its CUDA kernel
for float32 operands on a card within the op's limit (`cuda_kernels._LIMITS`),
and the plain version for float64 or a shape outside it, as the JAX package
takes Pallas only for float32.

No card here, so the rule is made to see "cuda" by patching the one place
it reads a tensor's device type (`cuda_kernels._device_type`), and each
`*_cuda` wrapper is replaced by a stub that records the call and returns
the plain version's result.
"""

from contextlib import ExitStack
from unittest import mock

import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import kernels, kron, linalg

torch.set_num_threads(1)


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_use_kernel_rule():
    f32 = torch.ones(3)
    f64 = torch.ones(3, dtype=torch.float64)

    def no_query(*args, **kwargs):
        raise AssertionError("max_m queried for operands off the card")

    with mock.patch.object(ck, "max_m", no_query):  # off the card no library is built
        for name in ck.KERNELS:
            assert not ck.use_kernel(name, f32)  # a CPU tensor
        assert not ck.use_kernel("whitened_factors", torch.ones(2, 300, 300), f32)
        with mock.patch.object(ck, "_device_type", lambda t: "cuda"):
            assert not ck.use_kernel("whitened_factors", torch.ones(2, 300, 300, dtype=torch.float64))
    assert set(ck._LIMITS) == {"gibbs", "rbf", "whitened_factors"}
    with mock.patch.object(ck, "_device_type", lambda t: "cuda"), \
            mock.patch.object(ck, "max_m", lambda name, device=None, route=None: 8):
        assert ck.use_kernel("kron_mv", f32, f32, 1.5)  # non-tensor operands are not judged
        assert not ck.use_kernel("kron_mv", f64)
        assert not ck.use_kernel("cholesky", f32, f64)
        assert not ck.use_kernel("chol_inv", f32.half())
        # Gibbs: points of dimension <= GIBBS_MAX_DIM
        assert ck.use_kernel("gibbs", torch.ones(5, ck.GIBBS_MAX_DIM), f32, 1.5)
        assert ck.use_kernel("gibbs", torch.ones(5), f32)
        assert not ck.use_kernel("gibbs", torch.ones(5, ck.GIBBS_MAX_DIM + 1), f32)
        # RBF: 1-D inputs
        assert ck.use_kernel("rbf", torch.ones(5), torch.ones(4), 1.0, 1.0)
        assert not ck.use_kernel("rbf", torch.ones(5, 1), torch.ones(4))
        assert not ck.use_kernel("rbf", torch.ones(5), torch.ones(4, 2))
        # the whitened factors: M within both kernels' max_m
        assert ck.use_kernel("whitened_factors", torch.ones(2, 8, 8), torch.ones(1, 8, 8))
        assert not ck.use_kernel("whitened_factors", torch.ones(2, 9, 9), torch.ones(1, 9, 9))
        # every other op has no limit of its own: its wrapper raises above its max_m
        assert ck.use_kernel("quadform_diag", torch.ones(9, 4), torch.ones(2, 9, 9))
    with mock.patch.object(ck, "_device_type", lambda t: "meta"):
        assert not ck.use_kernel("gibbs", f32)
    assert ck.pick("gibbs", f32) is ck.gibbs_plain


def _inputs(dtype, d=1):
    r = np.random.default_rng(0)
    M, N, G = 6, 9, 3
    A = r.standard_normal((M, N))
    K = A @ A.T / N + np.eye(M)
    W = np.tril(r.standard_normal((G, M, M)))
    x1 = np.sort(r.random((N, d)), axis=0) if d > 1 else np.sort(r.random(N))
    x2 = np.sort(r.random((M, d)), axis=0) if d > 1 else np.sort(r.random(M))
    ell1, ell2 = np.exp(0.2 * r.standard_normal(N)), np.exp(0.2 * r.standard_normal(M))
    B, Kk, y = r.standard_normal((2, 2)), r.standard_normal((N, N)), r.standard_normal(2 * N)
    X, Lw = r.standard_normal((G, M, M)), np.tril(r.standard_normal((1, M, M))) + 2 * np.eye(M)
    return {k: _t(v, dtype).requires_grad_(True) for k, v in dict(
        A=A, K=K, W=W, x1=x1, x2=x2, ell1=ell1, ell2=ell2, B=B, Kk=Kk, y=y, X=X, Lw=Lw).items()}


# each op of ops/ that has a kernel: (the wrappers its forward and backward
# call, a function of the inputs whose backward reaches them)
CALL_SITES = {
    "cholesky": (("cholesky",), lambda p: linalg.cholesky(p["K"])),
    "chol_tri_inv": (("chol_inv",), lambda p: linalg.chol_tri_inv(p["K"])[1]),
    "quadform": (("quadform_diag", "quadform_diag_bwd"),
                 lambda p: linalg._quadform_diag(p["A"], p["W"])),
    "gibbs": (("gibbs",), lambda p: kernels.gibbs(p["x1"], p["x2"], p["ell1"], p["ell2"], 1.3)),
    "rbf": (("rbf",), lambda p: kernels.rbf(p["x1"], p["x2"], 1.3, 0.4)),
    "kron_mv": (("kron_mv",), lambda p: kron.kron_mv(p["B"], p["Kk"], p["y"])),
    "whitened_factors": (("whitened_factors", "whitened_factors_bwd"), lambda p: _whitened(p)),
}


def _whitened(p):
    """Every output of `whitened_factors` on two group sets, flattened (the
    KL pieces included)."""
    wf = linalg.whitened_factors(p["X"], (p["Lw"], p["Lw"]), (2, 1), 1e-4)
    return torch.cat([t.flatten() for t in wf.W + wf.trace + wf.logdet_q])


def _run(site, dtype, d=1, bwd_max_m=512):
    """Run a call site forward and backward with the rule seeing "cuda" and
    the fused quadform backward taking M up to `bwd_max_m`; returns (the
    wrappers called, the output, the gradients)."""
    calls = []
    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(ck, "_device_type", lambda t: "cuda"))
        stack.enter_context(mock.patch.object(
            ck, "max_m", lambda name, device=None, route=None: bwd_max_m))
        for name in ck.KERNELS:
            plain = getattr(ck, f"{name}_plain")

            def stub(*args, _name=name, _plain=plain):
                calls.append(_name)
                return _plain(*args)

            stack.enter_context(mock.patch.object(ck, f"{name}_cuda", stub))
        p = _inputs(dtype, d)
        out = CALL_SITES[site][1](p)
        out.sum().backward()
    return calls, out.detach(), [t.grad for t in p.values() if t.grad is not None]


@pytest.mark.parametrize("site", sorted(CALL_SITES))
def test_float32_on_the_card_takes_the_kernels(site):
    calls, out, _ = _run(site, torch.float32)
    assert set(calls) == set(CALL_SITES[site][0]), calls
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.parametrize("site", sorted(CALL_SITES))
def test_float64_on_the_card_takes_the_plain_versions(site):
    calls, out, grads = _run(site, torch.float64)
    assert calls == []
    assert out.dtype == torch.float64 and torch.isfinite(out).all()
    # the same values as off the card, where the wrappers return the plain versions
    p = _inputs(torch.float64)
    want = CALL_SITES[site][1](p)
    want.sum().backward()
    assert torch.equal(out, want.detach())
    for g, w in zip(grads, [t.grad for t in p.values() if t.grad is not None]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("site, d", [("gibbs", 5), ("rbf", 2)])
def test_inputs_the_kernels_do_not_take_go_to_the_plain_versions(site, d):
    """Gibbs inputs of dimension above 4 and 2-D RBF inputs, which the JAX
    functions take: float32 on the card, and still no kernel."""
    calls, out, grads = _run(site, torch.float32, d)
    assert calls == [] and torch.isfinite(out).all()
    assert grads and all(torch.isfinite(g).all() for g in grads)
    calls, _, _ = _run(site, torch.float32, ck.GIBBS_MAX_DIM if site == "gibbs" else 1)
    assert calls == [site]


def test_whitened_factors_above_max_m_take_the_plain_route():
    """Float32 on the card at M = 6 above a `max_m` of 5: the plain version
    under autograd, its KL pieces included, and no kernel."""
    before = dict(ck.LAUNCHES)
    calls, out, grads = _run("whitened_factors", torch.float32, bwd_max_m=5)
    assert calls == [] and ck.LAUNCHES == before
    p = _inputs(torch.float32)
    Ws, traces, logdets = ck.whitened_factors_plain(p["X"], (p["Lw"], p["Lw"]), (2, 1), 1e-4)
    assert len(traces) == len(logdets) == 2
    assert torch.equal(out, torch.cat([t.detach().flatten() for t in Ws + traces + logdets]))
    assert grads and all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("grads, bwd_max_m, kernels", [
    (("A", "W"), 512, ("quadform_diag", "quadform_diag_bwd")),
    (("A", "W"), 5, ("quadform_diag", "quadform_diag_dw", "quadform_diag_da")),
    (("A",), 512, ("quadform_diag", "quadform_diag_da")),
    (("W",), 512, ("quadform_diag", "quadform_diag_dw")),
])
def test_quadform_backward_routes(grads, bwd_max_m, kernels):
    """Float32 on the card: both gradients take the fused backward kernel up
    to its largest M (here M = 6, N = 9, G = 3), and the pair 6b/6c above
    it; one gradient alone takes its own kernel."""
    calls = []
    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(ck, "_device_type", lambda t: "cuda"))
        stack.enter_context(mock.patch.object(
            ck, "max_m", lambda name, device=None, route=None: bwd_max_m))
        for name in ck.KERNELS:
            def stub(*args, _name=name, _plain=getattr(ck, f"{name}_plain")):
                calls.append(_name)
                return _plain(*args)

            stack.enter_context(mock.patch.object(ck, f"{name}_cuda", stub))
        p = _inputs(torch.float32)
        A = p["A"].detach().requires_grad_("A" in grads)
        W = p["W"].detach().requires_grad_("W" in grads)
        linalg._quadform_diag(A, W).sum().backward()
    assert sorted(calls) == sorted(kernels), calls
    assert all(torch.isfinite(t.grad).all() for t in (A, W) if t.requires_grad)


@pytest.mark.parametrize("shape, route", [
    ((100, 512, 3003), "fused"), ((100, 256, 3003), "fused"), ((100, 2000, 15), "fused"),
    ((100, 1000, 105), "pair"), ((100, 1000, 3003), "pair"), ((200, 512, 3003), "pair"),
    ((120, 512, 1), "pair"), ((112, 512, 78), "fused"),
])
def test_quadform_backward_route_rule(shape, route):
    """The measured rule on (G, M, N): the fused kernel up to M = 112 where N
    fits one cluster (512) or G <= 15, the pair elsewhere (meta tensors:
    only shapes are read)."""
    m, n, g = shape
    A = torch.empty(m, n, device="meta")
    W = torch.empty(g, m, m, device="meta")
    with mock.patch.object(ck, "max_m", lambda name, device=None, route=None: 208):
        assert ck.quadform_bwd_route(A, W) == route
