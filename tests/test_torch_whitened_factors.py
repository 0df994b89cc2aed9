"""The whitened coefficient factors (`linalg.whitened_factors`) on the CPU in
float64.

Off the card `whitened_factors` is the kernels' plain version under
autograd (`cuda_kernels.whitened_factors_plain`): the composition of ops,
`tril_regularized` on the whole parameter, its slices, one matmul a group
set, with the KL's trace and log-determinant.  On the card it is
`_WhitenedFactors`, a `torch.autograd.Function` over two kernels whose
plain versions (that composition, and `whitened_factors_bwd_plain`, its
vector-Jacobian product by autograd) `cuda_kernels.plain_versions` puts in
their place; here that Function runs through them, held against the
composition, values and gradients, then inside `negative_selbo`.
"""

import math

import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import linalg

torch.set_num_threads(1)
F64 = torch.float64
JITTER = 1e-4


def _fused(X, Lp_invs, sizes, jitter=JITTER):
    """`whitened_factors` on the kernels' route, whatever the device."""
    sizes = tuple(sizes)
    k = len(sizes)
    out = linalg._WhitenedFactors.apply(X, jitter, sizes, *Lp_invs)
    return linalg.WhitenedFactors(out[:k], out[k:2 * k], out[2 * k:])


@pytest.fixture
def plain_kernels():
    """The Function's two kernels replaced by their plain versions while a
    test runs, its backward included."""
    with ck.plain_versions(("whitened_factors", "whitened_factors_bwd")):
        yield


def _close(a, b, tol=1e-12):
    """max |a - b| <= tol * max |b|, NaN where the other has NaN."""
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    a, b = torch.nan_to_num(a), torch.nan_to_num(b)
    assert float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1e-300)


def _problem(S, D, M=7, N=9, seed=0):
    """sqrt_U-shaped X (G, M, M), the prior stack K (S, 2, M, M) whose
    inverse factors the two group sets take, A (S, M, N) and weights of the
    outputs in a scalar loss."""
    g = torch.Generator().manual_seed(seed)
    G = D * (D + 1) // 2
    X = 0.3 * torch.randn(G, M, M, generator=g, dtype=F64)
    B = torch.randn(S, 2, M, M, generator=g, dtype=F64)
    K = B @ B.mT / M + 0.5 * torch.eye(M, dtype=F64)
    A = torch.randn(S, M, N, generator=g, dtype=F64)
    weights = [torch.randn(S, G, N, generator=g, dtype=F64), torch.randn(S, G, generator=g, dtype=F64),
               torch.randn(G, generator=g, dtype=F64)]
    return X, K, A, weights


def _loss(route, X, K, A, weights, sizes, kl=True):
    """sum over the sets of weighted quadform variances (the downstream use
    of W), traces and log-determinants; the sets' factors from K by
    `chol_tri_inv`.  `route` "composed": today's composition; "fused": the
    Function."""
    Lp_inv = linalg.chol_tri_inv(K)[1]
    Ps = tuple(Lp_inv[:, k] for k in range(len(sizes)))
    if route == "fused":
        wf = _fused(X, Ps, sizes)
        Ws, traces, logdets = wf.W, wf.trace, wf.logdet_q
    else:
        Ws = linalg.whiten(linalg.tril_regularized(X, JITTER), Ps, sizes)
        traces = tuple(torch.sum(W * W, dim=(-2, -1)) for W in Ws)
        logdets, start = [], 0
        for n in sizes:
            dq = linalg.regularized_diag(X[start:start + n], JITTER)
            logdets.append(torch.sum(torch.log(torch.abs(dq)), dim=-1))
            start += n
    total, start = 0.0, 0
    for W, tr, ld, n in zip(Ws, traces, logdets, sizes):
        cut = slice(start, start + n)
        if n:
            total = total + torch.sum(weights[0][:, cut] * linalg._quadform_diag(A, W))
            if kl:
                total = total + torch.sum(weights[1][:, cut] * tr) + torch.sum(weights[2][cut] * ld)
        start += n
    return total, Ws, traces, logdets


def _grads(route, X, K, A, weights, sizes, kl=True):
    X, K, A = (t.detach().clone().requires_grad_(True) for t in (X, K, A))
    total, Ws, traces, logdets = _loss(route, X, K, A, weights, sizes, kl)
    total.backward()
    outs = [*Ws, *traces, *logdets]
    return total.detach(), [t.detach() for t in outs], X.grad, K.grad, A.grad


@pytest.mark.usefixtures("plain_kernels")
@pytest.mark.parametrize("S, D", [(1, 4), (3, 4), (1, 1), (3, 1)])
def test_the_function_matches_the_composition(S, D):
    """Two group sets (D = 4: 6 offdiagonal, 4 diagonal; D = 1: none and
    one), one and three draws: every output, and the gradients of X, of the
    prior K behind Lp^-1 and of the quadform's A, to 1e-12."""
    X, K, A, weights = _problem(S, D)
    sizes = (D * (D - 1) // 2, D)
    got = _grads("fused", X, K, A, weights, sizes)
    want = _grads("composed", X, K, A, weights, sizes)
    _close(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        if b.numel():
            _close(a, b)
    for a, b in zip(got[2:], want[2:]):
        _close(a, b)


@pytest.mark.usefixtures("plain_kernels")
def test_one_set_as_sqrt_W_takes_it():
    """sqrt_W's one set of D groups with the Gibbs prior's factor."""
    X, K, A, weights = _problem(2, 3, seed=1)
    X = X[:3]
    weights = [weights[0][:, :3], weights[1][:, :3], weights[2][:3]]
    got = _grads("fused", X, K[:, :1], A, weights, (3,))
    want = _grads("composed", X, K[:, :1], A, weights, (3,))
    for a, b in zip(got[:1] + got[2:], want[:1] + want[2:]):
        _close(a, b)


@pytest.mark.usefixtures("plain_kernels")
def test_the_prior_factors_gradient_is_whole():
    """Lp^-1's gradient from the Function is the composition's, its strict
    upper part included (it moves K's gradient through the rounding of the
    Cholesky-inverse backward)."""
    X, K, A, weights = _problem(2, 4, seed=2)
    sizes = (6, 4)
    grads = {}
    for route in ("fused", "composed"):
        Lp_inv = linalg.chol_tri_inv(K)[1].detach().requires_grad_(True)
        Ps = (Lp_inv[:, 0], Lp_inv[:, 1])
        if route == "fused":
            Ws = _fused(X, Ps, sizes).W
        else:
            Ws = linalg.whiten(linalg.tril_regularized(X, JITTER), Ps, sizes)
        sum(torch.sum(linalg._quadform_diag(A, W)) for W in Ws).backward()
        grads[route] = Lp_inv.grad
    assert float(grads["composed"].triu(1).abs().max()) > 0
    _close(grads["fused"], grads["composed"])


@pytest.mark.usefixtures("plain_kernels")
def test_a_nan_above_the_diagonal_and_a_zero_diagonal_entry():
    """A NaN strictly above X's diagonal turns W's column and the set's
    trace NaN on both routes, as the mask multiply does; a zero diagonal
    entry is regularized to +sqrt(jitter) with a zero derivative."""
    X, K, A, weights = _problem(1, 3, seed=3)
    X[0, 1, 4] = math.nan
    X[4, 2, 2] = 0.0
    sizes = (3, 3)
    got = _grads("fused", X, K, A, weights, sizes)
    want = _grads("composed", X, K, A, weights, sizes)
    W_off = got[1][0]
    assert torch.isnan(W_off[0, 0, :, 4]).all() and torch.isfinite(W_off[0, 1:]).all()
    assert torch.isnan(got[1][2][0, 0]) and torch.isfinite(got[1][3]).all()
    for a, b in zip(got[1], want[1]):
        _close(a, b)
    X[0, 1, 4] = 0.0
    got = _grads("fused", X, K, A, weights, sizes)
    want = _grads("composed", X, K, A, weights, sizes)
    assert torch.isfinite(got[2]).all()
    for a, b in zip(got[2:], want[2:]):
        _close(a, b)


@pytest.mark.usefixtures("plain_kernels")
def test_without_the_kl_cotangents():
    """A data-parallel shard without the KL: only W's cotangent reaches the
    backward (the traces' and log-determinants' are None)."""
    X, K, A, weights = _problem(1, 4, seed=4)
    got = _grads("fused", X, K, A, weights, (6, 4), kl=False)
    want = _grads("composed", X, K, A, weights, (6, 4), kl=False)
    for a, b in zip(got[2:], want[2:]):
        _close(a, b)


def test_the_cpu_and_float64_take_the_composition(monkeypatch):
    """Off the card `whitened_factors` is the composition with its KL pieces
    (W, ||W||^2, sum log |diag|, to 1e-12) and never the Function;
    `kl_mode="ref_compat"` does not call it at all."""
    def refuse(*args, **kwargs):
        raise AssertionError("called off the card or in ref_compat")

    X, K, _, _ = _problem(1, 3, seed=5)
    Lp_inv = linalg.chol_tri_inv(K)[1]
    with monkeypatch.context() as m:
        m.setattr(linalg._WhitenedFactors, "apply", refuse)
        wf = linalg.whitened_factors(X, (Lp_inv[:, 0], Lp_inv[:, 1]), (3, 3), JITTER)
    T = linalg.tril_regularized(X, JITTER)
    for k, cut in enumerate((slice(0, 3), slice(3, 6))):
        W = torch.matmul(Lp_inv[:, k][:, None], T[cut])
        _close(wf.W[k], W)
        _close(wf.trace[k], torch.sum(W * W, dim=(-2, -1)))
        _close(wf.logdet_q[k], torch.sum(torch.log(torch.abs(torch.diagonal(
            T[cut], dim1=-2, dim2=-1))), dim=-1))
    params, Z, x, y, idx, w, noise = _ecog_cut(5)
    monkeypatch.setattr(cnmgp, "whitened_factors", refuse)
    loss = cnmgp.negative_selbo(params, Z, x, y, idx, w, 1000.0, noise, JITTER, "ref_compat")
    assert torch.isfinite(loss)


# portbench/configs/ecog-m100.json's log variances; length scales e^4 on its
# time axis.  Its own frozen length scales (e^5, e^10) make the prior grams
# nearly all ones (condition ~1e4-1e5), which turns any reordering of the
# sums over groups (float64 rounding, 1e-16) into 1e-12 - 1e-10 in the
# variance logs' gradients through the Cholesky-inverse backward.
LOGS = {"sigma2_tildeell_log": 0.0, "length_scales_tildeell_log": 4.0, "sigma2_L0_log": 0.0,
        "length_scales_L0_log": 4.0, "sigma2_L1_log": 0.0, "length_scales_L1_log": 4.0,
        "sigma2_err_log": -5.0}


def _ecog_cut(seed, D=5, M=10, B=24):
    """ECoG's model cut to D = 5 outputs (15 coefficient groups), M = 10,
    B = 24, at `LOGS` and mu_v = 1: parameters with gradients, inducing
    points, a batch, one draw."""
    g = torch.Generator().manual_seed(seed)
    params = cnmgp.init_params(g, D, M, dtype=F64, device="cpu")
    params = params._replace(mu_v=torch.ones(M, dtype=F64),
                             **{k: torch.tensor(v, dtype=F64) for k, v in LOGS.items()})
    params = cnmgp.CNMGPParams(*(t.clone().requires_grad_(True) for t in params))
    Z = torch.linspace(0.0, 800.0, M, dtype=F64)
    x = torch.sort(800.0 * torch.rand(B, generator=g, dtype=F64)).values
    y = torch.sin(x / 40.0)
    idx = torch.randint(0, D, (B,), generator=g)
    w = torch.ones(B, dtype=F64)
    noise = cnmgp.draw_train_noise(g, 1, M, B, D, dtype=F64)
    return params, Z, x, y, idx, w, noise


@pytest.mark.usefixtures("plain_kernels")
@pytest.mark.parametrize("with_kl", [True, False])
def test_negative_selbo_on_either_route(monkeypatch, with_kl):
    """negative_selbo's loss and every leaf's gradient after the training
    step's sanitising (non-finite to 0, the freeze mask) at a tiny ECoG cut:
    the Function's route against the composition's, to 1e-12."""
    out = {}
    for route in ("composed", "fused"):
        params, Z, x, y, idx, w, noise = _ecog_cut(6)
        with monkeypatch.context() as m:
            if route == "fused":
                m.setattr(cnmgp, "whitened_factors", _fused)
            loss = cnmgp.negative_selbo(params, Z, x, y, idx, w, 62400.0, noise, JITTER,
                                        with_kl=with_kl)
            loss.backward()
        grads = [torch.where(torch.isfinite(p.grad), p.grad, 0.0) * mk
                 for p, mk in zip(params, dsvi.freeze_mask(params, False))]
        out[route] = (loss.detach(), grads)
    _close(out["fused"][0], out["composed"][0])
    for name, a, b in zip(cnmgp.CNMGPParams._fields, out["fused"][1], out["composed"][1]):
        assert float(b.abs().max()) > 0, name
        _close(a, b)


def test_the_wrappers_return_the_plain_versions_for_cpu_tensors():
    """`pick` gives CPU tensors, float32 too, the plain versions, as it does
    for every op of `cuda_kernels`, and the kernel wrappers refuse them;
    both are counted kernels."""
    assert {"whitened_factors", "whitened_factors_bwd"} <= set(ck.KERNELS)
    X, K, _, _ = _problem(2, 3, seed=7)
    Ps = tuple(linalg.chol_tri_inv(K)[1].unbind(1))
    before = dict(ck.LAUNCHES)
    for dtype in (F64, torch.float32):
        X, Ps = X.to(dtype), tuple(P.to(dtype) for P in Ps)
        assert ck.pick("whitened_factors", X, *Ps) is ck.whitened_factors_plain
        got = ck.pick("whitened_factors", X, *Ps)(X, Ps, (3, 3), JITTER)
        want = ck.whitened_factors_plain(X, Ps, (3, 3), JITTER)
        for a, b in zip(got, want):
            assert all(torch.equal(u, v) for u, v in zip(a, b))
        for wrapper, extra in ((ck.whitened_factors_cuda, ()),
                               (ck.whitened_factors_bwd_cuda, (got[0], got[0], got[1], got[2]))):
            with pytest.raises(TypeError, match="CUDA float32"):
                wrapper(X, Ps, (3, 3), JITTER, *extra)
    assert ck.LAUNCHES == before
