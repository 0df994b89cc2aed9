"""The fused Cholesky + triangular inverse on the CPU: the choice between
the two routes of `csrc/chol_inv.cu` (the whole matrix resident in one CTA
below the measured crossover, many CTAs per matrix from it on), which the
wrapper makes on the host; the plain version `pick` gives a CPU tensor; and
the port's differentiable `ops.linalg.chol_tri_inv` against the JAX
`chol_tri_inv` in float64 (rtol 1e-10 on values, 1e-8 on gradients, each
with an atol of that fraction of max) on the
grams of the path: stationary RBF priors on the inducing grid and a Gibbs
gram, + jitter, a member that is not positive-definite included (NaN in L's
lower triangle and in all of L^-1, the others unchanged).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import linalg as jl
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import linalg as tl
from torch_port_helpers import assert_close

torch.set_num_threads(1)
JITTER = 1e-4


def test_chol_inv_route_follows_the_measured_crossover():
    x = ck.CHOL_INV_CROSSOVER_M
    assert set(ck.CHOL_INV_ROUTES) == {"resident", "multi_cta"}
    assert ck.chol_inv_route(x - 1) == "resident" and ck.chol_inv_route(x) == "multi_cta"
    assert ck.chol_inv_route(1) == "resident" and ck.chol_inv_route(4096) == "multi_cta"
    assert ck.chol_inv_route(12, "multi_cta") == "multi_cta"
    assert ck.chol_inv_route(4096, "resident") == "resident"
    with pytest.raises(ValueError):
        ck.chol_inv_route(100, "one_block")


@pytest.mark.parametrize("route", [None, "resident", "multi_cta"])
def test_chol_inv_wrapper_takes_the_plain_version_on_cpu(route):
    r = np.random.default_rng(1)
    A = r.standard_normal((3, 9, 9))
    K = torch.as_tensor(A @ A.transpose(0, 2, 1) / 9 + 0.5 * np.eye(9), dtype=torch.float32)
    before = dict(ck.LAUNCHES)
    assert ck.pick("chol_inv", K) is ck.chol_inv_plain
    L, Linv = ck.pick("chol_inv", K)(K, route)
    L_ref, Linv_ref = ck.chol_inv_plain(K, route)
    assert torch.equal(L, L_ref) and torch.equal(Linv, Linv_ref)
    with pytest.raises(TypeError, match="CUDA float32"):
        ck.chol_inv_cuda(K, route)
    assert ck.LAUNCHES == before


def _path_grams(r, batch, m):
    """`batch` grams on the inducing grid of the path, as the model's prior
    stack builds them: stationary RBF priors (lengthscales 0.05-0.1 of the
    span) and a Gibbs gram with log-normal lengthscales, each + jitter."""
    z = np.linspace(0.0, 1.0, m)
    d2 = (z[:, None] - z[None, :]) ** 2
    grams = []
    for b in range(batch):
        if b % 4 == 3:
            ell = np.exp(-2.0 + 0.3 * r.standard_normal(m))
            s = ell[:, None] ** 2 + ell[None, :] ** 2
            K = np.sqrt(2.0 * np.outer(ell, ell) / s) * np.exp(-d2 / s)
        else:
            ls = r.uniform(0.05, 0.1)
            K = np.exp(-0.5 * d2 / ls**2)
        grams.append(K + JITTER * np.eye(m))
    return np.stack(grams)


@pytest.mark.parametrize("batch, m, non_pd", [(4, 100, False), (32, 12, False), (4, 200, True)])
def test_chol_tri_inv_matches_jax_in_float64(batch, m, non_pd):
    r = np.random.default_rng(batch * m)
    K = _path_grams(r, batch, m)
    if non_pd:
        K[2] -= 10.0 * np.eye(m)  # member 2 is not PD
    L, Linv = tl.chol_tri_inv(torch.as_tensor(K))
    L_ref, Linv_ref = (np.asarray(t) for t in jl.chol_tri_inv(jnp.asarray(K)))
    good = [b for b in range(batch) if not (non_pd and b == 2)]
    # atol 1e-10 of max: the small entries of L^-1 (condition ~1e4 at M = 200),
    # which the two LAPACK solves sum in another order
    for got, want in ((L[good], L_ref[good]), (Linv[good], Linv_ref[good])):
        assert_close(got, want, rtol=1e-10, atol=1e-10 * float(np.abs(want).max()))
    assert torch.equal(L[good], L[good].tril()) and torch.equal(Linv[good], Linv[good].tril())
    if non_pd:
        lower = np.tril(np.ones((m, m), dtype=bool))
        assert np.isnan(L_ref[2][lower]).all() and np.isnan(Linv_ref[2]).all()
        assert torch.isnan(L[2][torch.as_tensor(lower)]).all() and (L[2].triu(1) == 0).all()
        assert torch.isnan(Linv[2]).all()
        assert torch.isfinite(L[good]).all() and torch.isfinite(Linv[good]).all()

    # gradients of a weighted sum of both outputs, over the PD members
    W1, W2 = r.standard_normal((2, len(good), m, m))
    Kt = torch.tensor(K[good], requires_grad=True)
    Lt, Linvt = tl.chol_tri_inv(Kt)
    g = torch.autograd.grad((torch.as_tensor(W1) * Lt).sum() + (torch.as_tensor(W2) * Linvt).sum(),
                            Kt)[0]

    def f(Kj):
        Lj, Linvj = jl.chol_tri_inv(Kj)
        return jnp.sum(W1 * Lj) + jnp.sum(W2 * Linvj)

    g_ref = np.asarray(jax.grad(f)(jnp.asarray(K[good])))
    assert_close(g, g_ref, rtol=1e-8, atol=1e-8 * float(np.abs(g_ref).max()))


# Log variances of the tilde_ell prior gram at the HCP width (Z on
# linspace(0, 4799, 100), length scale e^5, + JITTER): as rounded to float32
# the grams are positive-definite through e^6.5 on the CPU (condition up to
# ~2e8, above float32's 1/eps, so float32 factorizations fail on some of
# them) and indefinite at e^8.
TRAINED_S2_LOGS = (5.0, 5.8, 6.0, 6.2, 6.4, 6.5, 8.0)


def _trained_prior_grams():
    z = np.linspace(0.0, 4799.0, 100).astype(np.float32)
    d2 = torch.as_tensor((z[:, None] - z[None, :]) ** 2)
    ls = torch.exp(torch.tensor(5.0))
    return torch.stack([torch.exp(torch.tensor(s, dtype=torch.float32))
                        * torch.exp(-d2 * (0.5 / (ls * ls))) + JITTER * torch.eye(100)
                        for s in TRAINED_S2_LOGS])


def test_chol_inv_plain_refactors_a_float32_failure_in_float64():
    """A float32 member whose float32 factorization fails and whose float64
    one does not gets the float64 factor rounded to float32, and L^-1 solved
    from it in float32, where the JAX f32 `chol_tri_inv` gives NaN; the
    factor equals the JAX float64 factor of the same float32 input (rtol
    1e-6 of max: float32's rounding of either float64 factor).  The other
    members keep their float32 factor.  A member
    that fails in float64 too stays NaN.  On the multi-CTA route, which
    does not refactor, a float32 failure stays NaN."""
    K = _trained_prior_grams()
    L, Linv = ck.chol_inv_plain(K)
    f32_failed = torch.linalg.cholesky_ex(K)[1] != 0
    L_jax32 = np.asarray(jl.chol_tri_inv(jnp.asarray(K.numpy()))[0])
    L_jax64 = np.asarray(jl.chol_tri_inv(jnp.asarray(K.double().numpy()))[0])
    pd = np.isfinite(L_jax64).all(axis=(1, 2))
    assert pd[0] and not pd[-1]
    assert (f32_failed.numpy() & pd).any() and (~np.isfinite(L_jax32).all(axis=(1, 2)) & pd).any()
    assert torch.isfinite(L[pd]).all() and torch.isfinite(Linv[pd]).all()
    rescued = f32_failed.numpy() & pd
    assert_close(L[rescued], L_jax64[rescued].astype(np.float32), rtol=1e-6,
                 atol=1e-6 * float(np.abs(L_jax64[rescued]).max()))
    kept = ~f32_failed
    assert torch.equal(L[kept], torch.linalg.cholesky_ex(K[kept])[0])
    eye = torch.eye(100)
    assert torch.equal(Linv[pd], torch.linalg.solve_triangular(L[pd], eye.expand(int(pd.sum()), -1, -1),
                                                               upper=False))
    lower = torch.ones(100, 100, dtype=torch.bool).tril()
    assert torch.isnan(L[-1][lower]).all() and (L[-1][~lower] == 0).all()
    assert torch.isnan(Linv[-1]).all()
    L_multi, _ = ck.chol_inv_plain(K, "multi_cta")
    assert torch.equal(torch.isnan(L_multi).flatten(1).any(1), f32_failed)
