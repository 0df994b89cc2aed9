"""The port's stochastic ELBO and the gradients of its differentiable
primitives against the JAX package, in float64 on the CPU.

The port is fed the noise the JAX key gives (`jax_train_noise`).  Values
agree to rtol 1e-10 and gradients to rtol 1e-8 (the same arithmetic in
another order; ROADMAP.md).  Gradient entries also get an atol of 1e-10 of
their parameter's largest gradient: an entry that is a sum cancelling far
below its parameter's scale keeps an absolute rounding error of that scale,
not of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import cnmgp as jc
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import kernels as jk
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import linalg as jl
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp as tc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import kernels as tk
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import linalg as tl
from torch_port_helpers import (
    assert_close,
    jax_init_params,
    jax_train_noise,
    jax_value_and_grad,
    run_jax,
)

torch.set_num_threads(1)
M_IND, B, N_TOTAL, JITTER = 8, 24, 100.0, 1e-4


def _problem(D, seed):
    """JAX-initialised parameters with lengthscales that make every prior
    gram dense, a batch of B inputs whose last row is padding (weight 0),
    and a key."""
    r = np.random.default_rng(seed)
    p = jax_init_params(seed, D, M_IND)
    p = p._replace(
        mu_v=jnp.asarray(-1.5 + 0.2 * r.standard_normal(M_IND)),
        length_scales_tildeell_log=jnp.asarray(-1.5),
        length_scales_L0_log=jnp.asarray(-1.2),
        length_scales_L1_log=jnp.asarray(-1.0),
    )
    x = np.sort(r.random(B))
    idx = r.integers(0, D, B)
    y = np.sin(6 * x) + 0.1 * r.standard_normal(B)
    w = np.ones(B)
    x[-1], idx[-1], y[-1], w[-1] = 0.0, 0, 0.0, 0.0
    return p, np.linspace(0.0, 1.0, M_IND), x, y, idx, w, jax.random.PRNGKey(seed)


def _port_params(p):
    return tc.CNMGPParams(*(torch.tensor(np.array(a), requires_grad=True) for a in p))


def _jax_loss_true(p, Z, x, y, idx, w, key):
    return jc.negative_selbo(p, Z, x, y, idx, w, N_TOTAL, key, JITTER, "true")


def _jax_loss_ref_compat(p, Z, x, y, idx, w, key):
    return jc.negative_selbo(p, Z, x, y, idx, w, N_TOTAL, key, JITTER, "ref_compat")


JAX_LOSS = {"true": _jax_loss_true, "ref_compat": _jax_loss_ref_compat}


def assert_grad_close(got, want, rtol=1e-8):
    want = np.asarray(want)
    assert_close(got, want, rtol=rtol, atol=1e-10 * max(np.abs(want).max(), 1e-300))


def test_init_params_overrides_match_jax():
    """Given arrays, packed and dense (D, D, ...) coefficient tables, and
    sqrt_scale: the port's `init_params` carries them as the JAX one does."""
    D, M = 3, 5
    r = np.random.default_rng(0)
    given = dict(
        mu_v=r.standard_normal(M), mu_W=r.standard_normal((D, M)),
        mu_U=r.standard_normal((D, D, M)), sqrt_v=r.standard_normal((M, M)),
        sqrt_W=r.standard_normal((D, M, M)), sqrt_U=r.standard_normal((D * (D + 1) // 2, M, M)),
    )
    want = jc.init_params(jax.random.PRNGKey(0), D, M, dtype=jnp.float64, **given)
    got = tc.init_params(torch.Generator().manual_seed(0), D, M, dtype=torch.float64,
                         device="cpu", **given)
    for name in jc.CNMGPParams._fields:
        assert_close(getattr(got, name), getattr(want, name), rtol=0)
    # the factors drawn where none is given are scaled by sqrt_scale
    a = tc.init_params(torch.Generator().manual_seed(1), D, M, dtype=torch.float64, device="cpu")
    b = tc.init_params(torch.Generator().manual_seed(1), D, M, dtype=torch.float64, device="cpu",
                       sqrt_scale=0.5, mu_W=given["mu_W"])
    for name in ("sqrt_v", "sqrt_W", "sqrt_U"):
        assert_close(getattr(b, name), 5.0 * getattr(a, name).numpy(), rtol=1e-15)
    assert_close(b.mu_U, a.mu_U, rtol=0)  # the same draws, whatever is given


@pytest.mark.parametrize("kl_mode", ["true", "ref_compat"])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_negative_selbo_value_and_grads_match_jax(D, kl_mode):
    p, Z, x, y, idx, w, key = _problem(D, seed=20 + D)
    args = (jnp.asarray(Z), jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx), jnp.asarray(w), key)
    want, want_grads = jax_value_and_grad(JAX_LOSS[kl_mode], p, *args)
    pt = _port_params(p)
    noise = jax_train_noise(key, M_IND, B, D)
    loss = tc.negative_selbo(pt, *map(torch.as_tensor, (Z, x, y, idx, w)), N_TOTAL, noise,
                             JITTER, kl_mode)
    loss.backward()
    assert_close(loss, want, rtol=1e-10)
    for name, t, g in zip(jc.CNMGPParams._fields, pt, want_grads):
        assert t.grad is not None, name
        assert_grad_close(t.grad, g)


def _jax_elbo(p, Z, x, y, idx, key):
    return jc.elbo_estimate(p, Z, x, y, idx, key, n_sample=5, jitter=JITTER)


def test_elbo_estimate_matches_jax():
    """Five draws, the JAX estimate's own key split (cnmgp.py:530), run by
    the port in chunks of two (the last one ragged)."""
    D = 2
    p, Z, x, y, idx, _, key = _problem(D, seed=5)
    want = run_jax(_jax_elbo, p, *map(jnp.asarray, (Z, x, y, idx)), key)
    noise = jax_train_noise(jax.random.split(key, 5), M_IND, B, D)
    pt = tc.CNMGPParams(*(torch.as_tensor(np.array(a)) for a in p))
    got = tc.elbo_estimate(pt, *map(torch.as_tensor, (Z, x, y, idx)), noise, JITTER,
                           draws_per_chunk=2)
    assert_close(got, want, rtol=1e-10)


def _spd_stack(r, batch, m):
    z = np.sort(r.random(m))
    K = np.exp(-0.5 * (z[:, None] - z[None, :]) ** 2 / 0.2**2) + 1e-2 * np.eye(m)
    return np.stack([K * (1.0 + 0.1 * i) for i in range(batch)])


def test_chol_tri_inv_grad_matches_jax():
    r = np.random.default_rng(1)
    K = _spd_stack(r, 3, 7)
    c1, c2 = r.standard_normal((2, 3, 7, 7))

    def f(chol_tri_inv, K, sin, arr):
        L, Linv = chol_tri_inv(K)
        return (sin(L) * arr(c1)).sum() + (sin(Linv) * arr(c2)).sum()

    want = jax.grad(lambda K: f(jl.chol_tri_inv, K, jnp.sin, jnp.asarray))(jnp.asarray(K))
    Kt = torch.tensor(K, requires_grad=True)
    f(tl.chol_tri_inv, Kt, torch.sin, torch.as_tensor).backward()
    assert_grad_close(Kt.grad, want)


def test_tri_solve_white_grad_matches_jax():
    """Gradients of L and B; Linv is an auxiliary operand with a zero
    cotangent in both packages."""
    r = np.random.default_rng(2)
    L = np.linalg.cholesky(_spd_stack(r, 2, 6))
    Linv = np.linalg.inv(L)
    Bm = r.standard_normal((2, 6, 5))
    c = r.standard_normal((2, 6, 5))

    def f(solve, L, Linv, Bm, sin, arr):
        return (sin(solve(L, Linv, Bm)) * arr(c)).sum()

    want = jax.grad(lambda *a: f(jl.tri_solve_white, *a, jnp.sin, jnp.asarray),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (L, Linv, Bm)))
    got = [torch.tensor(a, requires_grad=True) for a in (L, Linv, Bm)]
    f(tl.tri_solve_white, *got, torch.sin, torch.as_tensor).backward()
    assert_grad_close(got[0].grad, want[0])
    assert got[1].grad is None and not np.asarray(want[1]).any()
    assert_grad_close(got[2].grad, want[2])


@pytest.mark.parametrize("d", [1, 3])
def test_gibbs_grads_match_jax(d):
    """All five gradients, with inputs of dimension d, against jax.grad of
    the JAX `gibbs` (plain jnp, differentiated by JAX's autodiff)."""
    r = np.random.default_rng(d)
    x1, x2 = r.random((9, d)), r.random((6, d))
    if d == 1:
        x1, x2 = x1[:, 0], x2[:, 0]
    e1, e2 = np.exp(0.3 * r.standard_normal(9)), np.exp(0.3 * r.standard_normal(6))
    c = r.standard_normal((9, 6))

    def f(gibbs, sin, arr, *a):
        return (sin(gibbs(*a)) * arr(c)).sum()

    args = (x1, x2, e1, e2, 1.7)
    want = jax.grad(lambda *a: f(jk.gibbs, jnp.sin, jnp.asarray, *a), argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, args))
    got = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    f(tk.gibbs, torch.sin, torch.as_tensor, *got).backward()
    for t, g in zip(got, want):
        assert_grad_close(t.grad, g)


def test_gibbs_grad_of_a_shared_draw_batched_gram():
    """K_G_22 = gibbs(Z, Z, ell_Z, ell_Z) with a draw dimension: the one
    lengthscale tensor passed twice gets both contributions, as jax.grad of
    the vmapped JAX gram gives."""
    r = np.random.default_rng(4)
    Z = np.linspace(0.0, 1.0, 7)
    ell = np.exp(-1.0 + 0.3 * r.standard_normal((3, 7)))
    c = r.standard_normal((3, 7, 7))

    def jf(ell):
        K = jax.vmap(lambda e: jk.gibbs(jnp.asarray(Z), jnp.asarray(Z), e, e))(ell)
        return (jnp.sin(K) * c).sum()

    want = jax.grad(jf)(jnp.asarray(ell))
    et = torch.tensor(ell, requires_grad=True)
    (torch.sin(tk.gibbs(torch.as_tensor(Z), torch.as_tensor(Z), et, et)) * torch.as_tensor(c)).sum().backward()
    assert_grad_close(et.grad, want)
