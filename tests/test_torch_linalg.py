"""The port's `ops/linalg.py` and `ops/kernels.py` against the JAX package,
in float64 on the CPU (rtol 1e-10: the same arithmetic, summed in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import kernels as jk
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import linalg as jl
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import kernels as tk
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import linalg as tl
from torch_port_helpers import assert_close

torch.set_num_threads(1)
T = torch.as_tensor
J = jnp.asarray


def _rng(seed):
    return np.random.default_rng(seed)


def _rbf_gram(r, m, ls):
    z = np.sort(r.random(m))
    return np.exp(-0.5 * (z[:, None] - z[None, :]) ** 2 / ls**2)


@pytest.mark.parametrize("d", [1, 2, 6])
def test_sq_dist_and_rbf(d):
    r = _rng(d)
    x1, x2 = 10 * r.random((13, d)), 10 * r.random((7, d))
    assert_close(tk.sq_dist(T(x1), T(x2)), jk.sq_dist(J(x1), J(x2)), rtol=1e-10, atol=1e-12)
    assert_close(tk.rbf(T(x1), T(x2), 1.3, 2.1), jk.rbf(J(x1), J(x2), 1.3, 2.1), rtol=1e-10)


def test_tril_factors():
    X = _rng(0).standard_normal((3, 6, 6))
    assert_close(tl.tril_mask(T(X)), jl.tril_mask(J(X)), rtol=0)
    assert_close(tl.tril_regularized(T(X), 1e-4), jl.tril_regularized(J(X), 1e-4), rtol=1e-12)
    assert_close(tl.regularized_diag(T(X), 1e-4), jl.regularized_diag(J(X), 1e-4), rtol=1e-12)


def test_conditional_projection_and_psd_solve():
    r = _rng(1)
    K22 = _rbf_gram(r, 12, 0.05)
    K12 = r.standard_normal((20, 12))
    assert_close(
        tl.conditional_projection(T(K12), T(K22), 1e-4),
        jl.conditional_projection(J(K12), J(K22), 1e-4),
        rtol=1e-10, atol=1e-12,
    )
    B = r.standard_normal((12, 3))
    assert_close(tl.psd_solve(T(K22), T(B)), jl.psd_solve(J(K22), J(B)), rtol=1e-10, atol=1e-12)


def test_chol_tri_inv_robust_recovers_a_failed_member():
    """A member whose factorization fails (NaN) is refactored with the
    boosted jitter; the healthy members are the plain factors."""
    r = _rng(2)
    m, jitter = 10, 1e-3
    Ks = np.stack([_rbf_gram(r, m, 0.05) + 1e-2 * np.eye(m) for _ in range(3)])
    Ks[1] -= 3e-2 * np.eye(m)  # smallest eigenvalue now < 0: not PD
    L, Linv = tl.chol_tri_inv_robust(T(Ks), jitter)
    L_ref, Linv_ref = jl.chol_tri_inv_robust(J(Ks), jitter)
    assert np.isfinite(np.asarray(L_ref)).all()
    assert np.isnan(np.asarray(jl.chol_tri_inv(J(Ks))[0][1])).any()
    assert_close(L, L_ref, rtol=1e-10, atol=1e-12)
    assert_close(Linv, Linv_ref, rtol=1e-10, atol=1e-12)


def test_tri_solve_white():
    r = _rng(3)
    K = np.stack([_rbf_gram(r, 9, 0.1) + 1e-2 * np.eye(9) for _ in range(2)])
    L, Linv = jl.chol_tri_inv(J(K))
    B = r.standard_normal((2, 9, 14))
    got = tl.tri_solve_white(T(np.array(L)), T(np.array(Linv)), T(B))
    assert_close(got, jl.tri_solve_white(L, Linv, J(B)), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("with_draws", [False, True])
def test_mgp_mean_var_white(with_draws):
    r = _rng(4)
    M, N, G, S = 8, 15, 5, 3
    shape = (S,) if with_draws else ()
    Lp = np.stack([np.linalg.cholesky(_rbf_gram(r, M, 0.3) + 1e-3 * np.eye(M)) for _ in range(S)])
    Lp_inv = np.linalg.inv(Lp)
    A = r.standard_normal((S, M, N))
    mu, st = r.standard_normal((G, M)), np.tril(r.standard_normal((G, M, M)))
    if not with_draws:
        Lp_inv, A = Lp_inv[0], A[0]
    mean, var, W = tl.mgp_mean_var_white(T(A), T(Lp_inv), 1.7, T(mu), T(st))
    assert mean.shape == shape + (G, N) and W.shape == shape + (G, M, M)
    ref = jax.vmap(jl.mgp_mean_var_white, in_axes=(0, 0, None, None, None)) if with_draws else jl.mgp_mean_var_white
    m_ref, v_ref, w_ref = ref(J(A), J(Lp_inv), jnp.full((N,), 1.7), J(mu), J(st))
    assert_close(mean, m_ref, rtol=1e-10, atol=1e-12)
    assert_close(var, v_ref, rtol=1e-10, atol=1e-12)
    assert_close(W, w_ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("jitter", [0.0, 1e-4])
def test_sample_full_cov_and_sample_diag_with_injected_noise(jitter):
    """Noise rebuilt from the JAX key schedule (k1, k2 = split(key)); at
    jitter 0.0 the JAX version skips the z2 draw and so does the port."""
    r = _rng(5)
    M = 7
    mean, st = r.standard_normal(M), np.tril(r.standard_normal((M, M)))
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    z1 = np.stack([np.asarray(jax.random.normal(jax.random.split(k)[0], (M,))) for k in keys])
    z2 = np.stack([np.asarray(jax.random.normal(jax.random.split(k)[1], (M,))) for k in keys])
    got = tl.sample_full_cov(T(mean), T(st), T(z1), None if jitter == 0.0 else T(z2), jitter)
    want = jax.vmap(lambda k: jl.sample_full_cov(k, J(mean), J(st), jitter))(keys)
    assert_close(got, want, rtol=1e-10, atol=1e-12)
    var = r.random(M)
    zd = np.array(jax.random.normal(keys[0], (M,)))
    assert_close(
        tl.sample_diag(T(mean), T(var), T(zd), 1e-4),
        jl.sample_diag(keys[0], J(mean), J(var), 1e-4),
        rtol=1e-12,
    )


# ---------------------------------------------------------------------------
# The dense conditioning and the Gaussian KLs, on the inputs of the oracles
# of tests/test_linalg.py, against the JAX functions and the oracles
# ---------------------------------------------------------------------------


def _spd(r, n, scale=1.0):
    """tests/test_linalg.py's `rand_spd`, from the generator given."""
    A = r.normal(size=(n, n))
    return scale * (A @ A.T + n * np.eye(n))


def test_every_public_jax_linalg_function_has_a_port():
    import inspect

    def public(mod):
        return {n for n, f in inspect.getmembers(mod, inspect.isfunction)
                if not n.startswith("_") and f.__module__ == mod.__name__}

    assert public(jl) <= set(tl.__all__) and public(jl) <= public(tl)


def test_mgp_mean_var_and_its_factor_form():
    """tests/test_linalg.py:63-92 and :199-221: the Sigma form against the
    naive per-draw formula, the factor form against the Sigma form, both
    against the JAX functions."""
    JITTER, N, M, Tn = 1e-4, 6, 4, 3
    r = _rng(101)
    K22, K12 = _spd(r, M), r.normal(size=(N, M))
    d11 = np.abs(r.normal(size=N)) + 1.0
    mu = r.normal(size=(Tn, M))
    L = np.stack([np.tril(r.normal(size=(M, M))) for _ in range(Tn)])
    Sigma = np.einsum("tij,tkj->tik", L, L)
    P = K12 @ np.linalg.inv(K22 + JITTER * np.eye(M))
    mean, var = tl.mgp_mean_var(T(P), T(K12), T(d11), T(mu), T(Sigma))
    jm, jv = jl.mgp_mean_var(J(P), J(K12), J(d11), J(mu), J(Sigma))
    assert_close(mean, jm, rtol=1e-10)
    assert_close(var, jv, rtol=1e-10)
    naive = np.stack([d11 - np.sum(P * K12, -1) + np.diag(P @ Sigma[t] @ P.T) for t in range(Tn)])
    assert_close(mean, mu @ P.T, rtol=1e-8)
    assert_close(var, naive, rtol=1e-7)
    mean2, var2 = tl.mgp_mean_var_tril(T(P), T(K12), T(d11), T(mu), T(L))
    jm2, jv2 = jl.mgp_mean_var_tril(J(P), J(K12), J(d11), J(mu), J(L))
    assert_close(mean2, jm2, rtol=1e-10)
    assert_close(var2, jv2, rtol=1e-10)
    assert_close(var2, var.numpy(), rtol=1e-6)


def test_conditional_mean_cov():
    """tests/test_linalg.py:224-247."""
    JITTER, N, M = 1e-4, 5, 4
    r = _rng(102)
    K22, K12, K11 = _spd(r, M), r.normal(size=(N, M)), _spd(r, N)
    mu = r.normal(size=M)
    A = r.normal(size=(M, M))
    Sigma = A @ A.T
    mean, cov = tl.conditional_mean_cov(T(K12), T(K22), T(mu), T(Sigma), T(K11), JITTER)
    jm, jc = jl.conditional_mean_cov(J(K12), J(K22), J(mu), J(Sigma), J(K11), JITTER)
    assert_close(mean, jm, rtol=1e-10)
    assert_close(cov, jc, rtol=1e-10, atol=1e-12)
    P = K12 @ np.linalg.inv(K22 + JITTER * np.eye(M))
    assert_close(mean, P @ mu, rtol=1e-7)
    assert_close(cov, K11 - P @ K12.T + P @ Sigma @ P.T, rtol=1e-6, atol=1e-8)


def _key_draws(keys, M, N):
    """The normals of `joint_sample(key)` for each key: k_v, k_f =
    split(key), k1, k2 = split(k_v) (sample_full_cov), z_v1, z_v2 of
    (M,), z_f of (N,)."""
    def one(key):
        k_v, k_f = jax.random.split(key)
        k1, k2 = jax.random.split(k_v)
        return (jax.random.normal(k1, (M,), jnp.float64), jax.random.normal(k2, (M,), jnp.float64),
                jax.random.normal(k_f, (N,), jnp.float64))

    return [T(np.array(a)) for a in jax.vmap(one)(keys)]


def test_joint_sample_and_conditional_sample():
    """tests/test_linalg.py:250-297 on eight keys: each draw the JAX one's
    (its noise rebuilt from the key), then the oracle's moments over 20,000
    draws of the port's own noise."""
    JITTER, N, M = 1e-4, 4, 3
    r = _rng(103)
    K22, K12 = _spd(r, M), 0.3 * r.normal(size=(N, M))
    K11d = np.abs(r.normal(size=N)) + 2.0
    mu = r.normal(size=M)
    Lq = np.tril(r.normal(size=(M, M))) + np.eye(M)
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    z_v1, z_v2, z_f = _key_draws(keys, M, N)
    f, v = tl.joint_sample(T(K12), T(K22), T(mu), T(Lq), T(K11d), z_v1, z_v2, z_f, JITTER)
    jf, jv = jax.vmap(lambda k: jl.joint_sample(k, J(K12), J(K22), J(mu), J(Lq), J(K11d),
                                                JITTER))(keys)
    assert_close(f, jf, rtol=1e-10, atol=1e-12)
    assert_close(v, jv, rtol=1e-10, atol=1e-12)
    v0 = r.normal(size=M)
    zc = T(np.array(jax.vmap(lambda k: jax.random.normal(k, (N,), jnp.float64))(keys)))
    g = tl.conditional_sample(T(K12), T(K22), T(v0), T(K11d), zc, JITTER)
    jg = jax.vmap(lambda k: jl.conditional_sample(k, J(K12), J(K22), J(v0), J(K11d), JITTER))(keys)
    assert_close(g, jg, rtol=1e-10, atol=1e-12)

    gen = torch.Generator().manual_seed(0)
    S = 20000
    zs = [torch.randn((S, n), generator=gen, dtype=torch.float64) for n in (M, M, N)]
    f, v = (a.numpy() for a in tl.joint_sample(T(K12), T(K22), T(mu), T(Lq), T(K11d), *zs, JITTER))
    P = K12 @ np.linalg.inv(K22 + JITTER * np.eye(M))
    Sigma_v = Lq @ Lq.T + JITTER * np.eye(M)
    base = np.maximum(K11d - np.sum(P * K12, -1), 0.0) + JITTER
    np.testing.assert_allclose(v.mean(0), mu, atol=0.05)
    np.testing.assert_allclose(f.mean(0), P @ mu, atol=0.08)
    np.testing.assert_allclose(np.cov(f.T), P @ Sigma_v @ P.T + np.diag(base), atol=0.15)
    g = tl.conditional_sample(T(K12), T(K22), T(v0), T(K11d), zs[2], JITTER).numpy()
    np.testing.assert_allclose(g.mean(0), P @ v0, atol=0.05)
    np.testing.assert_allclose(g.var(0), base, atol=0.1)


def test_joint_sample_full():
    """tests/test_linalg.py:503-540 on eight keys against the JAX draws,
    then the joint moments of 40,000 draws against the dense joint."""
    JITTER, Nn, Mi = 1e-4, 6, 4
    r = _rng(42)
    x, z = np.sort(r.random(Nn)), np.linspace(0, 1, Mi)
    K12, K22, K11 = (np.asarray(jk.rbf(J(a), J(b), 1.0, 0.4)) for a, b in ((x, z), (z, z), (x, x)))
    mu = r.normal(size=Mi)
    Lq = np.tril(r.normal(size=(Mi, Mi)) * 0.3)
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    zs = _key_draws(keys, Mi, Nn)
    f, v = tl.joint_sample_full(T(K12), T(K22), T(K11), T(mu), T(Lq), *zs, JITTER)
    jf, jv = jax.vmap(lambda k: jl.joint_sample_full(k, J(K12), J(K22), J(K11), J(mu), J(Lq),
                                                     JITTER))(keys)
    assert_close(f, jf, rtol=1e-10, atol=1e-12)
    assert_close(v, jv, rtol=1e-10, atol=1e-12)

    gen = torch.Generator().manual_seed(1)
    S = 40000
    zs = [torch.randn((S, n), generator=gen, dtype=torch.float64) for n in (Mi, Mi, Nn)]
    f, v = tl.joint_sample_full(T(K12), T(K22), T(K11), T(mu), T(Lq), *zs, JITTER)
    draws = np.concatenate([f.numpy(), v.numpy()], axis=1)
    P = K12 @ np.linalg.inv(K22 + JITTER * np.eye(Mi))
    Sig = Lq @ Lq.T + JITTER * np.eye(Mi)
    B = K11 - P @ K12.T + JITTER * np.eye(Nn)
    cov = np.block([[P @ Sig @ P.T + B, P @ Sig], [Sig @ P.T, Sig]])
    np.testing.assert_allclose(draws.mean(0), np.concatenate([P @ mu, mu]), atol=0.03)
    np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.05)


def _kl_dense(mu_q, Sq, mu_p, Sp):
    """tests/test_linalg.py's closed-form oracle."""
    iSp = np.linalg.inv(Sp)
    d = mu_p - mu_q
    return 0.5 * (np.log(np.linalg.det(Sp) / np.linalg.det(Sq)) + np.trace(iSp @ Sq)
                  + d @ iSp @ d - len(mu_q))


def test_kl_gaussian_against_jax_and_the_oracle():
    """tests/test_linalg.py:97-130: one pair, a batch of three, and zero
    for equal Gaussians."""
    JITTER, M = 1e-4, 5
    r = _rng(1)
    Lq, mu_q, Kp = np.tril(r.normal(size=(M, M))), r.normal(size=M), _spd(r, M)
    mu_p = np.zeros(M)
    got = tl.kl_gaussian(T(mu_q), T(Lq), T(mu_p), T(Kp), JITTER)
    assert_close(got, jl.kl_gaussian(J(mu_q), J(Lq), J(mu_p), J(Kp), JITTER), rtol=1e-10)
    eye = JITTER * np.eye(M)
    assert_close(got, _kl_dense(mu_q, Lq @ Lq.T + eye, mu_p, Kp + eye), rtol=1e-8)
    Lqs = np.stack([np.tril(r.normal(size=(4, 4))) for _ in range(3)])
    mus, Kp4 = r.normal(size=(3, 4)), _spd(r, 4)
    got = tl.kl_gaussian(T(mus), T(Lqs), torch.zeros(4, dtype=torch.float64), T(Kp4), JITTER)
    assert_close(got, jl.kl_gaussian(J(mus), J(Lqs), jnp.zeros(4), J(Kp4), JITTER), rtol=1e-10)
    e4 = JITTER * np.eye(4)
    for b in range(3):
        assert_close(got[b], _kl_dense(mus[b], Lqs[b] @ Lqs[b].T + e4, np.zeros(4), Kp4 + e4),
                     rtol=1e-8)
    Kp4 = _spd(r, 4)
    same = tl.kl_gaussian(torch.zeros(4, dtype=torch.float64), T(np.linalg.cholesky(Kp4)),
                          torch.zeros(4, dtype=torch.float64), T(Kp4), JITTER)
    assert abs(float(same)) < 1e-8


@pytest.mark.parametrize("jitter", [1e-4, 1e-12])
@pytest.mark.parametrize("exact_logdet", [True, False])
def test_kl_gaussian_chol(jitter, exact_logdet):
    """tests/test_linalg.py:155-196: well- and ill-conditioned factors, the
    exact and the cheaper logdet, against the JAX function; the two
    logdets within the oracle test's bounds of each other."""
    M, B = 6, 4
    r = _rng(7)
    Lp = np.asarray(jl.chol_with_jitter(J(_spd(r, M)), 1e-4))
    mus = r.normal(size=(B, M))
    Lq_pd = np.stack([0.3 * np.tril(r.normal(size=(M, M))) + 0.5 * np.eye(M) for _ in range(B)])
    Lq_ill = np.stack([np.tril(r.normal(size=(M, M))) for _ in range(B)])
    for Lq in (Lq_pd, Lq_ill):
        got = tl.kl_gaussian_chol(T(mus), T(Lq), torch.zeros(M, dtype=torch.float64), T(Lp),
                                  jitter, exact_logdet)
        want = jl.kl_gaussian_chol(J(mus), J(Lq), jnp.zeros(M), J(Lp), jitter, exact_logdet)
        assert_close(got, want, rtol=1e-10)
    kl = {e: tl.kl_gaussian_chol(T(mus), T(Lq_pd), torch.zeros(M, dtype=torch.float64), T(Lp),
                                 jitter, e).numpy() for e in (True, False)}
    if jitter == 1e-4:
        np.testing.assert_allclose(kl[False], kl[True], atol=100 * jitter * M)
    else:
        np.testing.assert_allclose(kl[False], kl[True], rtol=1e-6)
