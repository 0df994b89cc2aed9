"""The port's GP baselines (`models/baselines.py`) against the JAX package's,
in float64 on the CPU: the marginal likelihood and the Titsias bound with
their gradients, 50 Adam steps of every fit from the same start, the
predictives of a JAX fit carried across by `baselines_from_numpy`, and the
learning tests of `tests/test_baselines_utils.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import baselines as jb
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
    baselines as tb,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.metrics import rmse
from torch_port_helpers import assert_close, jax_value_and_grad

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
FIT_STEPS = 50
# Trainable inducing inputs under the exponential kernel cross data points,
# where sqrt(d^2 + 1e-12) bends with curvature ~1e6: from about step 20 of
# these fits each 10 steps multiply a rounding difference by ~30 in both
# packages alike (the rbf fits stay within 1e-9 over 50), so the sparse
# exponential fits are compared over 20 steps.
KINK_STEPS = 20


def _toy_multioutput(rng, n=60, n_test=30):
    """tests/test_baselines_utils.py's two-output sine task."""
    x1 = np.sort(rng.random(n))
    x2 = np.sort(rng.random(n))
    f = lambda t: np.sin(2 * np.pi * t)  # noqa: E731
    X_list = [x1, x2]
    Y_list = [f(x1) + 0.1 * rng.standard_normal(n), 0.7 * f(x2) + 0.1 * rng.standard_normal(n)]
    Xt = [np.sort(rng.random(n_test)) for _ in range(2)]
    Yt = [f(Xt[0]), 0.7 * f(Xt[1])]
    return X_list, Y_list, Xt, Yt


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("kernel", ["exponential", "rbf"])
def test_nlml_value_and_gradient_match_jax(kernel):
    rng = np.random.default_rng(0)
    x = np.sort(rng.random(25))
    y = np.sin(4 * x) + 0.1 * rng.standard_normal(25)
    theta = np.array([0.1, -0.5, -2.0])
    want_v, want_g = jax_value_and_grad(
        lambda th, x, y: jb._nlml(th, x, y, jb._KERNELS[kernel]), jnp.asarray(theta),
        jnp.asarray(x), jnp.asarray(y))
    th = _t(theta).requires_grad_(True)
    got = tb._nlml(th, _t(x), _t(y), tb._KERNELS[kernel])
    got.backward()
    assert_close(got, want_v, rtol=1e-10)
    assert_close(th.grad, want_g, rtol=1e-8)


@pytest.mark.parametrize("kernel", ["exponential", "rbf"])
def test_titsias_bound_and_its_gradient_match_jax(kernel):
    """The SICM bound (the sparse ICM's loss, which holds `_titsias_parts`,
    `_icm_cov` and `_icm_diag`) at a start with the inducing inputs moved
    off the data."""
    rng = np.random.default_rng(1)
    X_list, Y_list, _, _ = _toy_multioutput(rng, n=20, n_test=2)
    D, rank, m = 2, 1, 9
    x = np.concatenate(X_list)
    y = np.concatenate(Y_list)
    idx = np.repeat([0, 1], 20)
    zidx = np.arange(m) % D
    pars = np.concatenate([[0.2, -1.1, -1.5], [0.5, -0.3], [-1.0, -0.7],
                           np.linspace(0.05, 0.95, m)])
    n_hyp = 3 + D * rank + D

    def jloss(p, x, y):
        noise = jnp.exp(p[2]) + 1e-6
        kf = jb._KERNELS[kernel]
        Kuu = jb._icm_cov(p[:n_hyp], p[n_hyp:], zidx, p[n_hyp:], zidx, D, rank, kf)
        Kuf = jb._icm_cov(p[:n_hyp], p[n_hyp:], zidx, x, idx, D, rank, kf)
        return jb._titsias_parts(Kuu, Kuf, jb._icm_diag(p[:n_hyp], idx, D, rank), y, noise)[0]

    want_v, want_g = jax_value_and_grad(jloss, jnp.asarray(pars), jnp.asarray(x), jnp.asarray(y))
    p = _t(pars).requires_grad_(True)
    (got, *_), _ = tb._sicm_parts(p[:n_hyp], p[n_hyp:], torch.as_tensor(zidx), _t(x), _t(y),
                                  torch.as_tensor(idx), D, rank, tb._KERNELS[kernel])
    got.backward()
    assert_close(got, want_v, rtol=1e-10)
    assert_close(p.grad, want_g, rtol=1e-8)


def _fits(kernel):
    """{name: (JAX fit, port fit)}, FIT_STEPS Adam steps each at lr 0.05
    (KINK_STEPS for the sparse exponential fits), both from the JAX
    package's starts."""
    rng = np.random.default_rng(2)
    X_list, Y_list, _, _ = _toy_multioutput(rng, n=24, n_test=2)
    kw = dict(kernel=kernel, steps=FIT_STEPS, lr=0.05)
    sparse = dict(kw, steps=KINK_STEPS if kernel == "exponential" else FIT_STEPS)
    return {
        "igpr": (jb.fit_igpr(X_list, Y_list, **kw), tb.fit_igpr(X_list, Y_list, **kw, **F64)),
        "icm": (jb.fit_icm(X_list, Y_list, rank=1, **kw),
                tb.fit_icm(X_list, Y_list, rank=1, **kw, **F64)),
        "sgpr": (jb.fit_sgpr(X_list, Y_list, num_inducing=8, **sparse),
                 tb.fit_sgpr(X_list, Y_list, num_inducing=8, **sparse, **F64)),
        "sicm": (jb.fit_sicm(X_list, Y_list, num_inducing=10, rank=1, **sparse),
                 tb.fit_sicm(X_list, Y_list, num_inducing=10, rank=1, **sparse, **F64)),
    }


def _fitted(model):
    """The fitted vector of each model of a fit: theta, with the inducing
    inputs of a sparse model after it."""
    arrays = []
    for m in model if isinstance(model, list) else [model]:
        parts = [m[0]] + ([m.Z] if hasattr(m, "Z") else [])
        arrays.append(np.concatenate([p.detach().numpy() if isinstance(p, torch.Tensor)
                                      else np.asarray(p) for p in parts]))
    return arrays


@pytest.mark.parametrize("kernel", ["exponential", "rbf"])
def test_fits_take_the_jax_packages_adam_steps(kernel):
    for name, (jfit, tfit) in _fits(kernel).items():
        for g, w in zip(_fitted(tfit), _fitted(jfit), strict=True):
            np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-12, err_msg=f"{name} {kernel}")


@pytest.mark.parametrize("kernel", ["exponential", "rbf"])
def test_predictives_of_a_jax_fit_carried_across(kernel):
    rng = np.random.default_rng(3)
    X_list, Y_list, Xt, _ = _toy_multioutput(rng, n=24, n_test=7)
    kw = dict(kernel=kernel, steps=FIT_STEPS, lr=0.05)
    cases = {
        "igpr": (jb.fit_igpr(X_list, Y_list, **kw),
                 lambda m, xs: jb.predict_igpr(m, xs, kernel=kernel),
                 lambda m, xs: tb.predict_igpr(m, xs, kernel=kernel)),
        "icm": (jb.fit_icm(X_list, Y_list, **kw), jb.predict_icm, tb.predict_icm),
        "sgpr": (jb.fit_sgpr(X_list, Y_list, num_inducing=8, **kw), jb.predict_sgpr,
                 tb.predict_sgpr),
        "sicm": (jb.fit_sicm(X_list, Y_list, num_inducing=10, **kw), jb.predict_sicm,
                 tb.predict_sicm),
    }
    for name, (jfit, jpred, tpred) in cases.items():
        carried = tb.baselines_from_numpy(jax.tree_util.tree_map(np.asarray, jfit), device="cpu")
        for want, got in zip(jpred(jfit, Xt), tpred(carried, Xt)):
            for w, g in zip(want, got):
                assert isinstance(g, np.ndarray) and g.dtype == np.float64
                np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-13, err_msg=f"{name} {kernel}")


def test_carried_models_keep_their_fields():
    rng = np.random.default_rng(4)
    X_list, Y_list, _, _ = _toy_multioutput(rng, n=10, n_test=2)
    jfit = jb.fit_sicm(X_list, Y_list, num_inducing=6, rank=1, kernel="rbf", steps=2)
    carried = tb.baselines_from_numpy(jfit, device="cpu")
    assert isinstance(carried, tb.SICMModel)
    assert (carried.D, carried.rank, carried.kernel) == (2, 1, "rbf")
    assert carried.zidx.dtype == torch.int64 and carried.theta.dtype == torch.float64


def test_igpr_learns_signal():
    X_list, Y_list, Xt, Yt = _toy_multioutput(np.random.default_rng(9))
    models = tb.fit_igpr(X_list, Y_list, steps=300, **F64)
    means, stds = tb.predict_igpr(models, Xt)
    for m, yt, s in zip(means, Yt, stds):
        assert rmse(m, yt) < 0.35
        assert np.all(s > 0)


def test_icm_learns_shared_structure():
    X_list, Y_list, Xt, Yt = _toy_multioutput(np.random.default_rng(9))
    means, _ = tb.predict_icm(tb.fit_icm(X_list, Y_list, steps=300, **F64), Xt)
    for m, yt in zip(means, Yt):
        assert rmse(m, yt) < 0.35


def test_titsias_bound_tight_at_full_inducing():
    """With Z = X the Titsias collapsed bound equals the exact negative log
    marginal likelihood, and the SGPR predictive the exact GP predictive."""
    rng = np.random.default_rng(9)
    n = 30
    x = _t(np.sort(rng.random(n)))
    y = _t(np.sin(4 * x.numpy()) + 0.1 * rng.standard_normal(n))
    theta = _t([0.1, -0.5, -2.0])
    s2, ls, noise = (float(v) for v in np.exp(theta.numpy()))
    exact = float(tb._nlml(theta, x, y, tb.exponential_kernel))
    Kuu = tb.exponential_kernel(x, x, s2, ls)
    nbound, Luu, LB, c = tb._titsias_parts(Kuu, Kuu, torch.full((n,), s2, dtype=torch.float64), y,
                                           torch.tensor(noise + 1e-6, dtype=torch.float64))
    assert abs(float(nbound) - exact) < 0.05 * abs(exact) + 0.5
    xs = _t(np.linspace(0.1, 0.9, 7))
    mu_e, sd_e = tb.predict_igpr([(theta, x, y)], [xs])
    mu_s, var_s = tb._titsias_predict(Luu, LB, c, tb.exponential_kernel(x, xs, s2, ls),
                                      torch.full((7,), s2, dtype=torch.float64), noise + 1e-6)
    np.testing.assert_allclose(mu_s.numpy(), mu_e[0], atol=2e-3)
    np.testing.assert_allclose(np.sqrt(var_s.numpy()), sd_e[0], atol=2e-3)


def test_sparse_baselines_learn_signal():
    X_list, Y_list, Xt, Yt = _toy_multioutput(np.random.default_rng(9), n=80, n_test=20)
    mu, sd = tb.predict_sgpr(tb.fit_sgpr(X_list, Y_list, num_inducing=15, steps=400, **F64), Xt)
    err = np.sqrt(np.mean((np.concatenate(mu) - np.concatenate(Yt)) ** 2))
    assert err < 0.35, err
    mu2, sd2 = tb.predict_sicm(tb.fit_sicm(X_list, Y_list, num_inducing=20, rank=1, steps=400,
                                           **F64), Xt)
    err2 = np.sqrt(np.mean((np.concatenate(mu2) - np.concatenate(Yt)) ** 2))
    assert err2 < 0.35, err2
    assert all(np.all(np.isfinite(s)) and np.all(s > 0) for s in sd + sd2)
