"""The port's DSVI pre-estimation (`models/initialization.py`) against the
JAX package's, on the inputs of `tests/test_diagnostics_init.py:48-71`
(N = 80 points of a separable two-output GP, ell 0.2, noise 1e-2, four
inducing points, P = 10 neighbours), at rtol 1e-10.  Both are NumPy/SciPy
on the host; the JAX module's neighbour search runs the repo's native
library, the port's a stable argsort in the same order."""

import numpy as np
import pytest

from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import (
    initialization as jinit,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
    initialization as tinit,
)


@pytest.fixture(scope="module")
def data():
    """tests/test_diagnostics_init.py:56-66, from a generator of its own."""
    rng = np.random.default_rng(10)
    N, D = 80, 2
    x = np.sort(rng.random(N))
    ell_true, s2e_true = 0.2, 1e-2
    d2 = (x[:, None] - x[None, :]) ** 2
    K = np.exp(-0.5 * d2 / ell_true**2)
    B = np.array([[1.0, 0.6], [0.6, 1.0]])
    cov = np.kron(K, B) + s2e_true * np.eye(N * D)
    Y = rng.multivariate_normal(np.zeros(N * D), cov).reshape(N, D)
    return x, Y, np.linspace(0.1, 0.9, 4)


@pytest.mark.parametrize("P", [1, 10, 80])
def test_search_nearest_neighborhood_matches_jax(data, P):
    x, Y, z = data
    for z_m in list(z) + [x[7], -1.0]:
        gx, gY = tinit.search_nearest_neighborhood(x, Y, z_m, P=P)
        wx, wY = jinit.search_nearest_neighborhood(x, Y, z_m, P=P)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gY, wY)
    # ties at equal distance go to the lower index, as the native search's
    xt = np.array([0.0, 2.0, 1.0, 3.0, 1.0])
    Yt = np.arange(10.0).reshape(5, 2)
    np.testing.assert_array_equal(tinit.search_nearest_neighborhood(xt, Yt, 1.5, P=4)[1],
                                  jinit.search_nearest_neighborhood(xt, Yt, 1.5, P=4)[1])


@pytest.mark.parametrize("which", ["pre_estimation_partial", "pre_estimation_all"])
def test_pre_estimation_matches_jax(data, which):
    x, Y, z = data
    got = getattr(tinit, which)(x, Y, z, P=10)
    want = getattr(jinit, which)(x, Y, z, P=10)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)
    v, U, s2e = got
    assert v.shape == (4,) and U.shape == (2, 2, 4) and np.all(s2e < 0.0)


@pytest.mark.parametrize("M, D, factor", [(5, 3, 1e-2), (4, 1, 0.5)])
def test_pre_initialization_matches_jax(M, D, factor):
    for g, w in zip(tinit.pre_initialization(M, D, factor), jinit.pre_initialization(M, D, factor)):
        np.testing.assert_array_equal(g, w)
