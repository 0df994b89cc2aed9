"""The port's `utils/native.py` against the JAX package's (the same C++
source, `cpp/host_ops.cpp`, built with the same flags) and against its own
NumPy versions: the semivariograms and the neighbour indices bit for bit;
the windowed scatter covariances bit for bit against the JAX library and at
rtol 1e-12 against NumPy (the C++ loop and BLAS sum in other orders).  The
port builds its own library under `build/`, never loading the JAX
package's; without a compiler it takes the NumPy versions.  Then the
callers that go through it where the JAX package's do."""

from pathlib import Path

import numpy as np
import pytest

from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import native as jn
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
    initialization as tinit,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
    empirical as temp,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import native as tn

RNG = np.random.default_rng(7)


def _numpy(fn, *args):
    lib, tried = tn._lib, tn._tried
    tn._lib, tn._tried = None, True
    try:
        return fn(*args)
    finally:
        tn._lib, tn._tried = lib, tried


def test_builds_its_own_library():
    assert tn.available() and jn.available()
    path = Path(tn._library_path())
    assert path.exists() and path.parent.name == "build"
    assert Path(tn._lib._name).resolve() == path.resolve()
    assert Path(tn._lib._name).resolve() != Path(jn._LIB_PATH).resolve()


def test_semivariograms_bit_for_bit():
    n, m = 60, 3
    x = np.sort(RNG.random(n))
    Y = RNG.standard_normal((n, m))
    for fn, args in ((tn.semivariogram, (x, Y[:, 1])), (tn.semivariogram_multi, (x, Y))):
        got = fn(*args)
        want = getattr(jn, fn.__name__)(*args)
        plain = _numpy(fn, *args)
        for g, w, p in zip(got, want, plain):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("window", [1, 8, 80])
def test_windowed_scatter_cov(window):
    Y = RNG.standard_normal((50, 4))
    got = tn.windowed_scatter_cov(Y, window)
    np.testing.assert_array_equal(got, jn.windowed_scatter_cov(Y, window))
    np.testing.assert_allclose(got, _numpy(tn.windowed_scatter_cov, Y, window), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("k", [1, 10, 250])
def test_knn_bit_for_bit(k):
    """Nearest first, ties by index (x on a grid has ties), past len(x) the
    last one repeated, as the C++ search and the port's NumPy version."""
    x = np.round(RNG.random(200) * 50) / 50
    z = RNG.random(7)
    got = tn.knn_1d(x, z, k)
    np.testing.assert_array_equal(got, jn.knn_1d(x, z, k))
    np.testing.assert_array_equal(got, _numpy(tn.knn_1d, x, z, k))


def test_no_compiler_means_numpy(monkeypatch, tmp_path):
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_tried", False)
    monkeypatch.setattr(tn, "_library_path", lambda: tmp_path / "libcnmgp_host-none.so")
    monkeypatch.setattr(tn.shutil, "which", lambda name: None)
    assert not tn.available()
    lag, sv = tn.semivariogram(np.arange(4.0), np.arange(4.0) ** 2)
    assert lag.shape == sv.shape == (6,)


def test_callers_go_through_native(monkeypatch):
    calls = []
    for name in ("semivariogram", "semivariogram_multi", "windowed_scatter_cov", "knn_1d"):
        fn = getattr(tn, name)
        monkeypatch.setattr(tn, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    x = np.sort(RNG.random(40))
    Y = np.stack([np.sin(6 * x), np.cos(6 * x)], 1) + 0.1 * RNG.standard_normal((40, 2))
    temp.semivariogram(x, Y, 1)
    temp.local_estimation(x, Y, window_size=5)
    tinit.search_nearest_neighborhood(x, Y, 0.5, P=6)
    assert {"semivariogram", "semivariogram_multi", "windowed_scatter_cov", "knn_1d"} <= set(calls)
