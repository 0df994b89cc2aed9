"""The port's `utils/data.py` host helpers against the JAX package's: the
train/test splits (the JAX `data_split` and `data_split_non` call
scikit-learn's `train_test_split`; the port makes the same shuffled split
without scikit-learn), the per-task chunk and extrapolation holdouts, the
detrend helpers and the simulation pickle loader.  Equal arrays, dtypes
included."""

import numpy as np
import pytest

from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import data as jdata
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import data as tdata
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import sim as tsim


def assert_equal_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


def _series(n, seed=0):
    x, _, _, _, Y = tsim.sim_mnts(M=2, N=n, seed=seed)
    return x, Y


@pytest.mark.parametrize("random_state", [22, 5])
@pytest.mark.parametrize("test_size", [0.25, 0.3, 7])
@pytest.mark.parametrize("n", [20, 41, 100])
def test_data_split(n, test_size, random_state):
    x, Y = _series(n)
    assert_equal_arrays(tdata.data_split(x, Y, test_size=test_size, random_state=random_state),
                        jdata.data_split(x, Y, test_size=test_size, random_state=random_state))


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("random_state", [22, 5])
@pytest.mark.parametrize("test_size", [0.25, 0.3, 7])
@pytest.mark.parametrize("n", [20, 41])
def test_data_split_non(n, test_size, random_state, shuffle):
    x, Y = _series(n)
    xf, idx, yf = np.tile(x, 2), np.repeat(np.arange(2), n), Y.T.reshape(-1)
    kw = dict(test_size=test_size, random_state=random_state, shuffle=shuffle)
    assert_equal_arrays(tdata.data_split_non(xf, idx, yf, **kw),
                        jdata.data_split_non(xf, idx, yf, **kw))


def test_data_split_non_takes_a_random_state_object_and_refuses_bad_sizes():
    x, Y = _series(30)
    xf, idx, yf = np.tile(x, 2), np.repeat(np.arange(2), 30), Y.T.reshape(-1)
    assert_equal_arrays(tdata.data_split_non(xf, idx, yf, random_state=np.random.RandomState(4)),
                        jdata.data_split_non(xf, idx, yf, random_state=np.random.RandomState(4)))
    for bad in (0.0, 1.0, 60, 0):
        with pytest.raises(ValueError):
            tdata.data_split_non(xf, idx, yf, test_size=bad)
        with pytest.raises(ValueError):
            jdata.data_split_non(xf, idx, yf, test_size=bad)
    with pytest.raises(ValueError):
        tdata.data_split_non(xf, idx[:-1], yf)


@pytest.mark.parametrize("fix", [False, True])
@pytest.mark.parametrize("chunk_size", [0.2, 0.35])
def test_data_split_non_chunk(chunk_size, fix):
    x, Y = _series(40, seed=2)
    xf, idx, yf = np.tile(x, 2), np.repeat(np.arange(2), 40), Y.T.reshape(-1)
    kw = dict(chunk_size=chunk_size, random_state=7, fix=fix)
    assert_equal_arrays(tdata.data_split_non_chunk(xf, idx, yf, **kw),
                        jdata.data_split_non_chunk(xf, idx, yf, **kw))


@pytest.mark.parametrize("size", [5, 12])
def test_data_split_extrapolation(size):
    x, Y = _series(40, seed=3)
    assert_equal_arrays(tdata.data_split_extrapolation(x, Y, size),
                        jdata.data_split_extrapolation(x, Y, size))


def test_detrend_helpers():
    _, Y = _series(50, seed=4)
    Y = 3.0 + 2.0 * Y
    got, want = tdata.orig2adj(Y), jdata.orig2adj(Y)
    assert_equal_arrays(got, want)
    np.testing.assert_array_equal(tdata.adj2orig(*got), jdata.adj2orig(*want))
    np.testing.assert_allclose(tdata.adj2orig(*got), Y, rtol=1e-12)
    ys = [Y[:, 0], Y[:30, 1]]
    got, want = tdata.orig2adj_lists(ys), jdata.orig2adj_lists(ys)
    for g, w in zip(got, want):
        assert_equal_arrays(g, w)
    assert_equal_arrays(tdata.adj2orig_lists(*got), jdata.adj2orig_lists(*want))


def test_load_sim_pickle(tmp_path):
    """The loader reads the [X_list, Y_list, Xt_list, Yt_list] pickle that
    the illustration generators write (`sim_mnts` writes another layout,
    five items, which neither package's loader takes)."""
    path = tmp_path / "sim_illustration_low_freq.pickle"
    made = tsim.sim_illustration_low_freq(seed=3, save_path=str(path))
    got, want = tdata.load_sim_pickle(str(path)), jdata.load_sim_pickle(str(path))
    for g_list, w_list, m_list in zip(got, want, made):
        assert_equal_arrays(g_list, w_list)
        assert_equal_arrays(g_list, m_list)
    tsim.sim_mnts(N=10, seed=1, save_path=str(tmp_path / "mnts.pickle"))
    for load in (tdata.load_sim_pickle, jdata.load_sim_pickle):
        with pytest.raises(ValueError):
            load(str(tmp_path / "mnts.pickle"))
