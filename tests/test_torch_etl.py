"""The port's ETL (`utils/etl.py`) against the JAX package's, array for
array: the raw-file loaders on the fixtures of `tests/test_etl.py` (the
synthetic Beijing CSV, HCP table and Hilbert pickle), the format sniffing of
`load_workload_data`, the ECoG prediction split, the same-shape synthetic
surrogates and the surrogate channel IDs, each with `np.array_equal`."""

import pickle

import numpy as np
import pytest

from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import etl as jetl
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import etl as tetl
from test_etl import ecog_pickle, hcp_txt, pm25_csv  # noqa: F401  (the JAX tests' fixtures)


def _equal(got, want):
    """Two nests of lists/tuples of arrays hold equal arrays of one dtype."""
    assert type(got) is type(want) and len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (list, tuple)):
            _equal(g, w)
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype
            assert np.array_equal(g, w)


def test_constants_are_copies():
    assert tetl.PM25_ATTRIBUTES == jetl.PM25_ATTRIBUTES
    rng = np.random.default_rng(0)
    a = rng.standard_normal(50) * 3 + 1
    assert np.array_equal(tetl._standardize(a), jetl._standardize(a))


@pytest.mark.parametrize("kw", [{}, {"sub_rows": 5000}, {"sub_rows": 5000, "seed": 3}])
def test_etl_pm25_matches_jax(pm25_csv, kw):  # noqa: F811
    _equal(tetl.etl_pm25(str(pm25_csv), **kw), jetl.etl_pm25(str(pm25_csv), **kw))


@pytest.mark.parametrize("transposed", [False, True])
def test_etl_hcp_matches_jax(hcp_txt, tmp_path, transposed):  # noqa: F811
    path = hcp_txt
    if transposed:
        path = tmp_path / "transposed.txt"
        np.savetxt(path, np.loadtxt(hcp_txt).T, fmt="%.6f", delimiter=" ")
    _equal(tetl.etl_hcp(str(path)), jetl.etl_hcp(str(path)))
    _equal(tetl.etl_hcp(str(path), seed=4), jetl.etl_hcp(str(path), seed=4))


@pytest.mark.parametrize("kw", [{}, {"channel_indexes": [3, 1]},
                                {"time_start": 1.0, "time_stop": 2.5, "rate": 200.0}])
def test_etl_ecog_and_its_split_match_jax(ecog_pickle, kw):  # noqa: F811
    path, _ = ecog_pickle
    got, want = tetl.etl_ecog(str(path), **kw), jetl.etl_ecog(str(path), **kw)
    _equal(got, want)
    for seed in (22, 5):
        _equal(tetl.ecog_pred_split(*got, seed=seed), jetl.ecog_pred_split(*want, seed=seed))


def test_load_workload_data_routes_like_jax(pm25_csv, hcp_txt, ecog_pickle, tmp_path):  # noqa: F811
    path, band = ecog_pickle
    blob3 = tmp_path / "r32b7.pickle"
    with open(blob3, "wb") as f:
        pickle.dump([np.arange(band.shape[0]) / 400.0, band, np.array([[14.0, 16.0]])], f)
    presplit = tmp_path / "presplit.pickle"
    with open(presplit, "wb") as f:
        pickle.dump([[np.arange(5.0), np.arange(4.0)], [np.ones(5), np.zeros(4)],
                     [np.arange(2.0), np.empty(0)], [np.ones(2), np.empty(0)]], f)
    cases = [("pm25", pm25_csv, False), ("pm25", pm25_csv, True), ("hcp", hcp_txt, False),
             ("ecog", path, False), ("ecog", blob3, False), ("hcp", presplit, False)]
    for workload, p, full in cases:
        _equal(tetl.load_workload_data(workload, str(p), full=full),
               jetl.load_workload_data(workload, str(p), full=full))


def test_load_workload_data_rejects_garbage_like_jax(tmp_path):
    p = tmp_path / "junk.pickle"
    with open(p, "wb") as f:
        pickle.dump({"not": "a dataset"}, f)
    for etl in (tetl, jetl):
        with pytest.raises(ValueError, match="unrecognized data file"):
            etl.load_workload_data("pm25", str(p))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name, kw", [("synthetic_pm25", {}), ("synthetic_pm25", {"full": True}),
                                      ("synthetic_hcp", {}),
                                      ("synthetic_ecog", {"n_channel": 8, "n_steps": 100}),
                                      ("synthetic_ecog", {})])
def test_synthetic_surrogates_bit_for_bit(name, kw, seed):
    _equal(getattr(tetl, name)(seed=seed, **kw), getattr(jetl, name)(seed=seed, **kw))


@pytest.mark.parametrize("n_channel", [25, 78, 128])
def test_surrogate_channel_indexes_bit_for_bit(n_channel):
    got = tetl.surrogate_ecog_channel_indexes(n_channel)
    assert got.dtype == jetl.surrogate_ecog_channel_indexes(n_channel).dtype
    assert np.array_equal(got, jetl.surrogate_ecog_channel_indexes(n_channel))
