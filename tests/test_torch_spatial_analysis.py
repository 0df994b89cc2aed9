"""The port's ECoG electrode-grid spatial correlation analysis
(`utils/posterior_analysis.py`) against the JAX package's on the same
correlation stacks (exactly), and the behavioural tests of
`tests/test_spatial_analysis.py` on the port: a correlation field that
depends only on the grid distance gives every direction curve the
distance-1 value and the distance curves the decay; an anisotropic one
keeps row and column neighbours apart."""

import numpy as np
import pytest

from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import (
    posterior_analysis as jpa,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
    posterior_analysis as tpa,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.etl import (
    surrogate_ecog_channel_indexes,
)

GRID = tpa.ECOG_GRID_CHANNEL_IDS


def test_grid_is_a_copy():
    assert np.array_equal(GRID, jpa.ECOG_GRID_CHANNEL_IDS)
    ids = surrogate_ecog_channel_indexes(78)
    assert np.array_equal(tpa._grid_to_output_index(GRID, ids),
                          jpa._grid_to_output_index(jpa.ECOG_GRID_CHANNEL_IDS, ids))


@pytest.mark.parametrize("D, G, seed", [(25, 20, 0), (78, 7, 1), (40, 1, 2)])
def test_curves_equal_the_jax_ones(D, G, seed):
    rng = np.random.default_rng(seed)
    ids = surrogate_ecog_channel_indexes(D)
    if D == 40:  # another order of the outputs
        ids = rng.permutation(ids)
    est = np.tanh(rng.standard_normal((G, D, D)))
    got = tpa.direction_correlation_curves(est, GRID, ids)
    want = jpa.direction_correlation_curves(est, GRID, ids)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    got = tpa.distance_correlation_curves(est, GRID, ids, dists=(1, 2, 3, 4))
    want = jpa.distance_correlation_curves(est, GRID, ids, dists=(1, 2, 3, 4))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_a_missing_electrode_raises():
    with pytest.raises(ValueError, match="not present in channel_indexes"):
        tpa.direction_correlation_curves(np.zeros((1, 24, 24)), GRID,
                                         surrogate_ecog_channel_indexes(25)[1:])


def _distance_decay_corrs(channel_indexes, G=7, decay=0.25):
    """(G, D, D) correlation stack: corr = exp(-decay * grid_distance) * f(t)
    for electrodes on the 5x5 grid, 0 elsewhere; f(t) = 1 + t/10."""
    D = len(channel_indexes)
    pos = {}
    cd = {int(c): k for k, c in enumerate(channel_indexes)}
    for i in range(5):
        for j in range(5):
            pos[cd[int(GRID[i, j])]] = (i, j)
    base = np.zeros((D, D))
    for a, (ia, ja) in pos.items():
        for b, (ib, jb) in pos.items():
            base[a, b] = np.exp(-decay * np.hypot(ia - ib, ja - jb))
    t = np.arange(G) / 10.0
    return base[None, :, :] * (1.0 + t)[:, None, None]


def test_surrogate_channel_indexes_cover_grid():
    ids = surrogate_ecog_channel_indexes(78)
    assert len(ids) == 78 and len(set(ids.tolist())) == 78
    assert set(np.unique(GRID).tolist()) <= set(ids.tolist())


def test_direction_curves_match_distance_one():
    ids = surrogate_ecog_channel_indexes(78)
    curves = tpa.direction_correlation_curves(_distance_decay_corrs(ids), GRID, ids)
    assert set(curves) == {"left", "top", "right", "bottom"}
    expected = np.exp(-0.25) * (1.0 + np.arange(7) / 10.0)
    for name, c in curves.items():
        assert c.shape == (7,)
        np.testing.assert_allclose(c, expected, rtol=1e-12, err_msg=name)


def test_distance_curves_recover_decay():
    ids = surrogate_ecog_channel_indexes(78)
    curves = tpa.distance_correlation_curves(_distance_decay_corrs(ids), GRID, ids, dists=(1, 2, 3))
    f = 1.0 + np.arange(7) / 10.0
    for d in (1, 2, 3):
        np.testing.assert_allclose(curves[d], np.exp(-0.25 * d) * f, rtol=1e-12)
    assert np.all(curves[1] > curves[2])
    assert np.all(curves[2] > curves[3])


def test_direction_asymmetry_is_respected():
    """Row neighbours correlate 0.6, column neighbours 0.2: left/right read
    the row offsets and top/bottom the column offsets."""
    ids = surrogate_ecog_channel_indexes(78)
    cd = {int(c): k for k, c in enumerate(ids)}
    corr = np.zeros((1, len(ids), len(ids)))
    for i in range(5):
        for j in range(5):
            a = cd[int(GRID[i, j])]
            if i + 1 < 5:
                b = cd[int(GRID[i + 1, j])]
                corr[0, a, b] = corr[0, b, a] = 0.6
            if j + 1 < 5:
                b = cd[int(GRID[i, j + 1])]
                corr[0, a, b] = corr[0, b, a] = 0.2
    curves = tpa.direction_correlation_curves(corr, GRID, ids)
    np.testing.assert_allclose(curves["left"], [0.6])
    np.testing.assert_allclose(curves["right"], [0.6])
    np.testing.assert_allclose(curves["top"], [0.2])
    np.testing.assert_allclose(curves["bottom"], [0.2])
