"""The port's figures and empirical-estimate I/O: every `Plot_posterior*`
port renders and writes its PNGs under the JAX package's file names
(`tests/test_visualization.py`), the correlation heatmaps and the spatial
analysis figures write theirs, the `empirical_est.pickle` layout round-trips
and either package loads the other's file bit for bit
(`tests/test_baselines_utils.py:124,201`), and a figure without matplotlib
raises instead of being skipped."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import empirical as jemp
from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import (
    posterior_analysis as jpa,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import (
    visualization as jvis,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import empirical as temp
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
    posterior_analysis as tpa,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
    visualization as tvis,
)


def test_samples2quantiles_shape_and_copy():
    s = np.random.default_rng(0).standard_normal((30, 50, 2))
    q = tvis.samples2quantiles(s)
    assert q.shape == (3, 30, 2)
    assert np.all(q[0] <= q[1]) and np.all(q[1] <= q[2])
    assert np.array_equal(q, jvis.samples2quantiles(s))


def _plot_family(vis, root):
    """test_visualization.py's calls; returns the files each wrote."""
    rng = np.random.default_rng(1)
    N, G, M = 25, 40, 2
    x = np.sort(rng.random(N))
    Y = rng.standard_normal((N, M))
    grids = np.linspace(0, 1, G)
    q = vis.samples2quantiles(rng.standard_normal((G, 60, M)))
    xt = np.sort(rng.random(10))
    Yt = rng.standard_normal((10, M))
    indx = rng.integers(0, M, N)
    counts = {
        "iso": len(vis.plot_posterior(x, Y, grids, q, save_dir=str(root / "iso"),
                                      attributes=["a", "b"])),
        "had": len(vis.plot_posterior_hadamard(x, indx, Y[:, 0], grids, q,
                                               save_dir=str(root / "had"))),
        "tt": len(vis.plot_posterior_train_test(x, Y, grids, q, xt, Yt, Yt + 0.1,
                                                save_dir=str(root / "tt"), attributes=["u", "v"])),
        "non": len(vis.plot_posterior_train_test_non(
            [x, x], [Y[:, 0], Y[:, 1]], grids, [q[:, :, 0], q[:, :, 1]], [xt, xt],
            [Yt[:, 0], Yt[:, 1]], [Yt[:, 0], Yt[:, 1]], save_dir=str(root / "non"))),
    }
    path = root / "ov" / "overlay.png"
    xo = np.linspace(0, 1, 50)
    vis.plot_process_overlay(xo, np.sin(xo), np.sin(xo) + 0.05, init=np.cos(xo),
                             quantiles=np.stack([np.sin(xo) - 0.2, np.sin(xo) + 0.2]),
                             ylabel="log lengthscale", save_path=str(path))
    files = {d: sorted(os.listdir(root / d)) for d in ("iso", "had", "tt", "non", "ov")}
    return counts, files, len(np.unique(indx))


def test_plot_posterior_family_writes_the_jax_packages_pngs(tmp_path):
    counts, files, n_had = _plot_family(tvis, tmp_path / "port")
    j_counts, j_files, _ = _plot_family(jvis, tmp_path / "jax")
    assert counts == j_counts and files == j_files
    assert counts == {"iso": 2, "had": n_had, "tt": 2, "non": 2}
    assert files["iso"] == ["Pos_pred_a_MAP.png", "Pos_pred_b_MAP.png"]
    assert files["ov"] == ["overlay.png"]
    for d, names in files.items():
        assert all(os.path.getsize(tmp_path / "port" / d / n) > 0 for n in names)


def test_correlation_heatmaps(tmp_path):
    rng = np.random.default_rng(9)
    N, M = 4, 3
    L_vecs = rng.standard_normal(N * M * (M + 1) // 2)
    x = rng.random(N)
    xs, R = tpa.plot_correlation_heatmaps(x, L_vecs=L_vecs, N=N, M=M, save_dir=str(tmp_path / "c"))
    jxs, jR = jpa.plot_correlation_heatmaps(x, L_vecs=L_vecs, N=N, M=M, save_dir=str(tmp_path / "j"))
    assert R.shape == (N, M, M)
    assert np.all(np.diff(xs) >= 0)
    np.testing.assert_allclose(np.diagonal(R, axis1=1, axis2=2), 1.0, atol=1e-12)
    assert np.all(np.abs(R) <= 1 + 1e-12)
    np.testing.assert_allclose(R, jR, rtol=1e-12)
    assert sorted(os.listdir(tmp_path / "c")) == sorted(os.listdir(tmp_path / "j"))
    assert len(list((tmp_path / "c").glob("*.png"))) == N
    with pytest.raises(ValueError, match="needs either R_fs"):
        tpa.plot_correlation_heatmaps(x)


def test_spatial_and_band_figures(tmp_path):
    rng = np.random.default_rng(2)
    t = np.linspace(0, 1, 12)
    direction = {k: rng.standard_normal(12) for k in ("left", "top", "right", "bottom")}
    distance = {d: rng.standard_normal(12) for d in (1, 2, 3)}
    paths = tpa.plot_spatial_correlation(t, direction, distance, str(tmp_path / "s"))
    assert [os.path.basename(p) for p in paths] == ["ecog_corrs.png", "ecog_corrs_dist.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)
    q = np.sort(rng.standard_normal((3, 12, 2)), axis=0)
    tpa.plot_posterior_bands(t, rng.standard_normal((12, 2)), t, q, x_test=t[:3],
                             Y_test=rng.standard_normal((3, 2)), save_path=str(tmp_path / "b.png"))
    assert os.path.getsize(tmp_path / "b.png") > 0
    ax = tpa.plot_mean_and_ci(t, q[1, :, 0], q[0, :, 0], q[2, :, 0])
    assert len(ax.lines) == 1


def _estimates():
    rng = np.random.default_rng(0)
    N = 60
    x = np.linspace(0.0, 1.0, N)
    Y = np.stack([np.sin(6 * x) + 0.1 * rng.standard_normal(N),
                  np.cos(6 * x) + 0.1 * rng.standard_normal(N)], axis=1)
    return x, Y, temp.local_estimation(x, Y, window_size=10)


def test_empirical_save_load_plot_roundtrip(tmp_path):
    x, Y, est = _estimates()
    N, M = Y.shape
    p = temp.save_estimates(str(tmp_path / "empirical_est.pickle"), est)
    tilde_ls, smooth_tilde_ls, L_vecs, ts2e = temp.load_estimates(p)
    assert tilde_ls.shape == (N,)
    np.testing.assert_allclose(tilde_ls, np.log(est["ls"]))
    assert L_vecs.shape == (N * (M * (M + 1) // 2),)
    np.testing.assert_allclose(L_vecs, est["L_vecs"].ravel())
    assert ts2e == -4.0
    assert np.all(np.isfinite(smooth_tilde_ls))
    paths = temp.plot_estimates(x, Y, est, str(tmp_path / "figs"))
    j_paths = jemp.plot_estimates(x, Y, est, str(tmp_path / "jfigs"))
    assert [os.path.basename(q) for q in paths] == [os.path.basename(q) for q in j_paths]
    assert len(paths) == 4 and all(os.path.getsize(q) > 0 for q in paths)


@pytest.mark.parametrize("writer, reader", [(temp, jemp), (jemp, temp)], ids=["port_to_jax", "jax_to_port"])
def test_either_package_loads_the_others_estimates(tmp_path, writer, reader):
    _, _, est = _estimates()
    est = dict(est, tilde_sigma2_err=-3.5)
    p = writer.save_estimates(str(tmp_path / "empirical_est.pickle"), est)
    got, want = reader.load_estimates(p), writer.load_estimates(p)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[3] == -3.5
    again = reader.save_estimates(str(tmp_path / "again.pickle"), est)
    assert Path(p).read_bytes() == Path(again).read_bytes()


def test_a_figure_without_matplotlib_raises(monkeypatch, tmp_path):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    x = np.linspace(0, 1, 5)
    with pytest.raises(ImportError, match="matplotlib"):
        tvis.plot_process_overlay(x, x, x, save_path=str(tmp_path / "o.png"))
    with pytest.raises(ImportError, match="matplotlib"):
        tpa.plot_spatial_correlation(x, {}, {}, str(tmp_path))
    assert not (tmp_path / "o.png").exists()
