"""Posterior-sample analysis in NumPy: history unpackers, cov -> corr and
the correlation processes of the Cholesky vecs, quantile summaries, the
ECoG electrode-grid spatial correlation analysis, and matplotlib figures.

The port's own copy of the JAX package's `utils/posterior_analysis.py`
(reference `SIM_code/Utility/posterior_analysis.py` and the spatial
analysis of NMGP_ECoG_full.py:456-546): importing that module would run
the JAX package's `__init__`.  matplotlib is imported only by the figures
(`visualization._plt`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .visualization import _plt

__all__ = [
    "unpack_hist_snmgp",
    "unpack_hist_svc",
    "unpack_hist_lmc",
    "unpack_est_snmgp",
    "unpack_est_svc",
    "unpack_est_lmc",
    "cov2cor",
    "samples2quantiles",
    "lvecs_to_corr",
    "plot_mean_and_ci",
    "plot_posterior_bands",
    "plot_correlation_heatmaps",
    "ECOG_GRID_CHANNEL_IDS",
    "direction_correlation_curves",
    "distance_correlation_curves",
    "plot_spatial_correlation",
]


# The reference ECoG workload's 5x5 electrode grid, as electrode IDs into the
# 128-channel array (reference NMGP_ECoG_full.py:465 `matrix_index`).  Rows
# index one grid axis, columns the other; combined with `channel_indexes`
# (the 78 retained channels) it localizes each modeled output on the cortex.
ECOG_GRID_CHANNEL_IDS = np.array(
    [
        [53, 51, 49, 26, 18],
        [52, 50, 48, 24, 16],
        [74, 76, 78, 102, 110],
        [75, 77, 79, 100, 108],
        [91, 93, 95, 98, 106],
    ]
)


def _grid_to_output_index(matrix_index, channel_indexes):
    """(5, 5) electrode-ID grid -> (5, 5) output-dimension indices via the
    channel_indexes id->position map (reference `channel_dict`,
    NMGP_ECoG_full.py:460-462)."""
    matrix_index = np.asarray(matrix_index)
    channel_dict = {int(cid): i for i, cid in enumerate(np.asarray(channel_indexes))}
    try:
        return np.vectorize(lambda cid: channel_dict[int(cid)])(matrix_index)
    except KeyError as e:  # pragma: no cover - config error path
        raise ValueError(
            f"grid electrode id {e} not present in channel_indexes"
        ) from None


def direction_correlation_curves(est_corrs, matrix_index, channel_indexes):
    """Mean inferred-correlation time curve between each electrode and its
    {left, top, right, bottom} grid neighbor.

    est_corrs: (G, D, D) posterior-mean correlation matrices on a time grid
    (mean over `sample_FY` draws).  Returns {"left": (G,), "top": ..,
    "right": .., "bottom": ..}.  Matches the reference's direction analysis
    (NMGP_ECoG_full.py:468-511): "top" is j+1, "bottom" j-1, "right" i+1,
    "left" i-1 in grid coordinates.
    """
    est_corrs = np.asarray(est_corrs)
    grid = _grid_to_output_index(matrix_index, channel_indexes)
    n_grid = grid.shape[0]
    curves = {"left": [], "top": [], "right": [], "bottom": []}
    for i in range(n_grid):
        for j in range(grid.shape[1]):
            c = grid[i, j]
            if i - 1 >= 0:
                curves["left"].append(est_corrs[:, c, grid[i - 1, j]])
            if j + 1 < grid.shape[1]:
                curves["top"].append(est_corrs[:, c, grid[i, j + 1]])
            if i + 1 < n_grid:
                curves["right"].append(est_corrs[:, c, grid[i + 1, j]])
            if j - 1 >= 0:
                curves["bottom"].append(est_corrs[:, c, grid[i, j - 1]])
    return {k: np.stack(v).mean(axis=0) for k, v in curves.items()}


def distance_correlation_curves(
    est_corrs, matrix_index, channel_indexes, dists=(1, 2, 3)
):
    """Mean inferred-correlation time curve for electrode pairs at grid
    distance d (axis-aligned: right and top offsets), for each d in `dists`.

    Returns {d: (G,)}.  Matches the reference's distance analysis
    (NMGP_ECoG_full.py:513-544 `analysis_dist`).
    """
    est_corrs = np.asarray(est_corrs)
    grid = _grid_to_output_index(matrix_index, channel_indexes)
    n_grid = grid.shape[0]
    out = {}
    for dist in dists:
        pair_curves = []
        for i in range(n_grid - dist):
            for j in range(grid.shape[1] - dist):
                c = grid[i, j]
                pair_curves.append(est_corrs[:, c, grid[i + dist, j]])
                pair_curves.append(est_corrs[:, c, grid[i, j + dist]])
        out[int(dist)] = np.stack(pair_curves).mean(axis=0)
    return out


def plot_spatial_correlation(
    times,
    direction_curves,
    distance_curves,
    save_dir,
    prefix="ecog",
):
    """Save the two reference figures: the 3x3 compass layout of neighbor
    direction curves (`corrs.png`, NMGP_ECoG_full.py:499-510) and the
    per-distance row (`corrs_dist.png`, :526-544).  Returns the two paths."""
    import os

    plt = _plt()
    os.makedirs(save_dir, exist_ok=True)
    times = np.asarray(times)

    fig, axes = plt.subplots(nrows=3, ncols=3, figsize=(9, 7))
    for ax in axes.ravel():
        ax.axis("off")
    placement = {"top": (0, 1), "left": (1, 0), "right": (1, 2), "bottom": (2, 1)}
    for name, (r, c) in placement.items():
        ax = axes[r, c]
        ax.axis("on")
        ax.plot(times, direction_curves[name])
        ax.set_title(name)
    path_dir = os.path.join(save_dir, f"{prefix}_corrs.png")
    fig.tight_layout()
    fig.savefig(path_dir)
    plt.close(fig)

    dists = sorted(distance_curves)
    fig, axes = plt.subplots(nrows=1, ncols=len(dists), figsize=(4 * len(dists), 4))
    axes = np.atleast_1d(axes)
    for ax, d in zip(axes, dists):
        ax.plot(times, distance_curves[d])
        ax.set_xlabel("Time")
        ax.set_ylabel("Correlation coefficient")
        ax.set_title(f"distance {d}")
    path_dist = os.path.join(save_dir, f"{prefix}_corrs_dist.png")
    fig.tight_layout()
    fig.savefig(path_dist)
    plt.close(fig)
    return path_dir, path_dist


def _tri_size(m):
    return m * (m + 1) // 2


def _lvec_to_tril_np(v, m):
    L = np.zeros(v.shape[:-1] + (m, m))
    r, c = np.tril_indices(m)
    L[..., r, c] = v
    return L


def _uvec_to_lvec_np(u, m):
    """exp on the diagonal entries of a tril vec (`ops.linalg.uvec_to_lvec`)."""
    mask = np.zeros(u.shape[-1], dtype=bool)
    mask[np.cumsum(np.arange(1, m + 1)) - 1] = True
    return np.where(mask, np.exp(u), u)


def unpack_hist_snmgp(pars_hist, N, M):
    """(S, dim) -> (tilde_l (S, N), tilde_sigma (S, N), uL_vec (S, T),
    tilde_sigma2_err (S,)) (reference `vec2pars`, posterior_analysis.py:59-68)."""
    pars_hist = np.asarray(pars_hist)
    T = _tri_size(M)
    return (pars_hist[:, :N], pars_hist[:, N:2 * N], pars_hist[:, 2 * N:2 * N + T],
            pars_hist[:, -1])


def unpack_hist_svc(pars_hist, N, M):
    """Reference `vec2pars_SVC` (posterior_analysis.py:70-77)."""
    pars_hist = np.asarray(pars_hist)
    T = _tri_size(M)
    return pars_hist[:, :N], pars_hist[:, N:N + N * T], pars_hist[:, -1]


def unpack_hist_lmc(pars_hist, M):
    """Reference `vec2pars_S` (posterior_analysis.py:79-88)."""
    pars_hist = np.asarray(pars_hist)
    T = _tri_size(M)
    return pars_hist[:, 0], pars_hist[:, 1], pars_hist[:, 2:2 + T], pars_hist[:, -1]


def unpack_est_snmgp(pars, N, M):
    """Point-estimate unpacker (posterior_analysis.py:15-24)."""
    return unpack_hist_snmgp(np.asarray(pars)[None], N, M)


def unpack_est_svc(pars, N, M):
    return unpack_hist_svc(np.asarray(pars)[None], N, M)


def unpack_est_lmc(pars, M):
    return unpack_hist_lmc(np.asarray(pars)[None], M)


def cov2cor(S):
    """Covariance -> correlation (posterior_analysis.py:47-56), batched."""
    S = np.asarray(S)
    d = 1.0 / np.sqrt(np.diagonal(S, axis1=-2, axis2=-1))
    return S * d[..., :, None] * d[..., None, :]


def lvecs_to_corr(uL_vecs, N, M, constrained=False):
    """Per-point (unconstrained, unless `constrained`) Cholesky vecs
    (..., N*T) -> (..., N, M, M) correlation matrices (the
    correlation-process recovery of synthetic_plot.py:101-142)."""
    T = _tri_size(M)
    u = np.asarray(uL_vecs).reshape(np.shape(uL_vecs)[:-1] + (N, T))
    lv = u if constrained else _uvec_to_lvec_np(u, M)
    L = _lvec_to_tril_np(lv, M)
    return cov2cor(L @ np.swapaxes(L, -1, -2))


def samples2quantiles(pos_sample, percentiles=(2.5, 50.0, 97.5)):
    """(S, ...) -> (len(percentiles), ...) (posterior_analysis.py:90-98)."""
    return np.percentile(np.asarray(pos_sample), q=list(percentiles), axis=0)


def plot_mean_and_ci(x, mean, lb, ub, color_mean="b", color_shading="r", ax=None):
    """Credible-band line plot (posterior_analysis.py:101-106)."""
    plt = _plt()
    if ax is None:
        ax = plt.gca()
    ax.fill_between(x, ub, lb, color=color_shading, alpha=0.3)
    ax.plot(x, mean, color=color_mean)
    return ax


def plot_posterior_bands(
    x,
    Y,
    grids,
    pos_quantile,
    x_test=None,
    Y_test=None,
    save_path: Optional[str] = None,
    attributes: Optional[Sequence[str]] = None,
):
    """Posterior predictive band plots per output (visualization.py:20-101)."""
    plt = _plt()
    Y = np.asarray(Y)
    M = Y.shape[1]
    fig, axes = plt.subplots(M, 1, figsize=(8, 2.5 * M), squeeze=False)
    for m in range(M):
        ax = axes[m, 0]
        ax.scatter(x, Y[:, m], s=8, label="train")
        ax.plot(grids, pos_quantile[1, :, m], color="b")
        ax.plot(grids, pos_quantile[0, :, m], color="r", linestyle="dashed")
        ax.plot(grids, pos_quantile[2, :, m], color="r", linestyle="dashed")
        if x_test is not None:
            ax.scatter(x_test, np.asarray(Y_test)[:, m], s=8, color="k", label="test")
        ax.set_ylabel(attributes[m] if attributes else f"y{m + 1}")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_correlation_heatmaps(
    x,
    R_fs=None,
    L_vecs=None,
    N: Optional[int] = None,
    M: Optional[int] = None,
    attributes: Optional[Sequence[str]] = None,
    save_dir: Optional[str] = None,
    constrained: bool = True,
):
    """Per-input-point correlation-matrix heatmaps
    (`visualization_pos_map_heatmap{,_withR_s}`,
    reference posterior_analysis.py:221-268).

    Either pass correlation matrices `R_fs` (N, M, M) directly, or the flat
    per-point Cholesky vectors `L_vecs` (N*T,) plus (N, M) to build them
    (cov2cor of L Lᵀ).  Points are sorted by x like the reference.  Diverging
    colormap centered at 0, fixed to [-1, 1].  If `save_dir` is given, one
    PNG per point (index-prefixed, labeled by its x value) is written
    there; returns (x_sorted, R_fs_sorted).
    """
    import os

    plt = _plt()
    x = np.asarray(x).reshape(-1)
    order = np.argsort(x)
    x = x[order]
    if R_fs is None:
        if L_vecs is None or N is None or M is None:
            raise ValueError(
                "plot_correlation_heatmaps needs either R_fs (N, M, M) or "
                "L_vecs together with N and M"
            )
        R_fs = lvecs_to_corr(np.asarray(L_vecs).reshape(-1), N, M, constrained)
    R_fs = np.asarray(R_fs)[order]
    Mdim = R_fs.shape[-1]
    labels = list(attributes) if attributes else [f"y{m + 1}" for m in range(Mdim)]

    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        for n in range(x.shape[0]):
            fig, ax = plt.subplots(figsize=(4.5, 4))
            im = ax.imshow(R_fs[n], vmin=-1.0, vmax=1.0, cmap="RdBu_r")
            ax.set_xticks(range(Mdim))
            ax.set_yticks(range(Mdim))
            ax.set_xticklabels(labels, rotation=45, ha="right")
            ax.set_yticklabels(labels)
            ax.set_title(f"x = {x[n]:.4g}")
            fig.colorbar(im, ax=ax, fraction=0.046)
            # index prefix: duplicate x values must not overwrite each other
            fig.savefig(
                os.path.join(save_dir, f"{n:04d}_{x[n]:.6g}.png"),
                bbox_inches="tight",
            )
            plt.close(fig)
    return x, R_fs
