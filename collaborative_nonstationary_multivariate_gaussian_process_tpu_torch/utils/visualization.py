"""Per-variant predictive plot family + synthetic-truth overlays.

The port's own copy of the JAX package's `utils/visualization.py`
(importing that module would run the JAX package's `__init__`): the
reference's plotting surface in host-side matplotlib, fed NumPy arrays
(a tensor on the card goes through `.cpu().numpy()` first):

  - `plot_posterior`               — reference `Plot_posterior`
    (SIM_code/Utility/visualization.py:20-44)
  - `plot_posterior_hadamard`      — `Plot_posterior_hadamard` (:47-65)
  - `plot_posterior_train_test`    — `Plot_posterior_trainandtest` (:68-103)
  - `plot_posterior_train_test_non`— `Plot_posterior_trainandtest_non`
    (:106-127, heterotopic per-output lists)
  - `plot_process_overlay`         — the `synthetic_plot.py:101-142`
    true-vs-initialized-vs-inferred overlay for the log-lengthscale,
    correlation, and std processes
  - `samples2quantiles`            — `visualization.py:9-17`

Every function returns the figure list (callers may save or embed);
passing `save_path`/`save_dir` writes PNGs like the reference did.
matplotlib is imported on the first figure (`_plt`); without it a figure
raises an ImportError that says so, and nothing else of the port needs it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "samples2quantiles",
    "plot_posterior",
    "plot_posterior_hadamard",
    "plot_posterior_train_test",
    "plot_posterior_train_test_non",
    "plot_process_overlay",
]


def _plt():
    """matplotlib's pyplot on the Agg backend, imported on first use."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("writing figures needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def samples2quantiles(pos_sample, percentiles=(2.5, 50.0, 97.5)):
    """Samples (N_grid, S, M) -> quantiles (P, N_grid, M) — reduces AXIS 1
    (the reference's visualization.py:9-17 convention).

    NB: `utils.posterior_analysis.samples2quantiles` reduces axis 0 (the
    reference's posterior-analysis convention, draws leading).  Both
    mirror their reference namesakes; pick the module matching your array
    layout.
    """
    return np.percentile(np.asarray(pos_sample), q=list(percentiles), axis=1)


def _save(fig, save_dir, name):
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        fig.savefig(os.path.join(save_dir, name))


def plot_posterior(
    x, Y, grids, pos_quantile, save_dir: Optional[str] = None,
    attributes: Optional[Sequence] = None, type: str = "MAP",
):
    """Pointwise posterior predictive bands per output
    (reference `Plot_posterior`, visualization.py:20-44).

    x: (N,); Y: (N, M); grids: (G,); pos_quantile: (3, G, M).
    """
    plt = _plt()
    x, Y = np.asarray(x), np.asarray(Y)
    q = np.asarray(pos_quantile)
    M = Y.shape[1]
    if attributes is None:
        attributes = [f"y{m + 1}" for m in range(M)]
    figs = []
    for m in range(M):
        fig = plt.figure()
        plt.scatter(x, Y[:, m])
        plt.plot(grids, q[1, :, m], color="b")
        plt.plot(grids, q[[0, 2], :, m].T, color="r", linestyle="dashed")
        plt.xlabel("x", fontsize=22)
        plt.ylabel(f"y{m + 1}", rotation=0, fontsize=22)
        plt.tight_layout()
        _save(fig, save_dir, f"Pos_pred_{attributes[m]}_{type}.png")
        figs.append(fig)
        plt.close(fig)
    return figs


def plot_posterior_hadamard(
    x, indx, y, grids, pos_quantile, save_dir: Optional[str] = None,
    attributes: Optional[Sequence] = None,
):
    """Heterotopic variant: flat (x, y) with an output index per point
    (reference `Plot_posterior_hadamard`, visualization.py:47-65)."""
    plt = _plt()
    x, y, indx = np.asarray(x), np.asarray(y), np.asarray(indx)
    q = np.asarray(pos_quantile)
    cats = np.unique(indx)
    if attributes is None:
        attributes = [f"y{int(m) + 1}" for m in range(q.shape[-1])]
    figs = []
    for m in cats:
        mi = int(m)
        fig = plt.figure()
        plt.scatter(x[indx == m], y[indx == m])
        plt.plot(grids, q[1, :, mi], color="b")
        plt.plot(grids, q[[0, 2], :, mi].T, color="r")
        plt.xlabel("x", fontsize=22)
        plt.ylabel(f"y{mi + 1}", rotation=0, fontsize=22)
        plt.tight_layout()
        _save(fig, save_dir, f"Pos_pred_{attributes[mi]}.png")
        figs.append(fig)
        plt.close(fig)
    return figs


def plot_posterior_train_test(
    x, Y, grids, pos_quantile, x_test, Y_test, Y_pred,
    save_dir: Optional[str] = None, with_obs: bool = True,
    attributes: Optional[Sequence] = None, type: str = "MAP",
):
    """Train scatter + test truth/prediction + filled predictive band
    (reference `Plot_posterior_trainandtest`, visualization.py:68-103)."""
    plt = _plt()
    x, Y = np.asarray(x), np.asarray(Y)
    q = np.asarray(pos_quantile)
    M = Y.shape[1]
    if attributes is None:
        attributes = np.arange(M) + 1
    figs = []
    for m in range(M):
        fig = plt.figure()
        plt.scatter(x, Y[:, m], label="training data")
        if with_obs:
            plt.scatter(x_test, np.asarray(Y_test)[:, m], label="ground truth data")
            plt.scatter(x_test, np.asarray(Y_pred)[:, m], label="predicted data")
        plt.plot(grids, q[1, :, m], color="orange", label="predictive mean")
        plt.fill_between(
            grids, q[0, :, m], q[2, :, m], color="r", alpha=0.2,
            label="predictive 95% confidence interval",
        )
        s = np.max(Y[:, m]) - np.min(Y[:, m])
        plt.ylim(np.min(Y[:, m]) - 0.15 * s, np.max(Y[:, m]) + 0.8 * s)
        plt.xlabel("time (hour)", fontsize=22)
        plt.ylabel(f"{attributes[m]}", fontsize=22)
        plt.legend(fontsize=16, loc="upper right")
        plt.tight_layout()
        _save(fig, save_dir, f"Pos_pred_{attributes[m]}_{type}.png")
        figs.append(fig)
        plt.close(fig)
    return figs


def plot_posterior_train_test_non(
    x_train_list, y_train_list, grids, y_grids_quantile_list,
    x_test_list, y_test_list, pred_test_list,
    save_dir: Optional[str] = None, attributes: Optional[Sequence] = None,
    type: str = "MAP",
):
    """Heterotopic per-output-list variant (reference
    `Plot_posterior_trainandtest_non`, visualization.py:106-127)."""
    plt = _plt()
    figs = []
    if attributes is None:
        attributes = [f"y{d}" for d in range(len(x_train_list))]
    for d, (x_tr, y_tr, q, x_te, y_te, y_pr) in enumerate(
        zip(x_train_list, y_train_list, y_grids_quantile_list,
            x_test_list, y_test_list, pred_test_list)
    ):
        q = np.asarray(q)
        fig = plt.figure()
        plt.scatter(x_tr, y_tr, label="training data")
        plt.scatter(x_te, y_te, label="ground truth data")
        plt.scatter(x_te, y_pr, label="predicted data")
        plt.plot(grids, q[1, :], color="b")
        plt.plot(grids, q[[0, 2], :].T, color="r")
        s = np.max(y_tr) - np.min(y_tr)
        plt.ylim(np.min(y_tr) - 2 * s, np.max(y_tr) + 2 * s)
        plt.xlabel("x", fontsize=15)
        plt.ylabel(f"y{d}", rotation=0, fontsize=15)
        plt.legend(fontsize=12, loc=1)
        _save(fig, save_dir, f"Pos_pred_{attributes[d]}_{type}.png")
        figs.append(fig)
        plt.close(fig)
    return figs


def plot_process_overlay(
    x, true, est, init=None, quantiles=None, ylabel="process",
    save_path: Optional[str] = None,
):
    """True vs initialized vs inferred overlay of a latent process
    (reference synthetic_plot.py:101-142 — the log-lengthscale,
    correlation, and std panels all share this shape).

    quantiles: optional (2, N) lower/upper band around the inferred curve
    (the reference overlays MAP curves only; samplers get a band).
    """
    plt = _plt()
    fig = plt.figure()
    plt.plot(x, true, label="true")
    if init is not None:
        plt.plot(x, init, "--", label="initialized")
    plt.plot(x, est, "--", label="inferred")
    if quantiles is not None:
        q = np.asarray(quantiles)
        plt.fill_between(np.asarray(x).reshape(-1), q[0], q[1], alpha=0.2)
    plt.legend(fontsize=16)
    plt.xlabel("x", fontsize=22)
    plt.ylabel(ylabel, fontsize=22)
    plt.tight_layout()
    if save_path is not None:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path)
    plt.close(fig)
    return fig
