"""ETL pipelines for the real-data workloads (PM2.5 / HCP / ECoG).

The port's own NumPy copy of the JAX package's `utils/etl.py` (importing
that module would run the JAX package's `__init__`); every function gives
the same arrays, from the same `np.random.RandomState` calls.  Ports of the
reference's ETL notebooks (code/notebook/{PM25,HCP,ECoG}.ipynb; raw data is
not shipped with the reference either, ReadMe.txt:7).  Each loader accepts
the raw file when present and otherwise raises; the `synthetic_*`
generators produce same-shape surrogates so the workload drivers run end to
end without the private data.

Shapes:
  PM25 sub  28,768 train / 942 test observations, 6 attributes
  PM25 full 302,537 / 10,077
  HCP       71,040 / 960, 15 series x 4,800 time steps
  ECoG      78 channels x 800 steps (400 Hz window of 120,000 x 128)
"""

from __future__ import annotations

import pickle
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "etl_pm25",
    "etl_hcp",
    "etl_ecog",
    "ecog_pred_split",
    "load_workload_data",
    "synthetic_pm25",
    "synthetic_hcp",
    "synthetic_ecog",
    "surrogate_ecog_channel_indexes",
]

# The six modeled attributes, as named in the Beijing CSV header
# (notebook/PM25.ipynb cell 3: `attributes = ['PM_US Post', 'DEWP', 'HUMI',
# 'PRES', 'TEMP', 'Iws']`).
PM25_ATTRIBUTES = ("PM_US Post", "DEWP", "HUMI", "PRES", "TEMP", "Iws")


def _standardize(a):
    """sklearn `preprocessing.scale` semantics: zero mean, unit (population)
    std — the notebooks standardize every series this way."""
    return (a - np.mean(a)) / np.std(a)


def _holdout_first_output(X_list, Y_list, n_rows, test_index):
    """The notebooks' split shape: hold out rows of OUTPUT 0 only; every
    other output keeps all of its observations (PM25.ipynb cell 5/6,
    HCP.ipynb cell 4)."""
    train_index = np.setdiff1d(np.arange(n_rows), test_index)
    Xt = [X_list[0][test_index]] + [np.array([]) for _ in X_list[1:]]
    Yt = [Y_list[0][test_index]] + [np.array([]) for _ in Y_list[1:]]
    Xtr = [X_list[0][train_index]] + list(X_list[1:])
    Ytr = [Y_list[0][train_index]] + list(Y_list[1:])
    return Xtr, Ytr, Xt, Yt


def etl_pm25(csv_path: str, sub_rows: Optional[int] = None, seed: int = 0):
    """Beijing PM2.5 CSV -> (X_list, Y_list, Xt_list, Yt_list).

    Mirrors notebook/PM25.ipynb exactly:
      - attributes `PM_US Post, DEWP, HUMI, PRES, TEMP, Iws` (cell 3);
      - input coordinate = the `No` row-number column at each attribute's
        non-NaN positions (cell 3);
      - per-attribute standardization AFTER the NaN drop (cell 3);
      - `sub_rows=5000` restricts to the FIRST 5000 rows (the "sub"
        dataset, cell 3 `df.iloc[:5000]`);
      - test split = random 20% of attribute 0 (PM_US Post) only; all other
        attributes fully in train (cells 5-6).  Committed shape oracles:
        full 302,537 train / 10,077 test; sub 28,768 / 942.
    """
    import csv as _csv

    with open(csv_path) as f:
        rows = list(_csv.DictReader(f))
    if sub_rows:
        rows = rows[:sub_rows]
    no = np.array([float(r["No"]) for r in rows])
    X_list, Y_list = [], []
    for name in PM25_ATTRIBUTES:
        raw = np.array(
            [
                float(r[name]) if r[name] not in ("", "NA", "NaN") else np.nan
                for r in rows
            ]
        )
        keep = np.isfinite(raw)
        X_list.append(no[keep])
        Y_list.append(_standardize(raw[keep]))
    n0 = X_list[0].shape[0]
    rng = np.random.RandomState(seed)
    test_index = rng.choice(n0, int(0.2 * n0), replace=False)
    return _holdout_first_output(X_list, Y_list, n0, test_index)


def etl_hcp(txt_path: str, seed: int = 0):
    """HCP motor-task series file (whitespace table, time x series) ->
    (X_list, Y_list, Xt_list, Yt_list).

    Mirrors notebook/HCP.ipynb exactly: each of the M series standardized on
    the shared `arange(N)` time axis (cell 3); test split = random 20% of
    SERIES 0 only (cell 4).  Committed shape oracle for 4800 x 15:
    71,040 train / 960 test."""
    arr = np.loadtxt(txt_path)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.shape[0] < arr.shape[1]:
        arr = arr.T  # (time, series)
    N, M = arr.shape
    t = np.arange(N, dtype=float)
    X_list = [t] * M
    Y_list = [_standardize(arr[:, i]) for i in range(M)]
    rng = np.random.RandomState(seed)
    test_index = rng.choice(N, int(0.2 * N), replace=False)
    return _holdout_first_output(X_list, Y_list, N, test_index)


def etl_ecog(
    pickle_path: str,
    time_start: float = 14.0,
    time_stop: float = 16.0,
    rate: float = 400.0,
    channel_indexes: Optional[Sequence[int]] = None,
):
    """Hilbert high-gamma ECoG pickle -> windowed, z-scored channel lists.

    Mirrors `load_ECoG` (reference NMGP_ECoG_full.py:78-144): take the
    [time_start, time_stop) window at `rate` Hz, per-channel z-score,
    integer-timestamp inputs.
    """
    with open(pickle_path, "rb") as f:
        blob = pickle.load(f)
    times, band_resps = blob[0], blob[1]
    n = int((time_stop - time_start) * rate)
    start_idx = int(time_start * rate)
    window = band_resps[start_idx : start_idx + n]
    N, M = window.shape
    if channel_indexes is None:
        channel_indexes = list(range(M))
    X_list, Y_list = [], []
    for c in channel_indexes:
        X_list.append(np.arange(N, dtype=float))
        Y_list.append(_standardize(window[:, c]))
    return X_list, Y_list


def ecog_pred_split(X_list, Y_list, seed: int = 22):
    """The ECoG prediction protocol's split: hold out a random 20% of the
    LAST channel; all other channels stay fully in train
    (reference NMGP_ECoG_pred.py:24-51 `create_datasets`).

    Returns (X_train_list, Y_train_list, Xt_list, Yt_list) where the test
    lists are empty for every channel but the last."""
    rng = np.random.RandomState(seed)
    x_last = np.asarray(X_list[-1])
    y_last = np.asarray(Y_list[-1])
    te = np.sort(rng.choice(len(x_last), len(x_last) // 5, replace=False))
    tr = np.setdiff1d(np.arange(len(x_last)), te)
    Xt_list = [np.empty(0)] * (len(X_list) - 1) + [x_last[te]]
    Yt_list = [np.empty(0)] * (len(Y_list) - 1) + [y_last[te]]
    return (
        list(X_list[:-1]) + [x_last[tr]],
        list(Y_list[:-1]) + [y_last[tr]],
        Xt_list,
        Yt_list,
    )


def load_workload_data(workload: str, path: str, full: bool = False):
    """Route a user-supplied data file to the matching raw-format loader.

    Accepted formats per workload (the notebooks' own inputs):
      pm25: the Beijing CSV (`BeijingPM20100101_20151231.csv`,
            notebook/PM25.ipynb cell 1) — `full=False` restricts to the
            first 5000 rows (the "sub" dataset, cell 3);
      hcp:  the `990366_15.txt` whitespace table (HCP.ipynb cell 1);
      ecog: either the raw Hilbert high-gamma pickle
            (`R32_B{7,8}_Hilb_54bands_ECoG_high_gamma.pickle`,
            `(times, band_resps[, time_trials])` — NMGP_ECoG_pred.py:104-111),
            windowed+split per the prediction protocol, or a pre-split
            `[X, Y, Xt, Yt]` pickle.
    Any workload also accepts a pre-split 4-list pickle.
    Returns (X_list, Y_list, Xt_list, Yt_list)."""
    low = path.lower()
    if low.endswith(".csv"):
        return etl_pm25(path, sub_rows=None if full else 5000)
    if low.endswith(".txt"):
        return etl_hcp(path)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if isinstance(blob, (list, tuple)) and len(blob) == 4 and isinstance(blob[0], list):
        return tuple(blob)  # pre-split [X_list, Y_list, Xt_list, Yt_list]
    if workload == "ecog":
        X_list, Y_list = etl_ecog(path)
        return ecog_pred_split(X_list, Y_list)
    raise ValueError(
        f"unrecognized data file for workload {workload!r}: {path} — expected "
        "a raw notebook input (.csv/.txt/Hilbert pickle) or a pre-split "
        "[X, Y, Xt, Yt] pickle"
    )


# ---------------------------------------------------------------------------
# Same-shape synthetic surrogates (raw data is private)
# ---------------------------------------------------------------------------


def _synthetic_multioutput(n_per_out, n_test_per_out, D, t_max, seed, freq=3.0):
    rng = np.random.RandomState(seed)
    phases = rng.uniform(0, 2 * np.pi, D)
    amps = 1.0 + rng.rand(D)
    X_list, Y_list, Xt_list, Yt_list = [], [], [], []
    for d in range(D):
        x = np.sort(rng.rand(n_per_out[d])) * t_max
        xt = np.sort(rng.rand(n_test_per_out[d])) * t_max
        f = lambda t: amps[d] * np.sin(freq * 2 * np.pi * t / t_max + phases[d]) * (
            1 + 0.5 * np.cos(2 * np.pi * t / t_max)
        )
        X_list.append(x)
        Y_list.append(f(x) + 0.3 * rng.standard_normal(x.shape[0]))
        Xt_list.append(xt)
        Yt_list.append(f(xt) + 0.3 * rng.standard_normal(xt.shape[0]))
    return X_list, Y_list, Xt_list, Yt_list


def synthetic_pm25(seed=0, full=False):
    """PM25-shaped surrogate over 6 outputs.

    full=False: 28,768/942 obs (the "sub" dataset, notebook/PM25.ipynb
    cell 6).  full=True: 302,537/10,077 obs with the notebook's real
    per-attribute sizes and output-0-only test split (cell 5): train
    {40310, 52579, 52245, 52245, 52579, 52579}, test {10077, 0, ...}."""
    if full:
        per = [40310, 52579, 52245, 52245, 52579, 52579]
        pert = [10077, 0, 0, 0, 0, 0]
        return _synthetic_multioutput(per, pert, 6, t_max=52584.0, seed=seed)
    per = [28768 // 6] * 6
    per[0] += 28768 - sum(per)
    pert = [942 // 6] * 6
    pert[0] += 942 - sum(pert)
    return _synthetic_multioutput(per, pert, 6, t_max=2400.0, seed=seed)


def synthetic_hcp(seed=0):
    """71,040/960 obs over 15 series x 4800 steps (HCP shape)."""
    per = [71040 // 15] * 15
    pert = [960 // 15] * 15
    return _synthetic_multioutput(per, pert, 15, t_max=4800.0, seed=seed)


def synthetic_ecog(seed=0, n_channel=78, n_steps=800):
    """78 channels x 800 steps (ECoG full-train shape; no test split)."""
    X_list, Y_list, _, _ = _synthetic_multioutput(
        [n_steps] * n_channel, [1] * n_channel, n_channel, t_max=float(n_steps), seed=seed
    )
    return X_list, Y_list


def surrogate_ecog_channel_indexes(n_channel=78):
    """Deterministic surrogate for the private `78_channel_indexes.pickle`
    (reference NMGP_ECoG_full.py:202-205): electrode IDs into the 128-channel
    array for each modeled output.  The real set is unknown, but it must
    contain all 25 electrode IDs of the 5x5 analysis grid
    (`posterior_analysis.ECOG_GRID_CHANNEL_IDS`) — so the surrogate places
    the grid IDs first (sorted) and fills with the lowest remaining IDs."""
    from .posterior_analysis import ECOG_GRID_CHANNEL_IDS

    grid_ids = sorted(int(v) for v in np.unique(ECOG_GRID_CHANNEL_IDS))
    rest = [i for i in range(128) if i not in set(grid_ids)]
    ids = (grid_ids + rest)[:n_channel]
    if len(ids) < n_channel:  # pragma: no cover - n_channel > 128
        raise ValueError(f"cannot build {n_channel} surrogate channel ids")
    return np.asarray(ids)
