"""Data handling on the host (a NumPy copy of the JAX package's
`utils/data.py`, every public function).

  - heterotopic flattening: per-output lists of inputs and observations
    become one flat (x, y, idx) triple, as the reference's concatenation +
    index tagging does (nmgp_dsvi.py:762-770);
  - the simulation pickle loader (nmgp_dsvi.py:968-984);
  - the train/test splits (SIM_code/Utility/utils.py:91-162).  The JAX
    package's `data_split` and `data_split_non` call scikit-learn's
    `train_test_split`; the port does not import scikit-learn and makes
    the same shuffled split itself (`_shuffled_split`);
  - detrending and its inverse (preprocess_realdata.py:6-65).
"""

from __future__ import annotations

import math
import pickle
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "FlatData",
    "flatten_output_lists",
    "unflatten_to_lists",
    "load_sim_pickle",
    "data_split",
    "data_split_non",
    "data_split_non_chunk",
    "data_split_extrapolation",
    "orig2adj",
    "adj2orig",
    "orig2adj_lists",
    "adj2orig_lists",
]


@dataclass
class FlatData:
    """Flattened heterotopic multi-output data."""

    x: np.ndarray  # (N,) float
    y: np.ndarray  # (N,) float
    idx: np.ndarray  # (N,) int32 output index
    dim_outputs: int

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def lists(self) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        return unflatten_to_lists(self.x, self.y, self.idx, self.dim_outputs)


def flatten_output_lists(X_list: Sequence, Y_list: Sequence) -> FlatData:
    """Per-output lists -> flat (x, y, idx)."""
    D = len(X_list)
    xs, ys, idxs = [], [], []
    for d in range(D):
        x = np.asarray(X_list[d]).reshape(-1)
        y = np.asarray(Y_list[d]).reshape(-1)
        xs.append(x)
        ys.append(y)
        idxs.append(np.full(x.shape[0], d, dtype=np.int32))
    return FlatData(
        x=np.concatenate(xs),
        y=np.concatenate(ys),
        idx=np.concatenate(idxs),
        dim_outputs=D,
    )


def unflatten_to_lists(x, y, idx, dim_outputs):
    X_list = [np.asarray(x)[np.asarray(idx) == d] for d in range(dim_outputs)]
    Y_list = [np.asarray(y)[np.asarray(idx) == d] for d in range(dim_outputs)]
    return X_list, Y_list


def load_sim_pickle(path: str):
    """Load a `sim_illustration_*` pickle: [X_list, Y_list, Xt_list, Yt_list]
    (format produced by reference SIM_code/sim.py:123-124).  Unpickling runs
    code from the file: load only pickles this program wrote."""
    with open(path, "rb") as f:
        X_list, Y_list, Xt_list, Yt_list = pickle.load(f)
    return X_list, Y_list, Xt_list, Yt_list


# ---------------------------------------------------------------------------
# Splits (host-side NumPy; mirrors SIM_code/Utility/utils.py:91-162)
# ---------------------------------------------------------------------------


def _split_sizes(n, test_size):
    """(n_train, n_test) as scikit-learn's `train_test_split` sizes them: a
    float test_size in (0, 1) holds out ceil(test_size * n) rows, an int
    one that many; the rest are the train set."""
    kind = np.asarray(test_size).dtype.kind
    if kind == "f" and 0 < test_size < 1:
        n_test = math.ceil(test_size * n)
    elif kind == "i" and 0 < test_size < n:
        n_test = int(test_size)
    else:
        raise ValueError(f"test_size={test_size} should be either positive and smaller than the "
                         f"number of samples {n} or a float in the (0, 1) range")
    if n - n_test == 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size} the train set is empty")
    return n - n_test, n_test


def _shuffled_split(arrays, test_size, random_state, shuffle):
    """scikit-learn's `train_test_split(*arrays, test_size=...,
    random_state=..., shuffle=...)`, as its `ShuffleSplit` draws it: the
    permutation of `RandomState(random_state)` (an int seed, a RandomState,
    or None for NumPy's global one), its first n_test indices the test set
    and the next n_train the train set; unshuffled, the first n_train rows
    train.  Returns [a_train, a_test] for each array, in order."""
    n = len(arrays[0])
    if any(len(a) != n for a in arrays):
        raise ValueError(f"arrays of inconsistent lengths {[len(a) for a in arrays]}")
    n_train, n_test = _split_sizes(n, test_size)
    if shuffle:
        if isinstance(random_state, np.random.RandomState):
            rng = random_state
        elif random_state is None:
            rng = np.random.mtrand._rand
        else:
            rng = np.random.RandomState(random_state)
        perm = rng.permutation(n)
        train, test = perm[n_test:n_test + n_train], perm[:n_test]
    else:
        train, test = np.arange(n_train), np.arange(n_train, n_train + n_test)
    return [part for a in arrays for part in (np.asarray(a)[train], np.asarray(a)[test])]


def data_split(x, Y, test_size=0.25, random_state=22, shuffle=True):
    """Random split + reorder by x (reference utils.py:137-154)."""
    x_train, x_test, Y_train, Y_test = _shuffled_split((x, Y), test_size, random_state, shuffle)
    ti = np.argsort(x_train)
    si = np.argsort(x_test)
    return x_train[ti], x_test[si], Y_train[ti], Y_test[si]


def data_split_non(x, indx, y, test_size=0.25, random_state=22, shuffle=True):
    """Heterotopic random split (reference utils.py:91-103): [x_train,
    x_test, indx_train, indx_test, y_train, y_test]."""
    return _shuffled_split((x, indx, y), test_size, random_state, shuffle)


def data_split_non_chunk(x, indx, y, chunk_size=0.2, random_state=22, fix=False):
    """Per-task contiguous-chunk holdout (reference utils.py:106-134)."""
    M = len(np.unique(indx))
    parts = {k: [] for k in ("xtr", "xte", "itr", "ite", "ytr", "yte")}
    rng = np.random.RandomState(random_state)
    for m in range(M):
        x_m = x[indx == m]
        y_m = y[indx == m]
        n_m = x_m.shape[0]
        n_te = int(chunk_size * n_m)
        n_tr = n_m - n_te
        s = int(np.floor(m * n_tr / (M - 1))) if fix else rng.choice(n_tr)
        tr = np.concatenate([np.arange(0, s), np.arange(s + n_te, n_m)])
        te = np.arange(s, s + n_te)
        parts["xtr"].append(x_m[tr])
        parts["xte"].append(x_m[te])
        parts["itr"].append(m * np.ones(n_tr))
        parts["ite"].append(m * np.ones(n_te))
        parts["ytr"].append(y_m[tr])
        parts["yte"].append(y_m[te])
    return tuple(
        np.concatenate(parts[k]) for k in ("xtr", "xte", "itr", "ite", "ytr", "yte")
    )


def data_split_extrapolation(x, Y, size=5):
    """Last-`size` holdout (reference utils.py:157-162)."""
    return x[:-size], x[-size:], Y[:-size], Y[-size:]


# ---------------------------------------------------------------------------
# Detrend / normalize (reference preprocess_realdata.py:6-65)
# ---------------------------------------------------------------------------


def orig2adj(Y):
    trend = np.mean(Y, axis=0)
    adjY = Y - trend
    scale = np.std(adjY, axis=0)
    return adjY / scale, trend, scale


def adj2orig(adjY, trend, scale):
    return adjY * scale + trend


def orig2adj_lists(y_list):
    adj, trends, scales = [], [], []
    for y in y_list:
        t = np.mean(y)
        a = y - t
        s = np.std(a)
        adj.append(a / s)
        trends.append(t)
        scales.append(s)
    return adj, trends, scales


def adj2orig_lists(adj_y_list, trend_list, scale_list):
    return [a * s + t for a, t, s in zip(adj_y_list, trend_list, scale_list)]
