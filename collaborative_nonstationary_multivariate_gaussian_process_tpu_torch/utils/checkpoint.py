"""Checkpoint save/resume of the training state (the JAX package's
`utils/checkpoint.py`; the reference's `torch.save({'epoch',
'model_state_dict', 'optimizer_state_dict', 'loss'}, PATH)` and its resume,
nmgp_dsvi.py:789-792, 893-899).

The file is the JAX package's pickle, so a model trained by either package
resumes and predicts in the other:

    {"epoch": int, "loss": float, "params": [...], "opt_state": [...]}

`params` holds one NumPy array per `CNMGPParams` field, in field order, and
`opt_state` the leaves of the optax state in optax's order
(`infer.optimizers.optax_state` builds them from a torch optimizer).  A
tree here is a tensor, or a tuple, list, named tuple or dict of trees (a
dict in sorted key order, as JAX flattens it); its leaves are the tensors.

bfloat16 arrays (the moments of `optimizer="adam_bf16"`, or a save with
`moments_dtype=torch.bfloat16`) are stored as the JAX package stores them,
`ml_dtypes.bfloat16` NumPy arrays.  `ml_dtypes` is imported only to write
or read such a file, and its absence then raises ImportError: a file is
never written in another format.  Loading unpickles the file, which can run
code: load only checkpoints that this package or the JAX package wrote.

`backend="orbax"`, the JAX package's multi-host directory checkpoint, is a
`torch.distributed.checkpoint` directory here, with the same call
signature: {"epoch", "loss", "params", "opt_state"}, the leaves by their
index, each in its own dtype (bfloat16 included, without ml_dtypes).
Every rank of the process group calls the save: the leaves are the same on
every rank (replicated training state), and `torch.distributed.checkpoint`
writes each once.  The save is atomic: it writes `path + ".tmp"`, then rank
0 swaps it in for `path` by two renames, so an interrupted save leaves the
previous checkpoint (at `path`, or at `path + ".old"` between the two
renames, where a load finds it).  A load, at any world size (one process
without a group included), restores the same bits.  It does not read an
orbax directory that the JAX package wrote (the card's machine has no
orbax): the pickle is the file both packages share.
"""

from __future__ import annotations

import os
import pickle
import shutil
import time
from typing import Any, List, Tuple

import numpy as np
import torch

from ..models.cnmgp import pack_U

__all__ = ["LAST_IO_SECONDS", "save_train_state", "load_train_state", "save_pytree", "load_pytree"]

# Wall-clock seconds of the most recent save and load in this process.
LAST_IO_SECONDS = {"save": None, "load": None}


def _ml_dtypes():
    try:
        import ml_dtypes
    except ImportError as e:
        raise ImportError(
            "bfloat16 checkpoint arrays are ml_dtypes.bfloat16 NumPy arrays, as the JAX package "
            "writes them: reading or writing one needs the ml_dtypes package"
        ) from e
    return ml_dtypes


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [] if tree is None else [tree]


def _unflatten(like, leaves):
    """`leaves` in the structure of `like` (consumed from the front)."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        items = [_unflatten(t, leaves) for t in like]
        return type(like)(*items) if hasattr(like, "_fields") else type(like)(items)
    return None if like is None else leaves.pop(0)


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_ml_dtypes().bfloat16)
    return t.numpy()


def _from_numpy(a) -> torch.Tensor:
    a = np.asarray(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, its name, or a NumPy or JAX dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return getattr(torch, name.removeprefix("torch."))


def _pickle_load(path: str):
    with open(path, "rb") as f:
        try:
            return pickle.load(f)
        except ImportError as e:
            if (e.name or "").split(".")[0] == "ml_dtypes":
                _ml_dtypes()
            raise


def save_pytree(path: str, tree) -> None:
    leaves = _leaves(tree)
    with open(path, "wb") as f:
        pickle.dump({"leaves": [_to_numpy(t) for t in leaves],
                     "treedef": f"{type(tree).__name__} of {len(leaves)} leaves"}, f)


def load_pytree(path: str, like):
    """Load leaves saved by `save_pytree` (of either package) into the
    structure of `like`, as tensors."""
    return _unflatten(like, [_from_numpy(a) for a in _pickle_load(path)["leaves"]])


def save_train_state(path: str, params, opt_state, epoch: int = 0, loss: float = 0.0,
                     backend: str = "pickle", moments_dtype=None) -> None:
    """Save `params` and the optax leaves `opt_state`.  `moments_dtype`
    (e.g. torch.bfloat16) casts the optimizer state's floating leaves on
    the device before they are fetched, as the JAX package does; the
    parameters always keep their precision, and `load_train_state`
    restores each leaf's dtype from the state it is given."""
    t0 = time.time()
    try:
        if backend not in ("pickle", "orbax"):
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        if moments_dtype is not None:
            dt = _torch_dtype(moments_dtype)
            opt_state = [t.to(dt) if t.is_floating_point() else t for t in _leaves(opt_state)]
        if backend == "orbax":
            _save_dir(path, {
                "epoch": torch.tensor(int(epoch)),
                "loss": torch.tensor(float(loss), dtype=torch.float64),
                "params": _indexed(params),
                "opt_state": _indexed(opt_state),
            })
            return
        state = {
            "epoch": epoch,
            "loss": loss,
            "params": [_to_numpy(t) for t in _leaves(params)],
            "opt_state": [_to_numpy(t) for t in _leaves(opt_state)],
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)
    finally:
        LAST_IO_SECONDS["save"] = time.time() - t0


def load_train_state(path: str, params_like, opt_state_like, backend: str = "pickle") -> Tuple[Any, Any]:
    """(params, opt_state) from `path`, in the structures, dtypes and on the
    devices of `params_like` and `opt_state_like`; a legacy dense-U layout
    is packed (`_migrate_layout`)."""
    t0 = time.time()
    try:
        if backend == "orbax":
            state = _load_dir(path)
            state = {k: [v[str(i)] for i in range(len(v))]
                     for k, v in ((k, state.get(k, {})) for k in ("params", "opt_state"))}
        elif backend == "pickle":
            state = _pickle_load(path)
            state = {k: [_from_numpy(a) for a in state[k]] for k in ("params", "opt_state")}
        else:
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        return tuple(_restore(state[key], like, key)
                     for key, like in (("params", params_like), ("opt_state", opt_state_like)))
    finally:
        LAST_IO_SECONDS["load"] = time.time() - t0


def _indexed(tree):
    """The leaves of `tree` as CPU tensors keyed by their index."""
    return {str(i): t.detach().cpu() for i, t in enumerate(_leaves(tree))}


def _barrier():
    if torch.distributed.is_initialized():
        torch.distributed.barrier()


def _save_dir(path: str, state: dict) -> None:
    """Write `state` with `torch.distributed.checkpoint` to `path + ".tmp"`,
    then swap it in for `path` (rank 0, two renames)."""
    import torch.distributed.checkpoint as dcp

    rank0 = not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0
    tmp, old = path + ".tmp", path + ".old"
    if rank0:
        shutil.rmtree(tmp, ignore_errors=True)
    _barrier()
    dcp.save(state, checkpoint_id=tmp, no_dist=not torch.distributed.is_initialized())
    _barrier()
    if rank0:
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    _barrier()


def _load_dir(path: str) -> dict:
    """The nested state of a `_save_dir` directory, each leaf in its saved
    shape and dtype on the CPU (from `path`, or from `path + ".old"` where a
    save stopped between its renames)."""
    import torch.distributed.checkpoint as dcp

    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        path = path + ".old"
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    state: dict = {}
    for key, m in meta.items():
        *outer, leaf = key.split(".")
        node = state
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = torch.empty(tuple(m.size), dtype=m.properties.dtype)
    dcp.load(state, checkpoint_id=path, no_dist=not torch.distributed.is_initialized())
    return state


def _restore(tensors, like, what: str):
    refs = _leaves(like)
    if len(tensors) != len(refs):
        raise ValueError(
            f"checkpoint {what} holds {len(tensors)} leaves where this state has {len(refs)}: "
            f"it was saved with other optimizer options"
        )
    leaves = _migrate_layout(tensors, refs)
    return _unflatten(like, [t.to(device=r.device, dtype=r.dtype) for t, r in zip(leaves, refs)])


def _migrate_layout(leaves, refs):
    """Legacy checkpoints hold dense (D, D, M[, M]) `mu_U`/`sqrt_U` leaves
    (and matching Adam moments) where the current layout has packed
    (D(D+1)/2, M[, M]) ones: such a leaf is packed by `pack_U`; any other
    shape mismatch raises."""
    out = []
    for leaf, ref in zip(leaves, refs):
        rs = tuple(ref.shape)
        if tuple(leaf.shape) != rs:
            s = tuple(leaf.shape)
            if not (len(s) == len(rs) + 1 and len(s) >= 2 and s[0] == s[1]
                    and s[0] * (s[0] + 1) // 2 == rs[0] and s[2:] == rs[1:]):
                raise ValueError(f"checkpoint leaf shape {s} does not match current layout {rs} "
                                 "— unsupported legacy checkpoint layout")
            leaf = pack_U(leaf)
        out.append(leaf)
    return out
