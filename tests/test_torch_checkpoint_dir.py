"""The directory checkpoint of the port (`utils/checkpoint.py`,
`backend="orbax"`, a `torch.distributed.checkpoint` directory): saved by
two ranks of a gloo group on the CPU and loaded back there, then loaded in
this process (world 1, no group), every leaf bit for bit, a bf16 moment
included; an interrupted save leaves the previous checkpoint; and
`inference()` saves and resumes through the pickle as before."""

import os

import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.launch import (
    spawn,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
    checkpoint as tckpt,
)

TESTS = os.path.dirname(os.path.abspath(__file__))


def _state(seed):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal((3, 5)), rng.standard_normal(7), np.array(-1.5)]
    opt = [np.array(12, dtype=np.int32), rng.standard_normal((3, 5)).astype(np.float32),
           rng.standard_normal(7)]
    return params, opt


def test_save_at_two_ranks_loads_bit_for_bit_at_two_and_one(tmp_path):
    params, opt = _state(0)
    npz = tmp_path / "state.npz"
    np.savez(npz, n_params=len(params), n_opt=len(opt),
             **{f"p{i}": a for i, a in enumerate(params)}, **{f"o{i}": a for i, a in enumerate(opt)})
    path = str(tmp_path / "ckpt")
    with pytest.MonkeyPatch.context() as mp:  # the children import torch_rank_bodies
        mp.setenv("PYTHONPATH", TESTS, prepend=os.pathsep)
        results = spawn("torch_rank_bodies:checkpoint_rank", 2,
                        {"path": path, "state": str(npz)}, timeout=180)
    assert all(r["same"] for r in results)
    assert results[0]["dtypes"][-1] == "torch.bfloat16"
    assert os.path.isdir(path) and not os.path.exists(path + ".tmp")

    want_p = [torch.as_tensor(a) for a in params]
    want_o = [torch.as_tensor(a) for a in opt]
    want_o[-1] = want_o[-1].to(torch.bfloat16)
    lp, lo = tckpt.load_train_state(path, [torch.zeros_like(t) for t in want_p],
                                    [torch.zeros_like(t) for t in want_o], backend="orbax")
    for got, want in zip(lp + lo, want_p + want_o):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_an_interrupted_save_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    import torch.distributed.checkpoint as dcp

    path = str(tmp_path / "ckpt")
    params, opt = ([torch.as_tensor(a) for a in s] for s in _state(1))
    tckpt.save_train_state(path, params, opt, epoch=3, backend="orbax")
    like = ([torch.zeros_like(t) for t in params], [torch.zeros_like(t) for t in opt])

    def dies_midway(state, checkpoint_id, **kwargs):
        os.makedirs(checkpoint_id)
        open(os.path.join(checkpoint_id, "__0_0.distcp"), "wb").close()
        raise KeyboardInterrupt

    monkeypatch.setattr(dcp, "save", dies_midway)
    newer = [t + 1 for t in params]
    with pytest.raises(KeyboardInterrupt):
        tckpt.save_train_state(path, newer, opt, epoch=4, backend="orbax")
    lp, lo = tckpt.load_train_state(path, *like, backend="orbax")
    assert all(torch.equal(a, b) for a, b in zip(lp + lo, params + opt))

    # stopped between the two renames: the previous one is at path + ".old"
    monkeypatch.undo()
    os.replace(path, path + ".old")
    lp, _ = tckpt.load_train_state(path, *like, backend="orbax")
    assert all(torch.equal(a, b) for a, b in zip(lp, params))
    tckpt.save_train_state(path, newer, opt, epoch=4, backend="orbax")
    lp, _ = tckpt.load_train_state(path, *like, backend="orbax")
    assert all(torch.equal(a, b) for a, b in zip(lp, newer))
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


def test_unknown_backend_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        tckpt.save_train_state(str(tmp_path / "x"), [torch.zeros(1)], [], backend="tensorstore")
    with pytest.raises(FileNotFoundError):
        tckpt.load_train_state(str(tmp_path / "none"), [torch.zeros(1)], [], backend="orbax")
