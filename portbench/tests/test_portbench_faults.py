"""The check catches a broken timed path: each run skips the look for a card,
drives the rest of a run at tiny sizes on the CPU with one fault planted in
the port, and must read `correct` false.  The faults a cell can have: a
step that returns its state unchanged; half of the batch left out (the
mean taken over the rest); an answer altered where it is produced; for the
sampler also a proposal one leapfrog short and a bias on the new position.  No
cell runs over several chips, so none can leave an exchange out."""

from __future__ import annotations

from argparse import Namespace

import pytest
import torch

from portbench import run

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import (  # noqa: E402
    chees,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (  # noqa: E402
    cnmgp,
    predict,
)


def _result(root, cell, seed=5):
    return run.execute(Namespace(workload=cell, seed=seed, seconds=0.3, trace=0), root=root,
                       device="cpu")


# -- DSVI training --------------------------------------------------------


def _train_unchanged(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _train_half_batch(mp):
    selbo = cnmgp.negative_selbo

    def half(params, Z, x, y, idx, weight, *a, **k):
        weight = weight.clone()
        weight[weight.shape[0] // 2:] = 0.0
        return selbo(params, Z, x, y, idx, weight, *a, **k)

    mp.setattr(cnmgp, "negative_selbo", half)


def _train_altered(mp):
    selbo = cnmgp.negative_selbo
    mp.setattr(cnmgp, "negative_selbo", lambda *a, **k: 1.01 * selbo(*a, **k))


# -- serving --------------------------------------------------------------


def _serve_half_batch(mp):
    mean = predict.predict_Y

    def half(*a, **k):
        out = mean(*a, **k).clone()
        out[out.shape[0] // 2:] = 0.0
        return out

    mp.setattr(predict, "predict_Y", half)


def _serve_altered(mp):
    draws = predict.sample_Y

    def altered(*a, **k):
        ys, *rest = draws(*a, **k)
        ys = ys.clone()
        ys[:, 0] *= 2.0
        return (ys, *rest)

    mp.setattr(predict, "sample_Y", altered)


# -- ChEES sampling -------------------------------------------------------


def _chees_unchanged(mp):
    kernel = chees._chees_kernel

    def unchanged(log_prob_fn, state, *a, **k):
        _, aps, mean_acc, g, n = kernel(log_prob_fn, state, *a, **k)
        return state, aps, mean_acc, g, n

    mp.setattr(chees, "_chees_kernel", unchanged)


def _chees_half_chains(mp):
    kernel = chees._chees_kernel

    def half(log_prob_fn, state, *a, **k):
        new, aps, mean_acc, g, n = kernel(log_prob_fn, state, *a, **k)
        h = state.position.shape[0] // 2
        keep = lambda a, b: torch.cat([a[:h], b[h:]])  # noqa: E731
        return chees.CheesState(*(keep(x, y) for x, y in zip(new, state))), aps, mean_acc, g, n

    mp.setattr(chees, "_chees_kernel", half)


def _chees_short(mp):
    """The proposal one leapfrog short, while the count reads n."""
    count, kernel = chees._num_steps, chees._chees_kernel
    mp.setattr(chees, "_num_steps", lambda *a: count(*a) - 1)

    def reads_n(*a, **k):
        *out, n = kernel(*a, **k)
        return (*out, n + 1)

    mp.setattr(chees, "_chees_kernel", reads_n)


def _chees_bias(mp):
    """Each moved chain's new position off by a tenth of the posterior scale."""
    kernel = chees._chees_kernel

    def biased(log_prob_fn, state, draws, eps, traj_len, inv_mass, *a, **k):
        new, *rest = kernel(log_prob_fn, state, draws, eps, traj_len, inv_mass, *a, **k)
        moved = (new.position != state.position).any(-1, keepdim=True)
        shifted = torch.where(moved, new.position + 0.1 * torch.sqrt(inv_mass), new.position)
        return (new._replace(position=shifted), *rest)

    mp.setattr(chees, "_chees_kernel", biased)


def _chees_altered(mp):
    vg = chees.value_and_grad

    def flipped(fn, q):
        lp, g = vg(fn, q)
        return lp, -g

    mp.setattr(chees, "value_and_grad", flipped)


FAULTS = [
    ("ecog.train", _train_unchanged), ("ecog.train", _train_half_batch),
    ("ecog.train", _train_altered), ("ecog.serve", _serve_half_batch),
    ("ecog.serve", _serve_altered), ("svc.chees1024", _chees_unchanged),
    ("svc.chees1024", _chees_half_chains), ("svc.chees1024", _chees_altered),
    ("svc.chees1024", _chees_short), ("svc.chees1024", _chees_bias),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_caught(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _result(tiny_root, cell)
    assert r["correct"] is False, r["checks"]
