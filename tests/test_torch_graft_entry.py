"""The port's `drivers/graft_entry.py` against the JAX package's
`__graft_entry__.py`: `entry()`'s negative SELBO from the JAX entry's
parameters, carried across by `models.cnmgp.params_from_numpy`, on the JAX
entry's inputs and its key's noise (`jax_train_noise`), both in float32 on
the CPU, at rtol 1e-5; and `dryrun_multichip(2)` on the CPU (two ranks of a
gloo group), which prints the JAX dry run's OK line."""

import re

import jax
import numpy as np
import torch

import __graft_entry__ as jge
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
    graft_entry as tge,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp as tc
from torch_port_helpers import jax_train_noise

torch.set_num_threads(1)


def test_entry_matches_the_jax_entry_on_carried_params():
    jfn, (jparams, Z, x, y, idx, w, key) = jge.entry()
    want = float(jax.jit(jfn)(jparams, Z, x, y, idx, w, key))
    tfn, targs = tge.entry(device="cpu")
    assert [tuple(a.shape) for a in targs[1:6]] == [(32,), (256,), (256,), (256,), (256,)]
    params = tc.params_from_numpy(jparams, device="cpu", dtype=torch.float32)
    T = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    noise = jax_train_noise(key, 32, 256, 4, dtype=np.float32)
    got = tfn(params, T(Z), T(x), T(y), T(idx).long(), T(w), noise)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    assert np.isfinite(float(tfn(*targs)))


def test_dryrun_multichip_on_the_cpu(capsys):
    results = tge.dryrun_multichip(2, device="cpu", timeout=240)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(
        r"dryrun_multichip OK: mesh=\(2x1, 1x2\) dp-loss=[-\d.]+, chain-sharded HMC samples "
        r"\(4, 2, 16\), sharded SMC log_z=[-\d.]+ \(\d+ stages\), sharded ChEES samples "
        r"\(4, 4, 3\)", line), line
    assert len(results) == 2 and results[0]["params_checksum"] == results[1]["params_checksum"]
    assert all(sum(r["launches"].values()) == 0 for r in results)  # the CPU runs no kernel
