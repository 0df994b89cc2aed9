"""The port's multi-device layer (`parallel/mesh.py`, data-parallel DSVI)
against the JAX package's `parallel/mesh.py` and `inference(mesh=...)`.

In this process: `initialize_distributed` without a launcher, the 1 x 1
mesh of one process, `process_local_blocks` on an interleaved layout
against the JAX function's arithmetic, and a clean import.  Then two ranks
of a gloo group on the CPU (`tests/torch_rank_bodies.dsvi_rank`), spawned
once for the module: the mesh's shapes, the host-local loading roundtrip,
`inference(mesh=...)` against the port's one-process run on the inputs of
`tests/test_parallel.py::test_inference_mesh_matches_single_device` at its
tolerances (losses rtol 1e-9, parameters rtol 1e-8 and atol 1e-10, f64),
and `make_scan_epochs(mesh=...)` from the JAX parameters (carried by
`params_from_numpy` on rank 0, then broadcast) on the JAX draws against
the JAX `make_scan_epochs(mesh=make_mesh(data=8))` at the tolerance of
`tests/test_torch_scan_epochs.py` (rtol 1e-8, atol 1e-12)."""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.infer import dsvi as jd
from collaborative_nonstationary_multivariate_gaussian_process_tpu.parallel import mesh as jm
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi as td
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp as tc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel import mesh as pm
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.launch import (
    spawn,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.data import (
    flatten_output_lists,
)
from torch_port_helpers import FAST_COMPILE, jax_init_params, jax_train_noise

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
EPOCHS, BATCH, M_IND, D = 6, 16, 8, 2


def _inputs():
    """tests/test_parallel.py::test_inference_mesh_matches_single_device's."""
    rng = np.random.default_rng(3)
    X_list = [np.sort(rng.random(40)), np.sort(rng.random(40))]
    Y_list = [np.sin(6 * X_list[0]), 0.5 * np.sin(6 * X_list[1])]
    return X_list, Y_list, np.linspace(0, 1, M_IND)


def _jax_scan_reference(x, y, idx, z, p0):
    """The JAX `make_scan_epochs(mesh=make_mesh(data=8))` run from p0 and
    its draws (the sort keys and the noise of every step, as the port
    takes them)."""
    n = x.shape[0]
    nb = -(-n // BATCH)
    opt = optax.adam(0.01)
    run = jd.make_scan_epochs(opt, float(n), 1e-4, nb, BATCH, mesh=jm.make_mesh(data=8, chain=1))
    key = jax.random.PRNGKey(11)
    args = (p0, opt.init(p0), jd.freeze_mask(p0, True), jnp.asarray(z), jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(idx), key)
    p, _, losses = run.lower(*args, n_epochs=EPOCHS).compile(FAST_COMPILE)(*args)
    keys, noise = [], []
    for key_e in jax.random.split(key, EPOCHS):
        k_perm, k_steps = jax.random.split(key_e)
        keys.append(np.asarray(jax.random.bits(k_perm, (n,), jnp.uint32)).astype(np.int64))
        noise.append(jax_train_noise(jax.random.split(k_steps, nb), M_IND, BATCH, D))
    draws = {k: np.concatenate([getattr(nz, k).numpy() for nz in noise])[:, None]
             for k in ("z_v1", "z_v2", "z_te", "z_diag", "z_off")}
    return p, np.asarray(losses), np.stack(keys), draws


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    X_list, Y_list, z = _inputs()
    flat = flatten_output_lists(X_list, Y_list)
    p0 = jax_init_params(11, D, M_IND)
    jp, jlosses, keys, draws = _jax_scan_reference(flat.x, flat.y, flat.idx, z, p0)
    path = tmp_path_factory.mktemp("dsvi") / "inputs.npz"
    np.savez(path, x0=X_list[0], x1=X_list[1], y0=Y_list[0], y1=Y_list[1], z=z, x=flat.x,
             y=flat.y, idx=flat.idx, epochs=EPOCHS, sort_keys=keys, **draws,
             **{f"p_{k}": np.asarray(v) for k, v in zip(tc.CNMGPParams._fields, p0)})
    with pytest.MonkeyPatch.context() as mp:  # the children import torch_rank_bodies
        mp.setenv("PYTHONPATH", TESTS, prepend=os.pathsep)
        results = spawn("torch_rank_bodies:dsvi_rank", 2, {"path": str(path)}, timeout=240)
    return results, (X_list, Y_list, z), (jp, jlosses)


def test_initialize_distributed_is_a_noop_and_idempotent(monkeypatch):
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert pm.initialize_distributed() == (0, 1)
    assert pm.initialize_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()


def test_one_process_mesh_is_1x1_with_identity_collectives():
    mesh = pm.make_mesh()
    assert mesh.shape == {"data": 1, "chain": 1} and mesh.device_mesh is None
    assert pm.make_pod_mesh().shape == mesh.shape
    t = torch.arange(6.0)
    assert mesh.all_reduce_(t.clone()).equal(t) and mesh.all_gather(t).equal(t)
    assert pm.process_local_slice(mesh, 12) == (0, 12)
    assert pm.shard_batch(mesh, {"a": t})["a"].equal(t)
    with pytest.raises(ValueError):
        pm.make_mesh(data=2)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_row_slice_is_the_process_local_slice(rank):
    """`Mesh.row_slice`, the rows that `shard_batch` and a data-parallel
    step take, is the block `process_local_slice` loads, on a layout that
    puts the ranks out of order on "data"."""
    mesh = pm.Mesh([[0], [2], [1], [3]])
    mesh.rank = rank
    start, size = pm.process_local_slice(mesh, 12)
    assert mesh.row_slice(12) == slice(start, start + size)
    t = torch.arange(24.0).reshape(12, 2)
    assert pm.shard_batch(mesh, (t,))[0].equal(t[start:start + size])
    with pytest.raises(ValueError, match="do not split evenly"):
        mesh.row_slice(10)


@pytest.mark.parametrize("layout, here", [
    ([[0], [2], [1], [3]], (0, 1)),
    ([[0, 4], [1, 5], [2, 6], [3, 7]], (0, 2, 5)),
    ([[0], [1], [2], [3]], (1, 2)),
    ([[0], [1], [2], [3]], (7,)),
])
def test_process_local_blocks_match_the_jax_arithmetic(layout, here):
    """The JAX function on a mesh whose devices belong to processes as the
    ranks `here` belong to this host (a duck-typed mesh: the function reads
    only its shape, axis names, devices and their process_index)."""
    n_rows = 8 * len(layout)
    lay = np.array(layout)
    devices = np.empty(lay.shape, dtype=object)
    for i, r in np.ndenumerate(lay):
        devices[i] = types.SimpleNamespace(process_index=0 if r in here else 1)
    fake = types.SimpleNamespace(shape={"data": lay.shape[0], "chain": lay.shape[1]},
                                 axis_names=("data", "chain"), devices=devices)
    for axis in ("data", "chain"):
        if n_rows % lay.shape[("data", "chain").index(axis)]:
            continue
        want = jm.process_local_blocks(fake, n_rows, axis)
        got = pm.process_local_blocks(pm.Mesh(lay), n_rows, axis, ranks=here)
        assert got == want
    if len(pm.process_local_blocks(pm.Mesh(lay), n_rows, ranks=here)) > 1:
        with pytest.raises(ValueError, match="not contiguous"):
            pm.process_local_slice(pm.Mesh(lay), n_rows, ranks=here)


def test_importing_the_port_initializes_neither_cuda_nor_a_group():
    code = ("import sys, torch, torch.distributed as dist\n"
            "import collaborative_nonstationary_multivariate_gaussian_process_tpu_torch as p\n"
            "from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch import parallel\n"
            "from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import "
            "graft_entry\n"
            "from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import "
            "native, profiling\n"
            "assert not torch.cuda.is_initialized() and not dist.is_initialized()\n"
            "assert 'jax' not in sys.modules\n"
            "print('PURE')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PURE" in out.stdout


def test_two_ranks_mesh_shapes_and_the_host_local_roundtrip(ranks):
    results, _, _ = ranks
    for r, res in enumerate(results):
        assert res["shape"] == {"data": 2, "chain": 1}
        assert res["chain_shape"] == {"data": 1, "chain": 2}
        assert res["pod_shape"] == {"data": 2, "chain": 1}
        assert res["coordinate"] == r and res["slice"] == [4 * r, 4]
        assert res["roundtrip"]
        assert res["shard"] == [3.0 * i for i in range(4 * r, 4 * r + 4)]


def test_inference_mesh_matches_the_one_process_run(ranks):
    results, (X_list, Y_list, z), _ = ranks
    r1 = td.inference(X_list, Y_list, z, batch_size=BATCH, dim_outputs=D, itnum=EPOCHS, lr=0.01,
                      seed=11, show_ELBO=False, dtype=torch.float64, device="cpu")
    for res in results:
        np.testing.assert_allclose(res["inference_losses"], r1.loss_list, rtol=1e-9)
        for got, want in zip(res["inference_params"], r1.params):
            np.testing.assert_allclose(got, want.reshape(-1).numpy(), rtol=1e-8, atol=1e-10)


def test_ranks_hold_identical_params(ranks):
    """The JAX parameters carried to rank 0 reach rank 1 by the broadcast,
    and after the 30 data-parallel steps both ranks hold the same bits."""
    results, _, _ = ranks
    a, b = results
    p0 = jax_init_params(11, D, M_IND)
    for got, want in zip(b["carried_params"], p0):
        np.testing.assert_array_equal(got, np.asarray(want).reshape(-1))
    for key in ("inference_params", "scan_params", "scan_losses", "inference_losses"):
        assert a[key] == b[key]


def test_scan_epochs_mesh_matches_the_jax_mesh_run(ranks):
    results, _, (jp, jlosses) = ranks
    for res in results:
        np.testing.assert_allclose(res["scan_losses"], jlosses, rtol=1e-8)
        for got, want in zip(res["scan_params"], jp):
            np.testing.assert_allclose(got, np.asarray(want).reshape(-1), rtol=1e-8, atol=1e-12)
