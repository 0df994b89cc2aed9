"""The port's chain-sharded samplers (`parallel/sharded_mcmc.py`) on two
ranks of a gloo group on the CPU, spawned once for the module
(`tests/torch_rank_bodies.mcmc_rank`), at float64 on a Gaussian with
unequal scales (4 chains, dim 3):

  - each rank's block of `run_nuts_sharded` / `run_hmc_sharded` (draws,
    per-chain info) equals the port's unsharded `run_nuts` / `run_hmc` on
    the same chains with the same draws, bit for bit, and both ranks hold
    the same gathered draws;
  - `run_chees_sharded` against the JAX `run_chees_sharded` on a 2-wide
    chain mesh, each rank's draws rebuilt from the JAX stream of its shard
    (per iteration key, fold_in(key, axis_index), then k_mom, k_acc =
    split: sharded_mcmc.py:193-196, chees.py:182), at the tolerance of
    `tests/test_torch_chees.py::test_run_chees_step_for_step` on a
    Gaussian (rtol 1e-10, atol 1e-12); the adapted step size and
    trajectory length bit-equal on both ranks;
  - the draws do not depend on `max_iters_per_dispatch`
    (`tests/test_parallel.py::test_run_chees_sharded_chunk_invariant`)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from collaborative_nonstationary_multivariate_gaussian_process_tpu.parallel import mesh as jm
from collaborative_nonstationary_multivariate_gaussian_process_tpu.parallel import (
    sharded_mcmc as jsm,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.launch import (
    spawn,
)
from torch_port_helpers import run_jax

TESTS = os.path.dirname(os.path.abspath(__file__))
C, DIM, W, S = 4, 3, 20, 10


def gauss_lp_jax(q):
    return -0.5 * jnp.sum((q / jnp.arange(1, q.shape[-1] + 1)) ** 2)


def _chees_shard_draws(key, shards):
    """The JAX `run_chees_sharded(key)` iteration keys (k_warm, k_re, k_main
    = split(key, 3); split(k_warm, W), split(k_re, W // 4), split(k_main,
    S)), folded with each shard's index, and each one's (C / shards, DIM)
    normals and (C / shards,) uniforms."""
    k_warm, k_re, k_main = jax.random.split(key, 3)
    keys = jnp.concatenate([jax.random.split(k_warm, W), jax.random.split(k_re, max(W // 4, 1)),
                            jax.random.split(k_main, S)])
    c = C // shards

    def one(k, r):
        k_mom, k_acc = jax.random.split(jax.random.fold_in(k, r))
        return (jax.random.normal(k_mom, (c, DIM), jnp.float64),
                jax.random.uniform(k_acc, (c,), dtype=jnp.float64))

    out = {}
    for r in range(shards):
        z, u = run_jax(jax.vmap(lambda k: one(k, r)), keys)  # noqa: B023
        out[f"chees_z{r}"], out[f"chees_u{r}"] = np.asarray(z), np.asarray(u)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    q0 = 0.5 * np.random.default_rng(41).standard_normal((C, DIM))
    key = jax.random.PRNGKey(13)
    jpos, jinfo = jsm.run_chees_sharded(gauss_lp_jax, jnp.asarray(q0), key,
                                        jm.make_mesh(data=1, chain=2, devices=jax.devices()[:2]),
                                        num_warmup=W, num_samples=S, init_traj_length=0.5)
    path = tmp_path_factory.mktemp("mcmc") / "inputs.npz"
    np.savez(path, q0=q0, chees_warmup=W, chees_samples=S, **_chees_shard_draws(key, 2))
    with pytest.MonkeyPatch.context() as mp:  # the children import torch_rank_bodies
        mp.setenv("PYTHONPATH", TESTS, prepend=os.pathsep)
        results = spawn("torch_rank_bodies:mcmc_rank", 2, {"path": str(path)}, timeout=240)
    return results, jpos, jinfo


@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
def test_each_block_equals_the_unsharded_run_bit_for_bit(ranks, sampler):
    results, _, _ = ranks
    assert all(res[f"{sampler}_block_equal"] for res in results)
    assert results[0][f"{sampler}_positions"] == results[1][f"{sampler}_positions"]
    assert np.all(np.isfinite(results[0][f"{sampler}_positions"]))


def test_nuts_host_counts_are_listed_per_shard(ranks):
    results, _, _ = ranks
    reads = results[0]["nuts_host_reads"]
    assert len(reads) == 2 and all(r > 0 for r in reads)


def test_run_chees_sharded_matches_the_jax_sharded_run(ranks):
    results, jpos, jinfo = ranks
    rtol, atol = 1e-10, 1e-12
    for res in results:
        np.testing.assert_allclose(np.reshape(res["chees_positions"], (C, S, DIM)), jpos,
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(np.reshape(res["chees_accept_prob"], (C, S)),
                                   np.asarray(jinfo["accept_prob"]).T, rtol=rtol, atol=atol)
        np.testing.assert_array_equal(res["chees_num_steps"], np.asarray(jinfo["num_steps"]))
        for k in ("step_size", "trajectory_length"):
            np.testing.assert_allclose(res[f"chees_{k}"], float(jinfo[k]), rtol=rtol)
        np.testing.assert_allclose(res["chees_inv_mass"], np.asarray(jinfo["inv_mass"]), rtol=rtol)
        np.testing.assert_allclose(res["chees_warmup_accept_mean"], jinfo["warmup_accept_mean"],
                                   rtol=rtol)
        assert res["chees_differs_from_a_block_alone"]
    for k in ("step_size", "trajectory_length", "inv_mass", "positions"):
        assert results[0][f"chees_{k}"] == results[1][f"chees_{k}"]


def test_run_chees_sharded_chunk_invariant(ranks):
    results, _, _ = ranks
    assert all(res["chees_chunk_invariant"] for res in results)
