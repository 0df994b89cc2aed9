"""The port's particle-sharded SMC (`parallel/sharded_smc.py`) on two ranks
of a gloo group on the CPU, spawned once for the module
(`tests/torch_rank_bodies.smc_rank`), at float64:

  - the conjugate Gaussian model of
    `tests/test_parallel.py::test_sharded_smc_matches_analytic_log_z`
    (d = 3, 512 particles, 256 a rank) with the port's own draws: log Z
    within 0.25 of the analytic value, the posterior mean within 0.15 and
    the variance within 35%, as there;
  - the conjugate model of `tests/test_torch_smc.py` (16 particles, 2
    mutations of 4 leapfrogs) against the JAX `run_smc_sharded` on a
    2-wide chain mesh, each rank's draws rebuilt from the JAX key tree (per
    stage key, k_res, k_mut = split(key, 3), the uniform of k_res; per
    mutation key k, split(fold_in(k, axis_index), P_local) and from each
    k_mom, k_acc = split: sharded_smc.py:175-200): positions, log Z, the
    stage count and the final step size at rtol 1e-10 (the tolerance of
    `tests/test_torch_smc.py::test_run_smc_step_for_step`)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from collaborative_nonstationary_multivariate_gaussian_process_tpu.parallel import mesh as jm
from collaborative_nonstationary_multivariate_gaussian_process_tpu.parallel import (
    sharded_smc as jss,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.launch import (
    spawn,
)
from torch_port_helpers import run_jax

TESTS = os.path.dirname(os.path.abspath(__file__))
S0, S1, D, P, K, STAGES = 2.0, 0.5, 2, 16, 2, 30
Y_OBS = np.array([0.7, -0.3])


def log_prior_jax(q):
    return -0.5 * jnp.sum(q**2) / S0**2 - D * jnp.log(S0) - 0.5 * D * jnp.log(2 * jnp.pi)


def log_like_jax(q):
    return (-0.5 * jnp.sum((jnp.asarray(Y_OBS) - q) ** 2) / S1**2 - D * jnp.log(S1)
            - 0.5 * D * jnp.log(2 * jnp.pi))


def _shard_draws(key, shards):
    """The draws of STAGES stages of the JAX run on `shards` shards."""
    p_local = P // shards

    def stage(key, _):
        key, k_res, k_mut = jax.random.split(key, 3)
        u0 = jax.random.uniform(k_res, (), dtype=jnp.float64)

        def shard(r):
            def mutation(k):
                def particle(kk):
                    k_mom, k_acc = jax.random.split(kk)
                    return (jax.random.normal(k_mom, (D,), jnp.float64),
                            jax.random.uniform(k_acc, dtype=jnp.float64))
                return jax.vmap(particle)(jax.random.split(jax.random.fold_in(k, r), p_local))
            return jax.vmap(mutation)(jax.random.split(k_mut, K))

        return key, (u0, [shard(r) for r in range(shards)])

    _, (u0, per) = run_jax(lambda k: jax.lax.scan(stage, k, None, length=STAGES), key)
    out = {"res_u0": np.asarray(u0)}
    for r, (z, u) in enumerate(per):
        out[f"z{r}"], out[f"u{r}"] = np.asarray(z), np.asarray(u)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(50)
    q0 = S0 * rng.standard_normal((P, D))
    key = jax.random.PRNGKey(4)
    jpos, jinfo = jss.run_smc_sharded(log_prior_jax, log_like_jax, jnp.asarray(q0), key,
                                      jm.make_mesh(data=1, chain=2, devices=jax.devices()[:2]),
                                      num_mutations=K, num_leapfrog=4)
    init = 2.0 * np.random.default_rng(0).standard_normal((512, 3))
    path = tmp_path_factory.mktemp("smc") / "inputs.npz"
    np.savez(path, init=init, q0=q0, y_obs=Y_OBS, **_shard_draws(key, 2))
    with pytest.MonkeyPatch.context() as mp:  # the children import torch_rank_bodies
        mp.setenv("PYTHONPATH", TESTS, prepend=os.pathsep)
        results = spawn("torch_rank_bodies:smc_rank", 2, {"path": str(path)}, timeout=240)
    return results, jpos, jinfo


def test_sharded_smc_matches_analytic_log_z(ranks):
    results, _, _ = ranks
    d, tau2, sig2 = 3, 4.0, 1.0
    log_z_true = d * (-0.5 / (tau2 + sig2) - 0.5 * np.log(2 * np.pi * (tau2 + sig2)))
    post_mean, post_var = tau2 / (tau2 + sig2), 1.0 / (1.0 / tau2 + 1.0 / sig2)
    for res in results:
        assert res["shape"] == [512, 3] and 1 <= res["stages"] <= 100
        assert abs(res["log_z"] - log_z_true) < 0.25, (res["log_z"], log_z_true)
        np.testing.assert_allclose(res["mean"], post_mean * np.ones(d), atol=0.15)
        np.testing.assert_allclose(res["var"], post_var * np.ones(d), rtol=0.35)
    assert results[0]["log_z"] == results[1]["log_z"]
    assert results[0]["mean"] == results[1]["mean"]


def test_sharded_smc_matches_the_jax_sharded_run(ranks):
    results, jpos, jinfo = ranks
    for res in results:
        assert res["jax_stages"] == int(jinfo["num_stages"]) > 1
        assert res["jax_betas"][-1] == 1.0
        np.testing.assert_allclose(res["jax_log_z"], float(jinfo["log_z"]), rtol=1e-10)
        np.testing.assert_allclose(np.reshape(res["jax_positions"], (P, D)), np.asarray(jpos),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(res["jax_step_size"], float(jinfo["final_step_size"]),
                                   rtol=1e-10)
    assert results[0]["jax_betas"] == results[1]["jax_betas"]
