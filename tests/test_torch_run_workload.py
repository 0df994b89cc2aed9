"""The port's real-data workload driver (`drivers/run_workload.py`) against
the JAX script `scripts/run_workload.py`: the data of every workload, the
code after training on the same parameters and draws (the held-out summary
and the ECoG spatial curves, at float64), the divergence diagnostics, and a
tiny run end to end on the CPU with the script's JSON keys."""

import importlib.util
import json
import math
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import predict as jpred
from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import etl as jetl
from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import metrics as jmetrics
from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import (
    posterior_analysis as jpa,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
    run_workload as rw,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp as tc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import predict as tp
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import etl as tetl
from torch_port_helpers import assert_close, jax_init_params, jax_noise

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# scripts/run_workload.py:194-301
KEYS = {"workload", "source", "kl_mode", "D", "N", "M", "batch_size", "itnum", "grad_clip",
        "ckpt_bf16_moments", "lr_decay", "rollbacks", "final_loss", "steps_per_s", "train_s",
        "loss_min", "loss_argmin", "first_nonfinite_step", "first_blowup_step", "rmse_test",
        "ci_length", "coverage"}


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_run_workload", ROOT / "scripts" / "run_workload.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _equal(got, want):
    assert type(got) is type(want) and len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (list, tuple)):
            _equal(g, w)
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype and np.array_equal(g, w)


@pytest.mark.parametrize("name, full", [("pm25", False), ("pm25", True), ("hcp", False),
                                        ("ecog", False)])
def test_load_data_equals_the_jax_scripts(name, full):
    _equal(rw.load_data(name, None, full=full), _jax_script().load_data(name, None, full=full))


def test_load_data_reads_a_presplit_pickle_like_the_jax_script(tmp_path):
    p = tmp_path / "presplit.pickle"
    with open(p, "wb") as f:
        pickle.dump([[np.arange(5.0)], [np.ones(5)], [np.arange(2.0)], [np.zeros(2)]], f)
    _equal(rw.load_data("hcp", str(p)), _jax_script().load_data("hcp", str(p)))


def test_workloads_table_and_flags_are_the_jax_scripts():
    assert rw.WORKLOADS == _jax_script().WORKLOADS
    a = rw.parse_args(["ecog"])
    assert (a.seed, a.kl_mode, a.grad_clip, a.n_sample, a.spatial_grid_points, a.optimizer) == (
        22, "true", 1000.0, 200, 200, "adam")
    with pytest.raises(SystemExit):
        rw.parse_args(["pm25", "--spatial-analysis"])


@pytest.mark.parametrize("losses, want", [
    ([5.0, 3.0, math.nan, 2.0, 100.0], (2.0, 3, 2, 4)),
    ([4.0, 2.0, 3.0], (2.0, 1, -1, -1)),
    ([math.nan, math.inf], (math.nan, -1, 0, -1)),
])
def test_divergence_diagnostics(losses, want):
    got = rw.divergence_diagnostics(losses)
    keys = ("loss_min", "loss_argmin", "first_nonfinite_step", "first_blowup_step")
    assert set(got) == set(keys)
    for k, w in zip(keys, want):
        assert (math.isnan(got[k]) and math.isnan(w)) or got[k] == w, k


def _ecog_problem(D=25, M=8, steps=100, seed=0):
    """The ECoG surrogate at D channels (25: the fewest whose surrogate IDs
    hold the 5x5 grid) of `steps` points, split by the prediction protocol,
    and the JAX package's init_params with lengthscales on the data's scale."""
    X_list, Y_list = tetl.synthetic_ecog(seed=seed, n_channel=D, n_steps=steps)
    X, Y, Xt, Yt = tetl.ecog_pred_split(X_list, Y_list)
    r = np.random.default_rng(seed)
    p = jax_init_params(seed, D, M)
    log10 = jnp.asarray(np.log(10.0))
    p = p._replace(mu_v=jnp.asarray(np.log(10.0) + 0.2 * r.standard_normal(M)),
                   length_scales_tildeell_log=log10, length_scales_L0_log=log10,
                   length_scales_L1_log=log10)
    pt = tc.params_from_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu",
                              dtype=torch.float64)
    return p, pt, np.linspace(0.0, steps - 1.0, M), Xt, Yt


def test_evaluation_after_training_equals_the_jax_computation(tmp_path):
    """rw.evaluate on JAX-initialized parameters with the JAX draws equals
    the JAX script's code after training (:268-339): sample_Y's summary on
    the held-out channel, sample_FY's posterior-mean correlations on the
    grid and the curves of the 5x5 grid; rtol 1e-8.  The figures go beside
    --out."""
    D, M, G, S, seed = 25, 8, 20, 4, 3
    p, pt, Z, Xt, Yt = _ecog_problem(D, M)
    out = tmp_path / "ecog.json"
    args = rw.parse_args(["ecog", "--spatial-analysis", "--spatial-grid-points", str(G),
                          "--n-sample", str(S), "--seed", str(seed), "--cpu", "--out", str(out)])
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    n_test = len(Xt[-1])
    noise = (jax_noise(keys, M, n_test, D), jax_noise(keys, M, G, D, all_outputs=True))
    got = rw.evaluate(pt, Z, Xt, Yt, args, noise=noise)

    ys, _, _, _ = jpred.sample_Y(p, Z, [Xt[-1]], index=[D - 1], n_sample=S, seed=seed)
    rmse, ci, cov = jmetrics.predictive_summary(np.asarray(ys), Yt[-1])
    np.testing.assert_allclose([got["rmse_test"], got["ci_length"]], [rmse, ci], rtol=1e-8)
    assert got["coverage"] == float(np.mean(cov))
    grids = np.linspace(0.0, Z[-1], G)
    _, _, corrs = jpred.sample_FY(p, Z, grids, n_sample=S, seed=seed)
    est = np.asarray(corrs).mean(axis=0)
    ids = jetl.surrogate_ecog_channel_indexes(D)
    sa = got["spatial_analysis"]
    for k, want in jpa.direction_correlation_curves(est, jpa.ECOG_GRID_CHANNEL_IDS, ids).items():
        np.testing.assert_allclose(sa["direction_curves"][k], want, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(sa["direction_mean"][k], np.mean(want), rtol=1e-8, atol=1e-12)
    for d, want in jpa.distance_correlation_curves(est, jpa.ECOG_GRID_CHANNEL_IDS, ids).items():
        np.testing.assert_allclose(sa["distance_curves"][str(d)], want, rtol=1e-8, atol=1e-12)
    assert sa["grid_points"] == G
    assert sorted(Path(f).name for f in sa["figures"]) == ["ecog_corrs.png", "ecog_corrs_dist.png"]
    assert all(Path(f).parent == tmp_path and Path(f).stat().st_size > 0 for f in sa["figures"])


def test_mean_corrs_draws_as_one_seeded_sample_FY_call():
    """Over chunks of draws (10 draws: two chunks), the seeded mean equals
    the mean of one seeded `sample_FY` call, and the curves come without
    figures."""
    _, pt, Z, _, _ = _ecog_problem(M=6, steps=40)
    grids = np.linspace(0.0, Z[-1], 5)
    got = rw.mean_corrs(pt, Z, grids, n_sample=10, seed=2, device="cpu")
    want = tp.sample_FY(pt, Z, grids, n_sample=10, seed=2, device="cpu")[2].mean(dim=0)
    assert_close(got, want.numpy(), rtol=1e-12, atol=1e-15)
    args = rw.parse_args(["ecog", "--spatial-analysis", "--spatial-grid-points", "5",
                          "--n-sample", "10", "--seed", "2", "--cpu"])
    grids2, direction, distance = rw.spatial_curves(pt, Z, args, device="cpu")
    assert np.array_equal(grids2, grids)
    assert set(direction) == {"left", "top", "right", "bottom"} and set(distance) == {1, 2, 3}
    assert all(v.shape == (5,) and np.all(np.isfinite(v)) for v in [*direction.values(),
                                                                     *distance.values()])


def test_tiny_run_gives_the_jax_scripts_keys(tmp_path):
    out_file = tmp_path / "pm25.json"
    out = rw.run(["pm25", "--cpu", "--M", "8", "--itnum", "1", "--batchsize", "2000",
                  "--n-sample", "4", "--out", str(out_file)])
    assert set(out) == KEYS
    assert (out["D"], out["N"], out["M"], out["batch_size"], out["source"]) == (
        6, 28768, 8, 2000, "synthetic")
    for k, v in out.items():
        if not isinstance(v, (str, type(None))):
            assert math.isfinite(v), (k, v)
    assert out["first_nonfinite_step"] == -1 and out["rollbacks"] == 0
    assert json.loads(out_file.read_text()) == out
