"""The port's drivers of `scripts/run_model_comparison.py`,
`scripts/run_mcmc_sim.py --sampler chees` (and its `--plots-dir`),
`scripts/sim_parity.py` and `scripts/baseline_parity.py`, on the CPU at
tiny size: each `run` returns the JAX script's JSON keys with finite
values; and at float64 each of the model comparison's six closures equals
the JAX script's (rebuilt from the JAX package's functions in
`tests/jax_model_comparison.py`) at the same particles."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
    baseline_parity,
    mcmc_sim,
    model_comparison,
    sim_parity,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import sim_mnts
from jax_model_comparison import jax_models
from torch_port_helpers import assert_close, run_jax

torch.set_num_threads(1)

# scripts/run_model_comparison.py:234-246 and scripts/run_mcmc_sim.py:276-291
COMPARISON_KEYS = {"lmc", "snmgp", "svc", "log_bayes_factor_snmgp_vs_lmc",
                   "log_bayes_factor_svc_vs_lmc", "best_model"}
MCMC_KEYS = {"sampler", "N", "chains", "draws", "wall_s", "samples_per_s", "rmse_tilde_l",
             "rmse_corr", "coverage_tilde_l", "coverage_corr", "rhat_max", "rhat_median",
             "mean_accept", "ess_median", "ess_min", "ess_per_s"}


def _finite(d):
    for k, v in d.items():
        if isinstance(v, dict):
            _finite(v)
        elif not isinstance(v, str):
            assert math.isfinite(v), (k, v)


def test_model_comparison_runs_at_tiny_size(tmp_path):
    out_file = tmp_path / "mc.json"
    out = model_comparison.run(["--N", "8", "--particles", "32", "--mutations", "1", "--cpu",
                                "--out", str(out_file)])
    assert COMPARISON_KEYS <= set(out)
    for name in model_comparison.MODELS:
        assert set(out[name]) == {"log_z", "stages", "wall_s"}
        assert out["betas"][name][-1] == 1.0 and len(out["betas"][name]) == out[name]["stages"]
    assert out["best_model"] in model_comparison.MODELS
    _finite({k: out[k] for k in COMPARISON_KEYS})
    assert set(json.loads(out_file.read_text())) == COMPARISON_KEYS


def test_mcmc_sim_chees_runs_at_tiny_size():
    """N = 8, 10 + 10.  At this size ChEES's step size, averaged over 12
    dual-averaging updates, can leave every chain stuck, and then R-hat is
    infinite: the JAX script does so at its --seed 2, the port at --seed 0;
    --seed 1 moves in both."""
    out = mcmc_sim.run(["--N", "8", "--warmup", "10", "--samples", "10", "--sampler", "chees",
                        "--cpu", "--seed", "1", "--steady"])
    assert MCMC_KEYS | {"steady_samples_per_s", "steady_ess_per_s"} == set(out)
    assert out["sampler"] == "chees" and out["draws"] == 40
    _finite(out)


def test_mcmc_sim_plots_dir_writes_the_overlays(tmp_path):
    plots = tmp_path / "plots"
    out = mcmc_sim.run(["--N", "8", "--warmup", "10", "--samples", "10", "--sampler", "chees",
                        "--cpu", "--seed", "1", "--plots-dir", str(plots)])
    names = ["nuts_recovery_correlation_N8.png", "nuts_recovery_log_lengthscale_N8.png"]
    assert out["plots"] == names and sorted(p.name for p in plots.iterdir()) == names
    assert all((plots / n).stat().st_size > 0 for n in names)


# scripts/sim_parity.py:93-111 and scripts/baseline_parity.py:83-104
SIM_PARITY_SUMMARY = {"data", "M", "kl_mode", "n_seeds", "rmse_mean", "rmse_std", "ci_mean",
                      "cov_mean"}
SIM_PARITY_RESULT = {"seed", "rmse", "ci_length", "coverage", "elbo_trace", "wallclock_s"}
BASELINE_ROW = {"dataset", "model", "rmse", "ci_length", "coverage", "ref_rmse", "ref_ci_length",
                "ref_coverage"}


def test_sim_parity_runs_at_tiny_size(tmp_path, monkeypatch):
    monkeypatch.setattr(sim_parity, "N_SAMPLE", 20)
    out_file = tmp_path / "sim.json"
    out = sim_parity.run(["--M", "5", "--itnum", "200", "--seeds", "0", "1",
                          "--cpu", "--x64", "--out", str(out_file), "--plots-dir",
                          str(tmp_path / "figs")])
    assert set(out["summary"]) == SIM_PARITY_SUMMARY and out["summary"]["n_seeds"] == 2
    assert [set(r) for r in out["results"]] == [SIM_PARITY_RESULT] * 2
    _finite({k: v for k, v in out["summary"].items() if k not in ("data", "kl_mode")})
    for r in out["results"]:
        assert len(r["elbo_trace"]) >= 2 and all(map(math.isfinite, r["elbo_trace"]))
    assert json.loads(out_file.read_text())["summary"] == out["summary"]
    figs = sorted(p.name for p in (tmp_path / "figs").iterdir())
    assert figs == [f"Pos_pred_sim_illustration_low_freq_y{d}_seed0_DSVI_true.png" for d in (1, 2)]


def test_baseline_parity_runs_at_tiny_size(tmp_path, monkeypatch):
    monkeypatch.setattr(baseline_parity, "IGPR_STEPS", 5)
    monkeypatch.setattr(baseline_parity, "ICM_STEPS", 5)
    out_file = tmp_path / "rows.json"
    rows = baseline_parity.run(["--cpu", "--x64", "--out", str(out_file)])
    assert [(r["dataset"], r["model"]) for r in rows] == [
        (d, m) for d in baseline_parity.DATASETS for m in ("IGPR", "ICM")]
    for r in rows:
        assert set(r) == BASELINE_ROW
        _finite({k: v for k, v in r.items() if k not in ("dataset", "model")})
        assert (r["ref_rmse"], r["ref_ci_length"], r["ref_coverage"]) == baseline_parity.REFERENCE[
            (r["dataset"], r["model"])]
    assert json.loads(out_file.read_text()) == rows


def _draws(dim, n=5, seed=0):
    q = 0.3 * np.random.default_rng(seed).standard_normal((n, dim))
    q[:, -1] = np.log(0.2)
    return q


@pytest.mark.parametrize("name", model_comparison.MODELS)
def test_model_closures_equal_the_jax_script(name):
    N = 12
    x, _, _, _, Y = sim_mnts(M=2, N=N, seed=0)
    jlp, jll, _, jchols = jax_models(jnp.asarray(x), jnp.asarray(Y))[name]
    chols = None if jchols is None else {name: tuple(torch.as_tensor(np.array(c)) for c in jchols)}
    models = model_comparison.make_models(torch.as_tensor(x), torch.as_tensor(Y), chols)
    m = models[name]
    q = _draws(m.dim)
    qt = torch.as_tensor(q)
    for tfn, jfn in ((m.log_prior, jlp), (m.log_like, jll)):
        assert_close(tfn(qt), run_jax(jax.vmap(jfn), jnp.asarray(q)), rtol=1e-10)
    init = m.prior_sampler(torch.Generator().manual_seed(0), 7)
    assert init.shape == (7, m.dim) and bool(torch.isfinite(m.log_prior(init)).all())


def test_computed_whitening_factors_match_the_jax_ones():
    """The closures above take the JAX factors; the port's own, computed
    from the same float64 inputs, agree to rounding."""
    x, _, _, _, Y = sim_mnts(M=2, N=12, seed=0)
    jm = jax_models(jnp.asarray(x), jnp.asarray(Y))
    models = model_comparison.make_models(torch.as_tensor(x), torch.as_tensor(Y))
    q = torch.as_tensor(_draws(models["svc"].dim, seed=1))
    assert_close(models["svc"].log_like(q), run_jax(jax.vmap(jm["svc"][1]), jnp.asarray(q.numpy())),
                 rtol=1e-8)
