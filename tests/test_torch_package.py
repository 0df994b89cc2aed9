"""Package-level properties of the PyTorch port: it never imports JAX, the
JAX package or scikit-learn, its entry points refuse to run on the CPU
unless asked, and its own copies of the JAX package's constants and NumPy
utilities agree with the originals."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu import config as jconfig
from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import data as jdata
from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import empirical as jemp
from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import metrics as jmetrics
from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import (
    posterior_analysis as jpa,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import sim as jsim
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch import config as tconfig
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
    baseline_parity,
    mcmc_sim,
    model_comparison,
    run_workload,
    sim_parity,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.chees import run_chees
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.smc import run_smc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import baselines as tb
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp as tc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import predict as tp
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
    prediction as tpred,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import data as tdata
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import empirical as temp
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import metrics as tmetrics
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
    posterior_analysis as tpa,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import sim as tsim

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = "collaborative_nonstationary_multivariate_gaussian_process_tpu_torch"
JAX_PACKAGE = "collaborative_nonstationary_multivariate_gaussian_process_tpu"
PORT_FILES = sorted((ROOT / PORT).rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "svc_init_study.py"]


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        f"import {PORT}.models.predict, {PORT}.models.cnmgp, {PORT}.ops.cuda_kernels\n"
        f"import {PORT}.utils.sim, {PORT}.utils.data, {PORT}.utils.metrics\n"
        f"import {PORT}.models.logdensities, {PORT}.ops.kron, {PORT}.ops.distributions\n"
        f"import {PORT}.infer.hmc, {PORT}.infer.nuts, {PORT}.infer.map, {PORT}.infer.dsvi\n"
        f"import {PORT}.infer.chees, {PORT}.infer.smc\n"
        f"import {PORT}.drivers.mcmc_sim, {PORT}.drivers.model_comparison\n"
        f"import {PORT}.parallel.sharded_mcmc, {PORT}.utils.empirical\n"
        f"import {PORT}.utils.posterior_analysis, {PORT}.models.prediction\n"
        f"import {PORT}.utils.etl, {PORT}.utils.visualization, {PORT}.models.baselines\n"
        f"import {PORT}.drivers.run_workload, {PORT}.drivers.baseline_parity\n"
        f"import {PORT}.drivers.sim_parity\n"
        f"bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in ('jax', 'jaxlib', 'sklearn', '{JAX_PACKAGE}'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_of_the_port_imports_jax(path):
    roots = {name.split(".")[0] for name in _imported_modules(path)}
    assert not roots & {"jax", "jaxlib", "sklearn", JAX_PACKAGE}, roots


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = tc.init_params(torch.Generator().manual_seed(0), 2, 4, device="cpu")
    Z, X_list = np.linspace(0, 1, 4), [np.array([0.2]), np.array([0.7])]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.predict_Y(params, Z, X_list)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.sample_Y(params, Z, X_list, n_sample=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.sample_FY(params, Z, np.array([0.5]), n_sample=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.init_params(torch.Generator().manual_seed(0), 2, 4)
    assert tp.predict_Y(params, Z, X_list, device="cpu").shape == (2,)

    def lp(q):
        return -0.5 * torch.sum(q**2, dim=-1)

    q0 = np.zeros((2, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_chees(lp, q0, torch.Generator(), num_warmup=2, num_samples=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_smc(lp, lp, q0, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mcmc_sim.run(["--N", "8", "--warmup", "2", "--samples", "2", "--sampler", "chees"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_comparison.run(["--N", "8", "--particles", "8", "--mutations", "1"])
    x, Y, xs = np.linspace(0, 1, 4), np.zeros((4, 2)), np.array([0.5])
    svc_hists = (np.zeros((2, 4)), np.zeros((2, 12)), np.zeros(2))
    snmgp_map = (np.zeros(4), np.zeros(4), np.zeros(3), 0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpred.svc_predsample(svc_hists, Y, x, xs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpred.snmgp_predmap(snmgp_map, Y, x, xs)
    assert tpred.svc_predsample(svc_hists, Y, x, xs, device="cpu").device.type == "cpu"
    assert tpred.snmgp_predmap(snmgp_map, Y, x, xs, device="cpu").shape == (3, 1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_workload.run(["pm25", "--M", "4", "--itnum", "1", "--batchsize", "5000", "--n-sample", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        baseline_parity.run([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_parity.run(["--M", "4", "--itnum", "1"])
    X_b, Y_b = [np.linspace(0, 1, 5)] * 2, [np.zeros(5), np.ones(5)]
    for fit in (tb.fit_igpr, tb.fit_icm, tb.fit_sgpr, tb.fit_sicm):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fit(X_b, Y_b, steps=1)
        assert fit(X_b, Y_b, steps=1, device="cpu") is not None
    pos, _ = run_chees(lp, q0, torch.Generator(), num_warmup=2, num_samples=2, device="cpu")
    assert pos.device.type == "cpu" and pos.shape == (2, 2, 3)
    _, info = run_smc(lp, lp, q0, torch.Generator(), num_leapfrog=2, device="cpu")
    assert info["log_z"].device.type == "cpu"


def test_config_constants_match_the_jax_package():
    for name in ("DSVI_JITTER", "MCMC_JITTER", "PRECISION"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    assert tconfig.DEFAULT_DTYPE == torch.float32


@pytest.mark.parametrize(
    "name", ["sim_illustration_low_freq", "sim_illustration_high_freq", "sim_illustration_varying_freq"]
)
def test_illustration_generators_are_copies(name):
    got, want = getattr(tsim, name)(seed=5), getattr(jsim, name)(seed=5)
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            np.testing.assert_array_equal(g, w)


def test_sim_mnts_is_a_copy():
    for g, w in zip(tsim.sim_mnts(N=40, seed=3), jsim.sim_mnts(N=40, seed=3)):
        np.testing.assert_array_equal(g, w)


def test_flat_data_and_metrics_are_copies():
    X_list, Y_list, Xt_list, Yt_list = tsim.sim_illustration_low_freq(seed=1)
    got, want = tdata.flatten_output_lists(X_list, Y_list), jdata.flatten_output_lists(X_list, Y_list)
    for field in ("x", "y", "idx"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.n == want.n and got.dim_outputs == want.dim_outputs
    for g, w in zip(got.lists()[0] + got.lists()[1], want.lists()[0] + want.lists()[1]):
        np.testing.assert_array_equal(g, w)

    rng = np.random.default_rng(0)
    y = np.concatenate([np.ravel(y) for y in Yt_list])
    idx = np.repeat([0, 1], [len(Yt_list[0]), len(Yt_list[1])])
    samples = y + rng.standard_normal((300, y.size))
    r, ci, cov = tmetrics.predictive_summary(samples, y, test_index=idx, dim_outputs=2)
    rj, cij, covj = jmetrics.predictive_summary(samples, y, test_index=idx, dim_outputs=2)
    assert (r, ci) == (rj, cij)
    np.testing.assert_array_equal(cov, covj)
    assert tmetrics.rmse(samples[0], y) == jmetrics.rmse(samples[0], y)
    assert tmetrics.ci_length_and_coverage(samples, y) == jmetrics.ci_length_and_coverage(samples, y)


def test_empirical_estimation_is_a_copy():
    """The port's NumPy copy of the variogram initialization (the JAX
    package's runs the same pair loops in C++ where its library is built)."""
    x, _, _, _, Y = tsim.sim_mnts(M=2, N=60, seed=4)
    got, want = temp.local_estimation(x, Y, window_size=10), jemp.local_estimation(x, Y, window_size=10)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, err_msg=k)
    np.testing.assert_allclose(temp.smooth(got["L_vecs"], 10), jemp.smooth(want["L_vecs"], 10), rtol=1e-12)
    for g, w in zip(temp.semivariogram(x, Y, 1), jemp.semivariogram(x, Y, 1)):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    for g, w in zip(temp.global_estimation(x, Y), jemp.global_estimation(x, Y)):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    s = np.linspace(0.0, 2.0, 7)
    np.testing.assert_array_equal(temp.variogram_gaussian(s, 1.3, 0.4), jemp.variogram_gaussian(s, 1.3, 0.4))


def test_posterior_analysis_is_a_copy():
    rng = np.random.default_rng(5)
    N, M = 7, 3
    T = M * (M + 1) // 2
    hist = rng.standard_normal((40, N * T))
    np.testing.assert_allclose(tpa.lvecs_to_corr(hist, N, M), jpa.lvecs_to_corr(hist, N, M), rtol=1e-12)
    pos = np.abs(hist) + 0.1
    np.testing.assert_allclose(tpa.lvecs_to_corr(pos, N, M, constrained=True),
                               jpa.lvecs_to_corr(pos, N, M, constrained=True), rtol=1e-12)
    S = rng.standard_normal((5, M, M))
    S = S @ S.transpose(0, 2, 1) + np.eye(M)
    np.testing.assert_array_equal(tpa.cov2cor(S), jpa.cov2cor(S))
    np.testing.assert_array_equal(tpa.samples2quantiles(hist), jpa.samples2quantiles(hist))
    flat = rng.standard_normal((6, 2 * N + T + 1))
    for name, args in (("snmgp", (N, M)), ("svc", (N, M)), ("lmc", (M,))):
        for kind in ("hist", "est"):
            arr = flat if kind == "hist" else flat[0]
            got = getattr(tpa, f"unpack_{kind}_{name}")(arr, *args)
            want = getattr(jpa, f"unpack_{kind}_{name}")(arr, *args)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
