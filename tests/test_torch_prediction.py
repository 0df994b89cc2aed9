"""The port's `models/prediction.py` against the JAX package's: the isotopic
SNMGP, SVC and LMC families and the latent-process draws, on the CPU in
float64 at rtol 1e-8, each `*_predsample` fed the JAX function's own
standard-normal draws (`torch_port_helpers.jax_prediction_noise`, the key
tree the JAX function splits from `PRNGKey(seed)`); the port's own
semantics (chunks of draws, seeded draws, the noise check); and the whole
slice: port NUTS draws of the SVC study through `mcmc_sim.centered_draws`
to predictions, port against JAX on the same draws and noise.

The hyperparameter sets: the SVC study's own lengthscales (beta 0.4) and
each function's defaults (beta 1 over x in [0, 1], the latent-prior grams
the worst conditioned, ~1e7: the port and the JAX package then differ by
~1e-10 relative, the factor's rounding in another summation order).
Every comparison is rtol 1e-8 with an atol of 1e-8 of the output's largest
magnitude (`close`): a draw or a band edge that lies near zero has no
relative precision of its own, and an error of 1e-11 there is 1e-8 of it."""

import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import prediction as jp
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import mcmc_sim
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.nuts import run_nuts
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
    prediction as tp,
)
from torch_port_helpers import assert_close, jax_prediction_noise, rtol_of_max

torch.set_num_threads(1)

RTOL = 1e-8
N, M, T, S, G = 12, 2, 3, 4, 5
CPU64 = dict(device="cpu", dtype=torch.float64)
SNMGP_HYPERS = {
    "study": dict(mu_tilde_l=-1.0, alpha_tilde_l=1.0, beta_tilde_l=0.4, mu_tilde_sigma=0.1,
                  alpha_tilde_sigma=0.5, beta_tilde_sigma=0.4),
    "defaults": {},
}
SVC_HYPERS = {
    "study": {k: v for k, v in mcmc_sim.HYPERS.items() if k not in ("a", "b")},
    "defaults": {},
}


def close(got, want):
    rtol_of_max(got, want, RTOL)


def _data(seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.random(N))
    return rng, x, rng.standard_normal((N, M)), np.linspace(0.03, 0.97, G)


def _snmgp_hists(rng, s=S):
    return (-1.0 + 0.3 * rng.standard_normal((s, N)), 0.1 * rng.standard_normal((s, N)),
            0.3 * rng.standard_normal((s, T)), -1.5 + 0.1 * rng.standard_normal(s))


def _svc_hists(rng, s=S):
    base = np.tile(np.array([0.1, 0.4, -0.2]), N)
    return (-1.0 + 0.3 * rng.standard_normal((s, N)), base + 0.1 * rng.standard_normal((s, N * T)),
            -1.5 + 0.1 * rng.standard_normal(s))


def _lmc_hists(rng, s=S):
    return (np.log(0.3) + 0.1 * rng.standard_normal(s), 0.1 * rng.standard_normal(s),
            0.3 * rng.standard_normal((s, T)), -1.5 + 0.1 * rng.standard_normal(s))


def _first(hists):
    return tuple(h[0] for h in hists)


@pytest.mark.parametrize("hyp, n_sample", [("study", None), ("defaults", 3)])
def test_snmgp_predsample(hyp, n_sample):
    rng, x, Y, xs = _data(1)
    hists = _snmgp_hists(rng)
    noise = jax_prediction_noise("snmgp", 3, n_sample or S, G, M)
    kw = dict(SNMGP_HYPERS[hyp], n_sample=n_sample, seed=3)
    got = tp.snmgp_predsample(hists, Y, x, xs, noise=noise, **kw, **CPU64)
    assert got.shape == (G, n_sample or S, M)
    close(got, jp.snmgp_predsample(hists, Y, x, xs, **kw))


@pytest.mark.parametrize("hyp", list(SNMGP_HYPERS), ids=str)
def test_snmgp_predmap(hyp):
    rng, x, Y, xs = _data(2)
    draw = _first(_snmgp_hists(rng))
    got = tp.snmgp_predmap(draw, Y, x, xs, **SNMGP_HYPERS[hyp], **CPU64)
    assert got.shape == (3, G, M)
    close(got, jp.snmgp_predmap(draw, Y, x, xs, **SNMGP_HYPERS[hyp]))


def test_snmgp_predmap_sampling():
    rng, x, Y, xs = _data(3)
    draw = _first(_snmgp_hists(rng))
    hyp = SNMGP_HYPERS["study"]
    noise = jax_prediction_noise("snmgp", 4, 3, G, M)
    got = tp.snmgp_predmap_sampling(3, draw, Y, x, xs, seed=4, noise=noise, **hyp, **CPU64)
    close(got, jp.snmgp_predmap_sampling(3, draw, Y, x, xs, seed=4, **hyp))


@pytest.mark.parametrize("hyp", list(SVC_HYPERS), ids=str)
def test_svc_predsample(hyp):
    rng, x, Y, xs = _data(4)
    hists = _svc_hists(rng)
    noise = jax_prediction_noise("svc", 6, S, G, M)
    got = tp.svc_predsample(hists, Y, x, xs, seed=6, noise=noise, **SVC_HYPERS[hyp], **CPU64)
    assert got.shape == (G, S, M)
    close(got, jp.svc_predsample(hists, Y, x, xs, seed=6, **SVC_HYPERS[hyp]))


@pytest.mark.parametrize("hyp", list(SVC_HYPERS), ids=str)
def test_svc_predmap(hyp):
    rng, x, Y, xs = _data(5)
    draw = _first(_svc_hists(rng))
    got = tp.svc_predmap(draw, Y, x, xs, **SVC_HYPERS[hyp], **CPU64)
    assert got.shape == (3, G, M)
    close(got, jp.svc_predmap(draw, Y, x, xs, **SVC_HYPERS[hyp]))


def test_svc_predmap_sampling():
    rng, x, Y, xs = _data(6)
    draw = _first(_svc_hists(rng))
    hyp = SVC_HYPERS["study"]
    noise = jax_prediction_noise("svc", 7, 3, G, M)
    got = tp.svc_predmap_sampling(3, draw, Y, x, xs, seed=7, noise=noise, **hyp, **CPU64)
    close(got, jp.svc_predmap_sampling(3, draw, Y, x, xs, seed=7, **hyp))


@pytest.mark.parametrize("n_sample", [None, 2])
def test_lmc_predsample(n_sample):
    rng, x, Y, xs = _data(7)
    hists = _lmc_hists(rng)
    noise = jax_prediction_noise("lmc", 9, n_sample or S, G, M)
    got = tp.lmc_predsample(hists, Y, x, xs, n_sample=n_sample, seed=9, noise=noise, **CPU64)
    assert got.shape == (G, n_sample or S, M)
    close(got, jp.lmc_predsample(hists, Y, x, xs, n_sample=n_sample, seed=9))


def test_lmc_predmap():
    rng, x, Y, xs = _data(8)
    draw = _first(_lmc_hists(rng))
    got = tp.lmc_predmap(draw, Y, x, xs, **CPU64)
    assert got.shape == (3, G, M)
    close(got, jp.lmc_predmap(draw, Y, x, xs))


@pytest.mark.parametrize("hyp", list(SNMGP_HYPERS), ids=str)
def test_snmgp_latent_predsample(hyp):
    rng, x, _, xs = _data(9)
    hists = _snmgp_hists(rng)
    noise = jax_prediction_noise("snmgp_latent", 5, S, G, M)
    got = tp.snmgp_latent_predsample(hists, x, xs, seed=5, noise=noise, **SNMGP_HYPERS[hyp],
                                     **CPU64)
    want = jp.snmgp_latent_predsample(hists, x, xs, seed=5, **SNMGP_HYPERS[hyp])
    for g, w in zip(got, want):
        assert g.shape == (S, G)
        close(g, w)


@pytest.mark.parametrize("hyp", list(SVC_HYPERS), ids=str)
def test_svc_latent_predsample(hyp):
    rng, x, _, xs = _data(10)
    hists = _svc_hists(rng)
    noise = jax_prediction_noise("svc_latent", 8, S, G, M)
    tl, L = tp.svc_latent_predsample(hists, x, xs, seed=8, noise=noise, **SVC_HYPERS[hyp], **CPU64)
    tl_j, L_j = jp.svc_latent_predsample(hists, x, xs, seed=8, **SVC_HYPERS[hyp])
    assert tl.shape == (S, G) and L.shape == (S, G, M, M)
    close(tl, tl_j)
    close(L, L_j)


def test_chunks_of_draws_give_the_same_draws(monkeypatch):
    """Draws taken DRAWS_PER_CHUNK at a time: chunks of 2 over 5 draws (the
    last chunk short) give what one chunk gives, for a predictive and for
    seeded draws."""
    rng, x, Y, xs = _data(11)
    svc, lmc = _svc_hists(rng, 5), _lmc_hists(rng, 5)
    whole = [tp.svc_predsample(svc, Y, x, xs, seed=2, **CPU64),
             tp.lmc_predsample(lmc, Y, x, xs, seed=2, **CPU64)]
    monkeypatch.setattr(tp, "DRAWS_PER_CHUNK", 2)
    chunked = [tp.svc_predsample(svc, Y, x, xs, seed=2, **CPU64),
               tp.lmc_predsample(lmc, Y, x, xs, seed=2, **CPU64)]
    for got, want in zip(chunked, whole):
        assert_close(got, want.numpy(), 1e-12)


def test_seeded_draws_and_the_noise_check():
    """Without `noise` the draws come from a generator seeded by `seed`:
    the same seed the same draws, another seed others; the mean over many
    draws is near the plug-in mean; a noise tuple of the wrong shape is
    refused."""
    rng, x, Y, xs = _data(12)
    draw = _first(_svc_hists(rng))
    a = tp.svc_predmap_sampling(400, draw, Y, x, xs, seed=1, **CPU64)
    assert torch.equal(a, tp.svc_predmap_sampling(400, draw, Y, x, xs, seed=1, **CPU64))
    assert not torch.equal(a, tp.svc_predmap_sampling(400, draw, Y, x, xs, seed=2, **CPU64))
    band = tp.svc_predmap(draw, Y, x, xs, **CPU64)
    sd = (band[2] - band[1]) / 1.96
    assert float(((a.mean(1) - band[1]).abs() / sd).max()) < 0.5
    bad = tp.SVCNoise(torch.zeros(3, G), torch.zeros(3, G, T), torch.zeros(3, G + 1, M))
    with pytest.raises(ValueError, match="noise.y"):
        tp.svc_predmap_sampling(3, draw, Y, x, xs, noise=bad, **CPU64)


def test_whole_slice_nuts_draws_to_predictions():
    """A few port NUTS transitions of the SVC study (N = 16) on the CPU in
    float64, the draws made centered by `mcmc_sim.centered_draws`, then
    `svc_predsample` on a grid and `svc_predmap` at the draws' mean, port
    against JAX on the same draws and noise."""
    prob = mcmc_sim.svc_density(mcmc_sim.svc_problem(16), torch.device("cpu"), torch.float64)
    n, t = prob["N"], prob["T"]
    dim = prob["init"].shape[0]
    gen = torch.Generator().manual_seed(0)
    q0 = torch.as_tensor(prob["init"])[None] + 0.01 * torch.randn(2, dim, generator=gen,
                                                                  dtype=torch.float64)
    samples, _ = run_nuts(prob["lp"], q0, gen, num_warmup=4, num_samples=3, max_depth=3,
                          device="cpu")
    draws = mcmc_sim.centered_draws(prob, samples.numpy()).reshape(-1, dim)
    hists = (draws[:, :n], draws[:, n:n + n * t], draws[:, -1])
    hyp = SVC_HYPERS["study"]
    xs = np.linspace(0.0, 1.0, 7)
    noise = jax_prediction_noise("svc", 0, draws.shape[0], xs.size, 2)
    got = tp.svc_predsample(hists, prob["Y"], prob["x"], xs, noise=noise, **hyp, **CPU64)
    assert got.shape == (7, 6, 2) and bool(torch.isfinite(got).all())
    close(got, jp.svc_predsample(hists, prob["Y"], prob["x"], xs, **hyp))
    mean = tuple(h.mean(0) for h in hists)
    close(tp.svc_predmap(mean, prob["Y"], prob["x"], xs, **hyp, **CPU64),
          jp.svc_predmap(mean, prob["Y"], prob["x"], xs, **hyp))
