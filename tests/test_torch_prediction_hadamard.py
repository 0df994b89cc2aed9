"""The port's heterotopic (hadamard) prediction and its indexed-point
wrappers against the JAX package's `models/prediction.py`, on the CPU in
float64, each `*_predsample` fed the JAX function's own standard-normal
draws (`torch_port_helpers.jax_prediction_noise`).  Every comparison is rtol
1e-8 with an atol of 1e-8 of the output's largest magnitude
(`torch_port_helpers.rtol_of_max`): a draw or band edge near zero has no
relative precision of its own.  The last test runs the heterotopic path as
a user does: the study's series flattened, 25% held out by the port's
`data_split_non`, the held-out points predicted one task each."""

import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import prediction as jp
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
    prediction as tp,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import data as tdata
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import sim as tsim
from torch_port_helpers import jax_prediction_noise, rtol_of_max

torch.set_num_threads(1)

RTOL = 1e-8
N, M, T, S, G = 16, 2, 3, 4, 5
CPU64 = dict(device="cpu", dtype=torch.float64)
SNMGP_HYP = dict(mu_tilde_l=np.log(0.25), alpha_tilde_l=1.0, beta_tilde_l=0.3, mu_tilde_sigma=0.0,
                 alpha_tilde_sigma=0.5, beta_tilde_sigma=0.3)
SVC_HYP = dict(mu_tilde_l=np.log(0.25), alpha_tilde_l=1.0, beta_tilde_l=0.3, mu_L=0.5, alpha_L=1.0,
               beta_L=0.3)


def close(got, want):
    rtol_of_max(got, want, RTOL)


def _data(seed):
    """Heterotopic flat data (x, indx, y): a shared signal, task 1 scaled."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.random(N))
    indx = rng.integers(0, M, N)
    y = np.sin(6.0 * x) * np.where(indx == 0, 1.0, 0.6) + 0.05 * rng.standard_normal(N)
    return rng, x, indx, y, np.linspace(0.03, 0.97, G), rng.integers(0, M, G)


def _snmgp(rng):
    return (np.log(0.25) + 0.1 * rng.standard_normal((S, N)), 0.1 * rng.standard_normal((S, N)),
            np.array([1.0, 0.6, 0.3]) + 0.05 * rng.standard_normal((S, T)),
            np.log(0.05) + 0.1 * rng.standard_normal(S))


def _lmc(rng):
    return (np.log(0.25) + 0.1 * rng.standard_normal(S), 0.1 * rng.standard_normal(S),
            np.array([1.0, 0.6, 0.3]) + 0.05 * rng.standard_normal((S, T)),
            np.log(0.05) + 0.1 * rng.standard_normal(S))


def _svc(rng):
    return (np.log(0.25) + 0.1 * rng.standard_normal((S, N)),
            np.tile([1.0, 0.6, 0.3], (S, N)) + 0.05 * rng.standard_normal((S, N * T)),
            np.log(0.05) + 0.1 * rng.standard_normal(S))


FAMILIES = {  # draws, hyperparameters, noise family
    "snmgp": (_snmgp, SNMGP_HYP, "snmgp_hadamard"),
    "lmc": (_lmc, {}, "lmc_hadamard"),
    "svc": (_svc, SVC_HYP, "svc_hadamard"),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hadamard_predsample(family):
    make, hyp, noise_family = FAMILIES[family]
    rng, x, indx, y, xs, _ = _data(1)
    hists = make(rng)
    noise = jax_prediction_noise(noise_family, 10, S, G, M)
    name = f"{family}_hadamard_predsample"
    got = getattr(tp, name)(hists, x, indx, y, M, xs, seed=10, noise=noise, **hyp, **CPU64)
    assert got.shape == (G, S, M)
    close(got, getattr(jp, name)(hists, x, indx, y, M, xs, seed=10, **hyp))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hadamard_predmap(family):
    make, hyp, _ = FAMILIES[family]
    rng, x, indx, y, xs, _ = _data(2)
    draw = tuple(h[0] for h in make(rng))
    name = f"{family}_hadamard_predmap"
    got = getattr(tp, name)(draw, x, indx, y, M, xs, **hyp, **CPU64)
    assert got.shape == (3, G, M)
    assert bool((got[0] < got[1]).all() and (got[1] < got[2]).all())
    close(got, getattr(jp, name)(draw, x, indx, y, M, xs, **hyp))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_indexedpoint_predsample(family):
    make, hyp, noise_family = FAMILIES[family]
    rng, x, indx, y, xs, istar = _data(3)
    hists = make(rng)
    noise = jax_prediction_noise(noise_family, 11, S, G, M)
    name = f"{family}_hadamard_indexedpoint_predsample"
    got = getattr(tp, name)(hists, x, indx, y, M, xs, istar, seed=11, noise=noise, **hyp, **CPU64)
    full = getattr(tp, f"{family}_hadamard_predsample")(hists, x, indx, y, M, xs, noise=noise,
                                                         **hyp, **CPU64)
    assert got.shape == (G, S)
    assert torch.equal(got, full[np.arange(G), :, istar])
    close(got, getattr(jp, name)(hists, x, indx, y, M, xs, istar, seed=11, **hyp))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_indexedpoint_predmap(family):
    make, hyp, _ = FAMILIES[family]
    rng, x, indx, y, xs, istar = _data(4)
    draw = tuple(h[0] for h in make(rng))
    name = f"{family}_hadamard_indexedpoint_predmap"
    got = getattr(tp, name)(draw, x, indx, y, M, xs, istar, **hyp, **CPU64)
    full = getattr(tp, f"{family}_hadamard_predmap")(draw, x, indx, y, M, xs, **hyp, **CPU64)
    assert got.shape == (3, G)
    assert torch.equal(got, full[:, np.arange(G), istar])
    close(got, getattr(jp, name)(draw, x, indx, y, M, xs, istar, **hyp))


def test_held_out_points_of_a_split_series():
    """The study's series (sim_mnts, N = 12) in flat form, 25% held out by
    `data_split_non` (the port's and the JAX package's splits equal), the
    held-out points predicted one task each by the SVC and LMC indexed-point
    wrappers at the truth's lengthscale process; port against JAX."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import data as jdata

    x, l, L_vecs, s2e, Y = tsim.sim_mnts(M=2, N=12, seed=1)
    xf, idx, yf = np.tile(x, 2), np.repeat([0, 1], 12), Y.T.reshape(-1)
    split = tdata.data_split_non(xf, idx, yf, test_size=0.25, random_state=3)
    for got, want in zip(split, jdata.data_split_non(xf, idx, yf, test_size=0.25, random_state=3)):
        np.testing.assert_array_equal(got, want)
    x_tr, x_te, i_tr, i_te, y_tr, _ = split
    assert x_te.size == 6 and x_tr.size == 18
    tl = np.interp(x_tr, x, np.log(l))
    svc = (tl, np.tile([1.0, 0.3, 0.8], x_tr.size), np.log(s2e))
    hyp = dict(mu_tilde_l=-3.0, alpha_tilde_l=1.0, beta_tilde_l=0.4, mu_L=0.5, alpha_L=1.0,
               beta_L=0.4)
    data = (x_tr, i_tr, y_tr, 2, x_te, i_te)
    close(tp.svc_hadamard_indexedpoint_predmap(svc, *data, **hyp, **CPU64),
          jp.svc_hadamard_indexedpoint_predmap(svc, *data, **hyp))
    lmc = (np.log(0.1), 0.0, np.array([1.0, 0.3, 0.8]), np.log(s2e))
    close(tp.lmc_hadamard_indexedpoint_predmap(lmc, *data, **CPU64),
          jp.lmc_hadamard_indexedpoint_predmap(lmc, *data))
