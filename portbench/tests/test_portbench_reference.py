"""The plain references against the port's plain path at tiny sizes, in
float64 on the CPU: the same mathematics, so agreement to rounding."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import data
from portbench.reference import cnmgp as rc
from portbench.reference import svc as rs

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (  # noqa: E402
    cnmgp as tc,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (  # noqa: E402
    logdensities as ld,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import (  # noqa: E402
    sim_mnts,
)

F64 = torch.float64


def _cnmgp_problem(seed, D=4, M=7, B=11):
    g = torch.Generator().manual_seed(seed)
    params = tc.init_params(g, D, M, dtype=F64, device="cpu", mu_v=torch.ones(M, dtype=F64))
    params = params._replace(length_scales_L0_log=torch.tensor(1.5, dtype=F64),
                             sigma2_err_log=torch.tensor(-1.0, dtype=F64))
    Z = torch.linspace(0, 10, M, dtype=F64)
    x = torch.rand(B, generator=g, dtype=F64) * 10
    idx = torch.randint(0, D, (B,), generator=g)
    return params, Z, x, idx, g


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_negative_selbo_and_gradients(seed):
    params, Z, x, idx, g = _cnmgp_problem(seed)
    y = torch.randn(x.shape[0], generator=g, dtype=F64)
    w = torch.ones_like(y)
    w[-3:] = 0.0
    nz = tc.draw_train_noise(g, 2, Z.shape[0], x.shape[0], params.num_outputs, dtype=F64)
    leaves = [t.clone().requires_grad_(True) for t in params]
    want = tc.negative_selbo(tc.CNMGPParams(*leaves), Z, x, y, idx, w, 50.0, nz, 1e-4)
    g_want = torch.autograd.grad(want, leaves)
    p = {k: t.clone().requires_grad_(True) for k, t in zip(rc.FIELDS, params)}
    got = rc.negative_selbo(p, Z, x, y, idx, w, 50.0, nz._asdict(), 1e-4)
    g_got = torch.autograd.grad(got, [p[k] for k in rc.FIELDS])
    assert abs(got.item() - want.item()) <= 1e-10 * abs(want.item())
    for a, b in zip(g_got, g_want):
        assert float((a - b).abs().max()) <= 1e-9 * (float(b.abs().max()) + 1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_predictive_draws_and_means(seed):
    params, Z, x, idx, g = _cnmgp_problem(seed)
    nz = tc.draw_noise(g, 3, Z.shape[0], x.shape[0], params.num_outputs, dtype=F64)
    p = dict(zip(rc.FIELDS, params))
    want = tc.sample_y_once(params, Z, x, idx, nz, 1e-4)[0]
    got = rc.sample_y(p, Z, x, idx, nz._asdict(), 1e-4)
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())
    m_want, m_got = tc.predict_y_mean(params, Z, x, idx, 1e-4), rc.predict_y(p, Z, x, idx, 1e-4)
    assert float((m_got - m_want).abs().max()) <= 1e-10 * float(m_want.abs().max())


def test_svc_data_and_density():
    x, Y = data.sim_mnts(20, 0)
    x2, _, _, _, Y2 = sim_mnts(M=2, N=20, seed=0)
    np.testing.assert_array_equal(x, x2)
    np.testing.assert_array_equal(Y, Y2)
    xt, Yt = torch.as_tensor(x, dtype=F64), torch.as_tensor(Y, dtype=F64)
    h = dict(mu_tilde_l=-3.0, alpha_tilde_l=3.0, beta_tilde_l=0.4, mu_L=0.0, alpha_L=5.0,
             beta_L=1.0, a=1.0, b=1.0)
    cl, cL = ld.svc_whiten_chols(xt, 3.0, 0.4, 5.0, 1.0)
    rl, rL = rs.prior_chols(xt, ((3.0, 0.4), (5.0, 1.0)), (1e-6 * 9, 1e-6 * 25))
    assert float((cl - rl).abs().max()) < 1e-9 and float((cL - rL).abs().max()) < 1e-9
    q = 0.5 * torch.randn(5, 20 * 4 + 1, generator=torch.Generator().manual_seed(0), dtype=F64)
    q[:, -1] = np.log(0.01)
    want, g_want = rs.value_and_grad(lambda v: ld.svc_log_posterior_whitened(
        v, Yt, xt, cl, cL, mu_tilde_l=-3.0, mu_L=0.0, a=1.0, b=1.0), q)
    got, g_got = rs.value_and_grad(lambda v: rs.log_posterior(v, Yt, xt, rl, rL, h, 1e-6), q)
    assert float((got - want).abs().max()) <= 1e-9 * float(want.abs().max())
    assert float((g_got - g_want).abs().max()) <= 1e-7 * float(g_want.abs().max())


def test_transition_matches_the_port_kernel():
    """One fixed-length transition of the reference against the port's
    `_chees_kernel` on the same density, draws, step size and mass."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import chees

    g = torch.Generator().manual_seed(4)
    A = torch.randn(6, 6, generator=g, dtype=F64)
    prec = A @ A.T + 6 * torch.eye(6, dtype=F64)
    lp = lambda q: -0.5 * torch.einsum("ci,ij,cj->c", q, prec, q)  # noqa: E731
    q0 = torch.randn(3, 6, generator=g, dtype=F64)
    z, u = torch.randn(3, 6, generator=g, dtype=F64), torch.rand(3, generator=g, dtype=F64)
    inv_mass = torch.rand(6, generator=g, dtype=F64) + 0.5

    class Draws:
        def momentum(self):
            return z

        def accept(self):
            return u

    lp0, g0 = rs.value_and_grad(lp, q0)
    state = chees.CheesState(q0, lp0, g0)
    eps, T = torch.tensor(0.05, dtype=F64), torch.tensor(0.3, dtype=F64)
    new, _, _, _, n = chees._chees_kernel(lp, state, Draws(), eps, T, inv_mass, 1024,
                                          lambda v: v.mean(0))
    _, _, want, _ = rs.transition(lp, q0, z, u, 0.05, inv_mass, n)
    assert float((new.position - want).abs().max()) <= 1e-12
