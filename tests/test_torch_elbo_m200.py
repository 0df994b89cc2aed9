"""The ELBO at ECoG's M = 200 inducing points on the CPU: the port's
`negative_selbo` value and every gradient against `jax.value_and_grad` of
the JAX package's, in float64, through the plain versions of the kernels
(the size at which the two quadform backward kernels of the first port
refused to run on the card).  A small batch keeps it quick; the tolerances
are `test_torch_elbo.py`'s: values rtol 1e-10, gradients 1e-8 with an atol
of 1e-10 of each parameter's largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import cnmgp as jc
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops import linalg as jl
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp as tc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)
from torch_port_helpers import assert_close, jax_init_params, jax_train_noise, jax_value_and_grad

torch.set_num_threads(1)
M_IND, B, N_TOTAL, JITTER = 200, 16, 62_400.0, 1e-4


def _jax_loss(p, Z, x, y, idx, w, key):
    return jc.negative_selbo(p, Z, x, y, idx, w, N_TOTAL, key, JITTER, "true")


@pytest.mark.parametrize("D", [1, 2])
def test_negative_selbo_at_m200_matches_jax(D):
    """ECoG's time axis (Z = linspace(0, 800, 200)), lengthscales of 40 so
    every prior gram is dense, a batch of 16 whose last row is padding."""
    r = np.random.default_rng(200 + D)
    log40 = jnp.asarray(np.log(40.0))
    p = jax_init_params(D, D, M_IND)._replace(
        mu_v=jnp.asarray(np.log(40.0) + 0.1 * r.standard_normal(M_IND)),
        length_scales_tildeell_log=log40, length_scales_L0_log=log40, length_scales_L1_log=log40)
    Z = np.linspace(0.0, 800.0, M_IND)
    x = np.sort(r.uniform(0.0, 800.0, B))
    idx = r.integers(0, D, B)
    y = np.sin(x / 40.0) + 0.1 * r.standard_normal(B)
    w = np.ones(B)
    w[-1] = 0.0
    key = jax.random.PRNGKey(D)
    want, want_grads = jax_value_and_grad(_jax_loss, p, *map(jnp.asarray, (Z, x, y, idx, w)), key)
    pt = tc.CNMGPParams(*(torch.tensor(np.array(a), requires_grad=True) for a in p))
    noise = jax_train_noise(key, M_IND, B, D)
    loss = tc.negative_selbo(pt, *map(torch.as_tensor, (Z, x, y, idx, w)), N_TOTAL, noise, JITTER)
    loss.backward()
    assert_close(loss, want, rtol=1e-10)
    for name, t, g in zip(jc.CNMGPParams._fields, pt, want_grads):
        g = np.asarray(g)
        assert t.grad is not None, name
        assert_close(t.grad, g, rtol=1e-8, atol=1e-10 * max(np.abs(g).max(), 1e-300))


def test_quadform_backward_plain_at_m200_matches_jax_vjp():
    """dA and dW's lower triangle of the two backward kernels' plain
    versions at M = 200 against `jax.vjp` of the JAX `_quadform_diag`."""
    r = np.random.default_rng(3)
    M, N, G = 200, 24, 5
    A = r.standard_normal((M, N))
    W = np.tril(r.standard_normal((G, M, M)))
    vbar = r.standard_normal((G, N))
    _, vjp = jax.vjp(jl._quadform_diag, jnp.asarray(A), jnp.asarray(W))
    dA_ref, dW_ref = vjp(jnp.asarray(vbar))
    T = torch.as_tensor
    assert_close(ck.quadform_diag_da_plain(T(A), T(W), T(vbar)), dA_ref, rtol=1e-10, atol=1e-12)
    assert_close(ck.quadform_diag_dw_plain(T(A), T(W), T(vbar)), np.tril(np.asarray(dW_ref)),
                 rtol=1e-10, atol=1e-12)
