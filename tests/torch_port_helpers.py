"""Shared helpers of the PyTorch-port parity tests (not a test module).

`jax_noise` rebuilds, from a JAX key, exactly the standard-normal draws the
JAX package's `sample_y_once` / `sample_fy_once` make, so the port can be
fed the same numbers:  key -> (k_lat, k_g, k_y)  (models/cnmgp.py:549),
k_lat -> (k_v, k_te, k_diag, k_off)  (:254), k_v -> (k1, k2) inside
`sample_full_cov`  (ops/linalg.py:167).  `jax_train_noise` does the same for
`negative_selbo`, whose key goes straight into (k_v, k_te, k_diag, k_off).
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import cnmgp as jc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models.cnmgp import (
    CNMGPNoise,
)


def _latent_draw(k_lat, M, B, D, dtype):
    k_v, k_te, k_diag, k_off = jax.random.split(k_lat, 4)
    k1, k2 = jax.random.split(k_v)
    normal = lambda k, shape: jax.random.normal(k, shape, dtype)
    return dict(
        z_v1=normal(k1, (M,)),
        z_v2=normal(k2, (M,)),
        z_te=normal(k_te, (B,)),
        z_diag=normal(k_diag, (D, B)),
        z_off=normal(k_off, (D * (D - 1) // 2, B)),
    )


def _one_draw(key, M, B, D, all_outputs, dtype):
    k_lat, k_g, k_y = jax.random.split(key, 3)
    normal = lambda k, shape: jax.random.normal(k, shape, dtype)
    return dict(
        **_latent_draw(k_lat, M, B, D, dtype),
        z_g=normal(k_g, (D, B)),
        z_y=normal(k_y, (B, D) if all_outputs else (B,)),
    )


def jax_noise(keys, M, B, D, all_outputs=False, dtype=jnp.float64) -> CNMGPNoise:
    """The JAX package's draws for each key of `keys`, stacked along a
    leading draw dimension, as a CPU `CNMGPNoise` of tensors."""
    draws = run_jax(jax.vmap(lambda k: _one_draw(k, M, B, D, all_outputs, dtype)), jnp.asarray(keys))
    return CNMGPNoise(**{name: torch.as_tensor(np.array(draws[name])) for name in CNMGPNoise._fields})


def jax_train_noise(key, M, B, D, dtype=jnp.float64) -> CNMGPNoise:
    """The draws `negative_selbo(..., key)` makes, as a CPU `CNMGPNoise`
    with a leading S = 1 (z_g and z_y None).  Given a stack of keys (as
    `elbo_estimate` splits its key), one draw per key along S."""
    keys = jnp.asarray(key)
    keys = keys[None] if keys.ndim == 1 else keys
    draws = _compiled_train_noise(M, B, D, jnp.dtype(dtype).name, keys.shape)(keys)
    fields = {name: torch.as_tensor(np.array(v)) for name, v in draws.items()}
    return CNMGPNoise(**fields, z_g=None, z_y=None)


@lru_cache(maxsize=None)
def _compiled_train_noise(M, B, D, dtype, key_shape):
    fn = jax.vmap(lambda k: _latent_draw(k, M, B, D, jnp.dtype(dtype)))
    return jax.jit(fn).lower(jax.ShapeDtypeStruct(key_shape, jnp.uint32)).compile(FAST_COMPILE)


# The JAX references are compiled once per shape; without backend
# optimization that takes about half as long, and these are small problems.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def run_jax(fn, *args):
    """fn(*args) under jax.jit, compiled without XLA's backend optimization."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


_VALUE_AND_GRAD = {}


def jax_value_and_grad(fn, *args):
    """jax.value_and_grad(fn)(*args), argument 0 differentiated, compiled
    once per (fn, argument structure, shapes and dtypes) and reused."""
    leaves, tree = jax.tree_util.tree_flatten(args)
    key = (fn, tree, tuple((np.shape(a), np.result_type(a)) for a in leaves))
    if key not in _VALUE_AND_GRAD:
        _VALUE_AND_GRAD[key] = jax.jit(jax.value_and_grad(fn)).lower(*args).compile(FAST_COMPILE)
    return _VALUE_AND_GRAD[key](*args)


@lru_cache(maxsize=None)
def _compiled_init_params(D, M):
    fn = partial(jc.init_params, dim_outputs=D, num_inducing=M, dtype=jnp.float64)
    return jax.jit(fn).lower(jax.random.PRNGKey(0)).compile(FAST_COMPILE)


def jax_init_params(seed, D, M):
    """The JAX package's `init_params(PRNGKey(seed), D, M)` in float64,
    compiled once per shape (run op by op it compiles every op anew for
    each new D, which costs seconds)."""
    return _compiled_init_params(D, M)(jax.random.PRNGKey(seed))


def assert_close(got, want, rtol, atol=0.0):
    """Compare a tensor (or array) with a JAX/numpy reference."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)
