"""Shared helpers of the PyTorch-port parity tests (not a test module).

`jax_noise` rebuilds, from a JAX key, exactly the standard-normal draws the
JAX package's `sample_y_once` / `sample_fy_once` make, so the port can be
fed the same numbers:  key -> (k_lat, k_g, k_y)  (models/cnmgp.py:549),
k_lat -> (k_v, k_te, k_diag, k_off)  (:254), k_v -> (k1, k2) inside
`sample_full_cov`  (ops/linalg.py:167).  `jax_train_noise` does the same for
`negative_selbo`, whose key goes straight into (k_v, k_te, k_diag, k_off),
and `jax_prediction_noise` for the `*_predsample` functions of
`models/prediction.py`.
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import cnmgp as jc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
    prediction as tpred,
)
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


def rtol_of_max(got, want, rtol):
    """`assert_close` at rtol, with an atol of rtol times the largest
    magnitude of `want`: entries near zero are held to the output's scale."""
    want = np.asarray(want)
    assert_close(got, want, rtol, atol=rtol * float(np.abs(want).max()))


def _prediction_keys(family, T):
    """How the JAX `<family>_predsample` splits its key, for T Cholesky
    entries: (the keys of each (draw, point), None for one; the split of
    each point's key, None for none)."""
    return {
        "snmgp": (None, 3),  # k_l, k_s, k_y = split(key, 3)  (:224, 176)
        "svc": (None, T + 2),  # split(key, T + 2): tilde_l, T entries, y  (:422, 382)
        "lmc": (None, None),  # the point's key draws y  (:518, 539)
        "snmgp_hadamard": (3, None),  # (S, G, 3, 2), no further split  (:747)
        "lmc_hadamard": (None, None),  # (S, G, 2)  (:817)
        "svc_hadamard": (T + 2, None),  # (S, G, T + 2, 2)  (:883-885)
        "snmgp_latent": (2, None),  # (S, G, 2, 2)  (:612)
        "svc_latent": (T + 1, None),  # (S, G, T + 1, 2)  (:670-671)
    }[family]


def jax_prediction_noise(family, seed, S, G, M, dtype=jnp.float64):
    """The standard-normal draws the JAX `<family>_predsample(...,
    seed=seed)` makes for S draws at G points, as the port's noise tuple of
    CPU tensors (`SNMGPNoise`, `SVCNoise` or `LMCNoise`)."""
    draws = _compiled_prediction_noise(family, S, G, M, jnp.dtype(dtype).name)(
        jax.random.PRNGKey(seed))
    cls = {"snmgp": tpred.SNMGPNoise, "svc": tpred.SVCNoise,
           "lmc": tpred.LMCNoise}[family.split("_")[0]]
    return cls(**{name: torch.as_tensor(np.array(v)).reshape((S, G) + np.shape(v)[1:])
                  for name, v in draws.items()})


@lru_cache(maxsize=None)
def _compiled_prediction_noise(family, S, G, M, dtype):
    T = M * (M + 1) // 2
    per_point, split = _prediction_keys(family, T)

    def normal(k, shape=()):
        return jax.random.normal(k, shape, jnp.dtype(dtype))

    def point(k):
        ks = jax.random.split(k, split) if split else k
        if family in ("lmc", "lmc_hadamard"):
            return {"y": normal(ks, (M,))}
        out = {"tilde_l": normal(ks[0])}
        if family.startswith("snmgp"):
            out["tilde_sigma"] = normal(ks[1])
        else:
            out["L"] = jax.vmap(normal)(ks[1:T + 1])
        if not family.endswith("latent"):
            out["y"] = normal(ks[-1], (M,))
        return out

    def draws(key):
        keys = jax.random.split(key, S * G * (per_point or 1))
        return jax.vmap(point)(keys.reshape((S * G,) + ((per_point,) if per_point else ()) + (2,)))

    return jax.jit(draws).lower(jax.random.PRNGKey(0)).compile(FAST_COMPILE)
