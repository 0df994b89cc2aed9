"""The port's `inference()` takes every keyword of the JAX package's, with
the same plain defaults, and its `DSVIResult` has every field of the JAX
one, so a script written for the JAX package calls the port unchanged (the
data-parallel option, `mesh`, takes the port's `parallel.mesh.Mesh`)."""

import dataclasses
import inspect

import numpy as np
import pytest

from collaborative_nonstationary_multivariate_gaussian_process_tpu.infer import dsvi as jd
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi as td
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import (
    sim_illustration_low_freq,
)

JAX_PARAMS = inspect.signature(jd.inference).parameters
PORT_PARAMS = inspect.signature(td.inference).parameters


@pytest.mark.parametrize("name", list(JAX_PARAMS))
def test_every_jax_parameter_is_the_ports_with_its_default(name):
    assert name in PORT_PARAMS
    want, got = JAX_PARAMS[name], PORT_PARAMS[name]
    assert got.kind == want.kind
    if want.default is inspect.Parameter.empty or isinstance(want.default, (type(None), bool, int, float, str)):
        assert got.default == want.default and type(got.default) is type(want.default)
    jax_order = [n for n in JAX_PARAMS]
    port_order = [n for n in PORT_PARAMS if n in JAX_PARAMS]
    assert port_order == jax_order  # positional calls bind alike


def test_every_jax_result_field_is_the_ports():
    jax_fields = {f.name: f for f in dataclasses.fields(jd.DSVIResult)}
    port_fields = {f.name: f for f in dataclasses.fields(td.DSVIResult)}
    assert set(jax_fields) <= set(port_fields)
    for name in ("rmse_trace", "rollbacks"):
        want, got = jax_fields[name], port_fields[name]
        made = lambda f: f.default_factory() if f.default is dataclasses.MISSING else f.default  # noqa: E731
        assert made(got) == made(want)


def test_rollback_keywords_are_taken_and_the_result_carries_the_new_fields():
    X, Y, _, _ = sim_illustration_low_freq(seed=1)
    res = td.inference(X, Y, np.linspace(0, 1, 4), 0, 2, itnum=2, show_ELBO=False,
                       rollback_lr_factor=0.25, max_rollbacks=2, device="cpu")
    assert res.rmse_trace == [] and res.rollbacks == 0 and len(res.loss_list) == 2
    # with divergence_rollback the keywords run the guard (no rollback on this healthy run)
    guarded = td.inference(X, Y, np.linspace(0, 1, 4), 0, 2, itnum=2, show_ELBO=False,
                           device="cpu", divergence_rollback=True, rollback_lr_factor=0.25,
                           max_rollbacks=2)
    assert guarded.rollbacks == 0 and guarded.loss_list == res.loss_list
