"""The port's checkpoint (`utils/checkpoint.py`, `infer/optimizers.optax_state`)
against the JAX package's on the CPU, in float64: a state that either
package saves loads in the other with the parameters and every optimizer
leaf bit for bit (bf16 moments stay bf16), and the step after the load is
the other package's step (rtol 1e-10 for Adam; the bf16-moment optimizer
computes its update in float32, so its step is held at rtol 1e-6, as
`tests/test_torch_dsvi.py` holds that optimizer; `_step_tol`).  Also the
legacy dense-U migration, the bf16 down-cast of a save, and the ml_dtypes
condition.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu.infer import dsvi as jd
from collaborative_nonstationary_multivariate_gaussian_process_tpu.infer.optimizers import (
    adam_bf16_moments,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import cnmgp as jc
from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils import checkpoint as jckpt
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi as td
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import optimizers
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp as tc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import checkpoint as tckpt
from torch_port_helpers import FAST_COMPILE, assert_close, jax_init_params, jax_train_noise

torch.set_num_threads(1)
D, M_IND, N, B, JITTER, LR = 2, 6, 30, 12, 1e-4, 0.02

# (optimizer, grad_clip_norm, optax layout): the layouts the JAX inference()
# builds, plain, under divergence_rollback (inject_hyperparams) and with a
# schedule (lr_decay)
CASES = [("adam", None, "plain"), ("adam", 1.0, "plain"), ("adam_bf16", None, "plain"),
         ("adam_bf16", 1.0, "plain"), ("adam", None, "inject"), ("adam_bf16", 1.0, "inject"),
         ("adam", 1.0, "schedule")]


def _data():
    r = np.random.default_rng(0)
    x = np.sort(r.random(N))
    idx = r.integers(0, D, N)
    y = np.sin(6 * x) + 0.1 * r.standard_normal(N)
    sel = np.stack([r.permutation(N)[:B] for _ in range(4)])
    w = np.ones((4, B))
    w[:, -1] = 0.0
    return x, y, idx, sel, w


def _jax_opt(name, clip, layout):
    core = optax.adam if name == "adam" else adam_bf16_moments
    lr = optax.exponential_decay(init_value=LR, transition_steps=3, decay_rate=0.9) \
        if layout == "schedule" else LR
    opt = optax.inject_hyperparams(core)(learning_rate=lr) if layout == "inject" else core(lr)
    return opt if clip is None else optax.chain(optax.clip_by_global_norm(clip), opt)


def _port_opt(params, name, layout):
    schedule = td.exponential_decay(LR, 0.9, 3) if layout == "schedule" else None
    return td.make_optimizer(params, name, LR if schedule is None else 0.0), schedule


def _layout(layout):
    return dict(inject=layout == "inject", schedule=layout == "schedule")


class _Jax:
    """The JAX side: its train step on the test's batches and keys."""

    def __init__(self, name, clip, layout):
        self.x, self.y, self.idx, self.sel, self.w = _data()
        self.opt = _jax_opt(name, clip, layout)
        self.keys = jax.random.split(jax.random.PRNGKey(7), 4)
        self.p0 = jd.apply_hyperpars(jax_init_params(3, D, M_IND), {"length_scales_L0_log": -1.0})
        self.mask = jd.freeze_mask(self.p0, True)
        self.Z = jnp.linspace(0.0, 1.0, M_IND)
        step = jd.make_train_step(self.opt, float(N), JITTER)
        st = self.opt.init(self.p0)
        self.step = step.lower(self.p0, st, self.mask, self.Z, *self.batch(0)).compile(FAST_COMPILE)

    def batch(self, s):
        b = self.sel[s]
        return (jnp.asarray(self.x[b]), jnp.asarray(self.y[b]), jnp.asarray(self.idx[b]),
                jnp.asarray(self.w[s]), self.keys[s])

    def run(self, p, st, steps):
        for s in steps:
            p, st, _ = self.step(p, st, self.mask, self.Z, *self.batch(s))
        return p, st


def _port_step(jx, opt, schedule, clip, start):
    step = td.make_train_step(opt, float(N), JITTER, grad_clip_norm=clip, lr=schedule, start=start)
    T = torch.as_tensor

    def run(pt, steps):
        mask = td.freeze_mask(pt, True)
        for s in steps:
            b = jx.sel[s]
            step(pt, mask, T(np.array(jx.Z)), T(jx.x[b]), T(jx.y[b]), T(jx.idx[b]), T(jx.w[s]),
                 jax_train_noise(jx.keys[s], M_IND, B, D))

    return run


def _fresh_port(jx, name, layout):
    pt = tc.CNMGPParams(*(torch.tensor(np.array(a), requires_grad=True) for a in jx.p0))
    opt, schedule = _port_opt(pt, name, layout)
    return pt, opt, schedule


def _assert_leaves_equal(port_leaves, jax_leaves):
    assert len(port_leaves) == len(jax_leaves)
    for i, (t, a) in enumerate(zip(port_leaves, jax_leaves)):
        a = np.asarray(a)
        got = t.detach().cpu()
        if a.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, i
            np.testing.assert_array_equal(got.double().numpy(), a.astype(np.float64), err_msg=str(i))
        else:
            assert str(got.dtype).removeprefix("torch.") == a.dtype.name, (i, got.dtype, a.dtype)
            np.testing.assert_array_equal(got.numpy(), a, err_msg=str(i))


def _step_tol(name, layout):
    """(rtol, atol) of the step after the load.  Adam: 1e-10, and with a
    schedule an atol of 1e-7 of the step size, since optax computes the
    schedule's rate in float32 (`test_lr_decay_rates_match_optax_
    exponential_decay`).  The bf16-moment optimizer computes in float32:
    1e-6; under inject_hyperparams the JAX side's injected b1, b2 and eps
    are float64 arrays in these x64 tests and promote its moment arithmetic
    to float64 (float32 in a JAX run without x64), so 1e-4 there."""
    if name == "adam":
        return 1e-10, (1e-7 * LR if layout == "schedule" else 1e-14)
    return (1e-4 if layout == "inject" else 1e-6), 1e-14


@pytest.mark.parametrize("name, clip, layout", CASES)
def test_a_jax_checkpoint_loads_in_the_port_and_steps_as_jax(tmp_path, name, clip, layout):
    """The JAX package trains three steps and saves; the port loads the file
    into a fresh model: parameters and optax leaves equal bit for bit (the
    injected rate, rolled back once, becomes the param groups' rate), and
    the next step equals the JAX step."""
    jx = _Jax(name, clip, layout)
    pj, st = jx.run(jx.p0, jx.opt.init(jx.p0), range(3))
    if layout == "inject":
        st = jd._scale_injected_lr(st, 0.5)
    path = os.path.join(tmp_path, "jax.ckpt")
    jckpt.save_train_state(path, pj, st, epoch=2, loss=1.5)

    pt, opt, schedule = _fresh_port(jx, name, layout)
    like = optimizers.optax_state(opt, pt, **_layout(layout))
    loaded, leaves = tckpt.load_train_state(path, pt, like)
    with torch.no_grad():
        for p, v in zip(pt, loaded):
            p.copy_(v)
    count = optimizers.load_optax_state(opt, pt, leaves, **_layout(layout))
    assert count == 3
    _assert_leaves_equal(list(pt), jax.tree_util.tree_leaves(pj))
    _assert_leaves_equal(optimizers.optax_state(opt, pt, **_layout(layout)),
                         jax.tree_util.tree_leaves(st))
    if layout == "inject":
        assert opt.param_groups[0]["lr"] == 0.5 * LR

    pj, _ = jx.run(pj, st, [3])
    _port_step(jx, opt, schedule, clip, count)(pt, [3])
    for t, a in zip(pt, pj):
        assert_close(t, a, *_step_tol(name, layout))


@pytest.mark.parametrize("name, clip, layout", CASES)
def test_a_port_checkpoint_loads_in_jax_and_steps_as_the_port(tmp_path, name, clip, layout):
    """The port trains three steps on the JAX draws and saves; the JAX
    package loads the file into its own state: leaves equal bit for bit,
    and its next step equals the port's."""
    jx = _Jax(name, clip, layout)
    pt, opt, schedule = _fresh_port(jx, name, layout)
    _port_step(jx, opt, schedule, clip, 0)(pt, range(3))
    if layout == "inject":
        opt.param_groups[0]["lr"] *= 0.5
    path = os.path.join(tmp_path, "port.ckpt")
    tckpt.save_train_state(path, pt, optimizers.optax_state(opt, pt, **_layout(layout)), epoch=2,
                           loss=1.5)

    pj, st = jckpt.load_train_state(path, jx.p0, jx.opt.init(jx.p0))
    _assert_leaves_equal(list(pt), jax.tree_util.tree_leaves(pj))
    _assert_leaves_equal(optimizers.optax_state(opt, pt, **_layout(layout)),
                         jax.tree_util.tree_leaves(st))
    pj, _ = jx.run(pj, st, [3])
    _port_step(jx, opt, schedule, clip, 3)(pt, [3])
    for t, a in zip(pt, pj):
        assert_close(t, a, *_step_tol(name, layout))


def test_legacy_dense_U_checkpoint_is_packed_as_jax_packs_it(tmp_path):
    """tests/test_dsvi_e2e.py:282-323 on the port: a JAX checkpoint of the
    dense (D, D, M[, M]) mu_U/sqrt_U layout loads packed (the moments
    too), as the JAX package loads it; another mismatch raises."""
    Dl, M = 3, 5
    params = jc.init_params(jax.random.PRNGKey(0), Dl, M, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    dense_mu, dense_sqrt = rng.standard_normal((Dl, Dl, M)), rng.standard_normal((Dl, Dl, M, M))
    legacy = params._replace(mu_U=jnp.asarray(dense_mu), sqrt_U=jnp.asarray(dense_sqrt))
    path = os.path.join(tmp_path, "legacy.ckpt")
    jckpt.save_train_state(path, legacy, optax.adam(0.01).init(legacy), epoch=1, loss=0.0)

    pt = tc.CNMGPParams(*(torch.tensor(np.array(a), requires_grad=True) for a in params))
    opt = td.make_optimizer(pt, "adam", 0.01)
    like = optimizers.optax_state(opt, pt)
    p2, o2 = tckpt.load_train_state(path, pt, like)
    np.testing.assert_array_equal(p2.mu_U.numpy(), np.asarray(jc.pack_U(dense_mu)))
    np.testing.assert_array_equal(p2.sqrt_U.numpy(), np.asarray(jc.pack_U(dense_sqrt)))
    assert [tuple(t.shape) for t in o2] == [tuple(t.shape) for t in like]
    pj, oj = jckpt.load_train_state(path, params, optax.adam(0.01).init(params))
    _assert_leaves_equal(list(p2), jax.tree_util.tree_leaves(pj))
    _assert_leaves_equal(o2, jax.tree_util.tree_leaves(oj))

    bad = params._replace(mu_v=jnp.zeros(M + 1))
    path2 = os.path.join(tmp_path, "bad.ckpt")
    jckpt.save_train_state(path2, bad, optax.adam(0.01).init(bad))
    with pytest.raises(ValueError, match="legacy checkpoint layout"):
        tckpt.load_train_state(path2, pt, like)
    with pytest.raises(ValueError, match="other optimizer options"):  # saved without the rollback
        tckpt.load_train_state(path, pt, optimizers.optax_state(opt, pt, inject=True))


def _stepped_adam(dtype):
    """Parameters (D = 3, M = 40: the arrays outweigh the file's own bytes)
    and an Adam stepped once on gradients of 0.321, so every moment is
    nonzero (tests/test_dsvi_e2e.py:147-153)."""
    pt = tc.init_params(torch.Generator().manual_seed(0), 3, 40, dtype=dtype, device="cpu")
    pt = tc.CNMGPParams(*(t.clone().requires_grad_(True) for t in pt))
    opt = td.make_optimizer(pt, "adam", 0.01)
    for p in pt:
        p.grad = torch.full_like(p, 0.321)
    opt.step()
    return pt, opt


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bf16_moments_save_is_smaller_and_round_trips(tmp_path, dtype):
    """save_train_state(moments_dtype=torch.bfloat16): under 0.75x the full
    file, the parameters bit for bit, the moments back in the optimizer's
    dtype within bf16's 2^-8; the JAX package reads the same values."""
    pt, opt = _stepped_adam(dtype)
    state = optimizers.optax_state(opt, pt)
    full, half = os.path.join(tmp_path, "f.ckpt"), os.path.join(tmp_path, "bf16.ckpt")
    tckpt.save_train_state(full, pt, state)
    tckpt.save_train_state(half, pt, state, moments_dtype=torch.bfloat16)
    assert os.path.getsize(half) < 0.75 * os.path.getsize(full)
    assert tckpt.LAST_IO_SECONDS["save"] is not None
    p2, o2 = tckpt.load_train_state(half, pt, state)
    for a, b in zip(pt, p2):
        assert torch.equal(a.detach(), b)
    for a, b in zip(state, o2):
        assert a.dtype == b.dtype
        if a.is_floating_point():
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2 ** -8, atol=1e-12)
        else:
            assert torch.equal(a, b)
    jp = tuple(np.asarray(t.detach()) for t in pt)
    jstate = [np.asarray(t) for t in state]
    _, oj = jckpt.load_train_state(half, jp, jstate)
    for a, b in zip(o2, oj):
        np.testing.assert_array_equal(a.numpy(), b)


def test_bf16_needs_ml_dtypes_and_says_so(tmp_path, monkeypatch):
    """Without ml_dtypes a bf16 save and the load of a bf16 file raise
    ImportError naming it; a float file still loads."""
    pt, opt = _stepped_adam(torch.float32)
    state = optimizers.optax_state(opt, pt)
    half, full = os.path.join(tmp_path, "bf16.ckpt"), os.path.join(tmp_path, "f.ckpt")
    tckpt.save_train_state(half, pt, state, moments_dtype="bfloat16")
    tckpt.save_train_state(full, pt, state)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError, match="ml_dtypes"):
        tckpt.save_train_state(os.path.join(tmp_path, "x.ckpt"), pt, state,
                               moments_dtype=torch.bfloat16)
    with pytest.raises(ImportError, match="ml_dtypes"):
        tckpt.load_train_state(half, pt, state)
    p2, _ = tckpt.load_train_state(full, pt, state)
    assert torch.equal(p2.mu_v, pt.mu_v.detach())


def test_pytree_files_are_read_by_both_packages(tmp_path):
    """save_pytree / load_pytree: a named tuple and a dict (sorted keys, as
    JAX flattens it) through the port's file and the JAX one."""
    tree = {"b": torch.arange(3.0), "a": (torch.ones(2, 2, dtype=torch.float64), torch.tensor(4))}
    path = os.path.join(tmp_path, "tree.pkl")
    tckpt.save_pytree(path, tree)
    back = tckpt.load_pytree(path, tree)
    assert torch.equal(back["b"], tree["b"]) and torch.equal(back["a"][0], tree["a"][0])
    jt = jckpt.load_pytree(path, {"b": np.zeros(3), "a": (np.zeros((2, 2)), np.zeros(()))})
    np.testing.assert_array_equal(np.asarray(jt["b"]), np.arange(3.0))
    params = jax_init_params(1, D, M_IND)
    jckpt.save_pytree(path, params)
    like = tc.CNMGPParams(*(torch.zeros(np.shape(a), dtype=torch.float64) for a in params))
    got = tckpt.load_pytree(path, like)
    assert isinstance(got, tc.CNMGPParams)
    for t, a in zip(got, params):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_orbax_backend_is_not_ported(tmp_path):
    """The orbax backend, which raised until the multi-device layer was
    ported (the test keeps its name), saves a directory checkpoint of the
    train state and loads it back bit for bit, in one process without a
    process group (tests/test_torch_checkpoint_dir.py holds two ranks)."""
    pt, opt = _stepped_adam(torch.float32)
    state = optimizers.optax_state(opt, pt)
    path = os.path.join(tmp_path, "o")
    tckpt.save_train_state(path, pt, state, epoch=5, backend="orbax")
    assert os.path.isdir(path)
    p2, o2 = tckpt.load_train_state(path, pt, state, backend="orbax")
    for a, b in zip(list(pt) + list(state), list(p2) + list(o2)):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b)
