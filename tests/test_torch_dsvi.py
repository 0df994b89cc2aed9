"""The port's DSVI training against the JAX package on the CPU: Adam steps
step for step on the same noise (float64, rtol 1e-8), and one step from a
JAX checkpoint (rtol 1e-10), the masks, the optimizers and the
learning-rate decay, then `inference()` end to end on
`sim_illustration_low_freq(seed=22)` with the assertions of
`tests/test_dsvi_e2e.py` (whose reference pickle is not needed here): the
fit, the divergence rollback, the chunked test trace and the resume.
"""

import os

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
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.optimizers import (
    AdamBf16Moments,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp as tc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import predict as tp
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.mesh import (
    make_mesh,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import checkpoint as tckpt
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import (
    sim_illustration_low_freq,
)
from torch_port_helpers import FAST_COMPILE, assert_close, jax_init_params, jax_train_noise

torch.set_num_threads(1)
D, M_IND, N, B, JITTER = 2, 6, 30, 12, 1e-4
HYPERPARS = {  # tests/test_dsvi_e2e.py:32-40
    "sigma2_L0_log": 0,
    "length_scales_L0_log": 2,
    "sigma2_L1_log": 0,
    "length_scales_L1_log": 2,
    "sigma2_tildeell_log": 0,
    "length_scales_tildeell_log": 0,
    "sigma2_err_log": -2,
}


def _data(seed=0):
    r = np.random.default_rng(seed)
    x = np.sort(r.random(N))
    idx = r.integers(0, D, N)
    y = np.sin(6 * x) + 0.1 * r.standard_normal(N)
    return x, y, idx


def _batches(n_steps, seed=1):
    """n_steps batches of B rows of the data, the last row of each padding
    (weight 0)."""
    r = np.random.default_rng(seed)
    sel = np.stack([r.permutation(N)[:B] for _ in range(n_steps)])
    w = np.ones((n_steps, B))
    w[:, -1] = 0.0
    return sel, w


@pytest.mark.parametrize("clip", [None, 1.0])
def test_adam_steps_match_jax_step_for_step(clip, tmp_path):
    """Five steps of `make_train_step` with Adam (and the global-norm clip)
    against the JAX step with `optax.adam`, on the same parameters, batches
    and noise; the length-scale logs frozen.  Then the JAX state after the
    five steps is saved by the JAX package and loaded by the port into a
    fresh model and optimizer, whose sixth step equals the JAX sixth step
    at rtol 1e-10."""
    x, y, idx = _data()
    sel, w = _batches(6)
    Z = np.linspace(0.0, 1.0, M_IND)
    p0 = jd.apply_hyperpars(jax_init_params(3, D, M_IND), {"length_scales_L0_log": -1.0})
    keys = jax.random.split(jax.random.PRNGKey(7), 6)

    opt = optax.adam(0.02) if clip is None else optax.chain(
        optax.clip_by_global_norm(clip), optax.adam(0.02))
    pj, st, mask = p0, opt.init(p0), jd.freeze_mask(p0, True)
    batch = lambda s: (jnp.asarray(x[sel[s]]), jnp.asarray(y[sel[s]]),  # noqa: E731
                       jnp.asarray(idx[sel[s]]), jnp.asarray(w[s]), keys[s])
    jstep = jd.make_train_step(opt, float(N), JITTER)
    jstep = jstep.lower(pj, st, mask, jnp.asarray(Z), *batch(0)).compile(FAST_COMPILE)
    want_losses = []
    for s in range(5):
        pj, st, loss = jstep(pj, st, mask, jnp.asarray(Z), *batch(s))
        want_losses.append(float(loss))

    pt = tc.CNMGPParams(*(torch.tensor(np.array(a), requires_grad=True) for a in p0))
    step = td.make_train_step(td.make_optimizer(pt, "adam", 0.02), float(N), JITTER,
                              grad_clip_norm=clip)
    tmask = td.freeze_mask(pt, True)
    T = torch.as_tensor
    for s in range(5):
        b = sel[s]
        noise = jax_train_noise(keys[s], M_IND, B, D)
        loss = step(pt, tmask, T(Z), T(x[b]), T(y[b]), T(idx[b]), T(w[s]), noise)
        assert_close(loss, want_losses[s], rtol=1e-8)
    for name, t, a in zip(tc.CNMGPParams._fields, pt, pj):
        assert_close(t, a, rtol=1e-8, atol=1e-12)
    for name in td.FROZEN_WHEN_FIXED:
        assert float(getattr(pt, name).detach()) == float(getattr(p0, name))

    path = os.path.join(tmp_path, "jax.ckpt")
    jckpt.save_train_state(path, pj, st, epoch=4, loss=want_losses[-1])
    pj, st, want = jstep(pj, st, mask, jnp.asarray(Z), *batch(5))
    pr = tc.CNMGPParams(*(torch.zeros_like(t, requires_grad=True) for t in pt))
    opt = td.make_optimizer(pr, "adam", 0.02)
    loaded, leaves = tckpt.load_train_state(path, pr, optimizers.optax_state(opt, pr))
    with torch.no_grad():
        for p, v in zip(pr, loaded):
            p.copy_(v)
    count = optimizers.load_optax_state(opt, pr, leaves)
    step = td.make_train_step(opt, float(N), JITTER, grad_clip_norm=clip, start=count)
    b = sel[5]
    loss = step(pr, td.freeze_mask(pr, True), T(Z), T(x[b]), T(y[b]), T(idx[b]), T(w[5]),
                jax_train_noise(keys[5], M_IND, B, D))
    assert count == 5
    assert_close(loss, float(want), rtol=1e-10)
    for t, a in zip(pr, pj):
        assert_close(t, a, rtol=1e-10, atol=1e-14)


def test_freeze_and_nonfinite_masks(monkeypatch):
    """A non-finite gradient entry is zeroed (so Adam leaves that entry as
    it was) and the frozen length-scale logs do not move; the rest does."""
    pt = tc.init_params(torch.Generator().manual_seed(0), D, M_IND, dtype=torch.float64,
                        device="cpu")
    pt = tc.CNMGPParams(*(t.clone().requires_grad_(True) for t in pt))
    before = [t.detach().clone() for t in pt]
    hole = torch.ones(M_IND, dtype=torch.float64)
    hole[2] = float("nan")

    def loss_with_a_nan_gradient(p, *args):  # d/d mu_v[2] is NaN
        return sum(torch.sum((t - 1.0) ** 2) for t in p) + torch.sum(p.mu_v * hole)

    monkeypatch.setattr(td.cnmgp, "negative_selbo", loss_with_a_nan_gradient)
    step = td.make_train_step(td.make_optimizer(pt, "adam", 0.1), float(N))
    step(pt, td.freeze_mask(pt, True), *([None] * 6))
    assert pt.mu_v.grad[2] == 0.0 and torch.isfinite(pt.mu_v.grad).all()
    assert pt.mu_v[2] == before[0][2] and (pt.mu_v[[0, 1, 3]] != before[0][[0, 1, 3]]).all()
    for name, t, b in zip(tc.CNMGPParams._fields, pt, before):
        if name in td.FROZEN_WHEN_FIXED:
            assert torch.equal(t.detach(), b), name
        elif name != "mu_v":
            assert not torch.equal(t.detach(), b), name
    free = td.freeze_mask(pt, False)
    assert all(bool((m == 1).all()) for m in free)


def test_apply_hyperpars_matches_jax():
    """Each override lands on its own name (the reference's L1 -> L0 slip is
    not copied), as in the JAX package."""
    p0 = jax_init_params(0, D, 4)
    pt = tc.CNMGPParams(*(torch.as_tensor(np.array(a)) for a in p0))
    for over in ({"sigma2_L1_log": 3.0}, HYPERPARS, {}):
        want = jd.apply_hyperpars(p0, over)
        got = td.apply_hyperpars(pt, over)
        for name in tc.CNMGPParams._fields:
            assert_close(getattr(got, name), getattr(want, name), rtol=0)
    assert float(td.apply_hyperpars(pt, {"sigma2_L1_log": 3.0}).sigma2_L0_log) == float(pt.sigma2_L0_log)


def test_adam_bf16_moments_matches_jax():
    """`AdamBf16Moments` against the JAX `adam_bf16_moments` over six steps
    of a quadratic, float32 parameters: the same f32 arithmetic and the same
    bf16 roundings of the moments."""
    r = np.random.default_rng(0)
    target = {"a": r.standard_normal(16).astype(np.float32), "b": r.standard_normal((3, 4)).astype(np.float32)}
    p0 = {"a": np.zeros(16, np.float32), "b": np.ones((3, 4), np.float32)}

    def loss(p):
        return sum(jnp.sum((p[k] - target[k]) ** 2 * (1 + i)) for i, k in enumerate(sorted(p)))

    opt = adam_bf16_moments(0.05)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    st = opt.init(pj)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = AdamBf16Moments([pt[k] for k in sorted(pt)], lr=0.05)
    for _ in range(6):
        up, st = opt.update(jax.grad(loss)(pj), st, pj)
        pj = optax.apply_updates(pj, up)
        topt.zero_grad()
        sum(torch.sum((pt[k] - torch.as_tensor(target[k])) ** 2 * (1 + i))
            for i, k in enumerate(sorted(pt))).backward()
        topt.step()
    for k in p0:
        assert_close(pt[k], pj[k], rtol=1e-6, atol=1e-7)
        mu = topt.state[pt[k]]["mu"]
        assert mu.dtype == torch.bfloat16
        assert_close(mu.float(), np.asarray(st[0].mu[k], np.float32), rtol=1e-2, atol=1e-6)


def test_lr_decay_rates_match_optax_exponential_decay():
    sched = optax.exponential_decay(init_value=0.01, transition_steps=7, decay_rate=0.9)
    ours = td.exponential_decay(0.01, 0.9, 7)
    for t in range(0, 50, 3):
        assert ours(t) == pytest.approx(float(sched(t)), rel=1e-6)


def _one_epoch(**options):
    X, Y, _, _ = sim_illustration_low_freq(seed=1)
    return td.inference(X, Y, np.linspace(0, 1, 4), 0, 2, itnum=1, show_ELBO=False, device="cpu",
                        **options)


@pytest.mark.parametrize(
    "option, value",
    [("PATH", "model.pkl"), ("save_model", True), ("continuous_training", True),
     ("ckpt_moments_dtype", torch.bfloat16), ("mesh", make_mesh()),
     ("divergence_rollback", True), ("chunked_test_trace", True)],
)
def test_deferred_options_raise(option, value, tmp_path, monkeypatch):
    """The options that raised until the checkpoint, the rollback and the
    multi-device layer were ported (the test keeps its name): none raises
    now.  Each, given alone, runs as in the JAX package: a lone `PATH`,
    `save_model`, `continuous_training` or `ckpt_moments_dtype` does
    nothing (no file, the same losses), the rollback guard only observes a
    healthy run, the chunked trace without a test set records nothing, and
    the 1 x 1 mesh of one process gives the same losses bit for bit."""
    monkeypatch.chdir(tmp_path)
    res, base = _one_epoch(**{option: value}), _one_epoch()
    assert res.loss_list == base.loss_list and res.rollbacks == 0 and res.rmse_trace == []
    assert os.listdir(tmp_path) == []


def test_inference_options_run(capsys):
    """Minibatches with a padded last batch, the per-step test RMSE, the
    verbose trace, the stop criterion (first tested after epoch 10),
    lr_decay, the clip and the bf16-moment optimizer."""
    X, Y, Xt, Yt = sim_illustration_low_freq(seed=1)
    res = td.inference(X, Y, np.linspace(0, 1, 5), 64, 2, itnum=10, lr=0.01, lr_decay=0.9,
                       grad_clip_norm=10.0, optimizer="adam_bf16", X_test_list=Xt,
                       Y_test_list=Yt, verbose=True, do_stop_criterion=True, show_ELBO=False,
                       seed=3, device="cpu")
    assert len(res.loss_list) == len(res.time_list) == len(res.rmse_test_list) == 10 * 4
    assert np.all(np.isfinite(res.loss_list)) and np.all(np.isfinite(res.rmse_test_list))
    assert "batch: 4/4" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown optimizer"):
        td.inference(X, Y, np.linspace(0, 1, 5), 64, 2, itnum=1, optimizer="sgd", device="cpu")


@pytest.fixture(scope="module")
def trained():
    """The fit of tests/test_dsvi_e2e.py:43-62 (150 full-batch epochs,
    M = 10, ELBO every 50 epochs over 30 draws), on the CPU in float64."""
    X_list, Y_list, Xt_list, Yt_list = sim_illustration_low_freq(seed=22)
    res = td.inference(X_list, Y_list, np.linspace(0, 1, 10), batch_size=0, dim_outputs=2,
                       lr=0.01, itnum=150, hyperpars=HYPERPARS, fix_hyperpars=True, seed=0,
                       show_ELBO=True, elbo_every=50, elbo_samples=30, dtype=torch.float64,
                       device="cpu")
    return res, (X_list, Y_list, Xt_list, Yt_list)


def test_inference_loss_halves_and_elbo_rises(trained):
    res, _ = trained
    losses = np.asarray(res.loss_list)
    assert losses.shape == (150,) and np.all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:10])
    assert len(res.elbo_trace) == 3 and res.elbo_trace[-1] > res.elbo_trace[0]


def test_inference_hyperpars_applied_and_frozen(trained):
    res, _ = trained
    assert float(res.params.length_scales_L0_log) == 2.0
    assert float(res.params.length_scales_L1_log) == 2.0
    assert float(res.params.length_scales_tildeell_log) == 0.0
    assert float(res.params.sigma2_err_log) != -2.0


def test_inference_predictions_are_sane(trained):
    """sample_Y's mean beats the trivial predictor, predict_Y follows the
    mean of 400 draws, and sample_FY's correlations are valid."""
    res, (_, _, Xt_list, Yt_list) = trained
    ys, ls, gs, tes = tp.sample_Y(res.params, res.Z, Xt_list, n_sample=50, seed=0, device="cpu")
    n_test = sum(len(x) for x in Xt_list)
    assert ys.shape == (50, n_test) and ls.shape == (50, n_test, 2) and gs.shape == (50, 2, n_test)
    y_test = np.concatenate([np.ravel(y) for y in Yt_list])
    assert np.sqrt(np.mean((ys.mean(0).numpy() - y_test) ** 2)) < np.std(y_test)
    est = tp.predict_Y(res.params, res.Z, Xt_list, device="cpu").numpy()
    ys400 = tp.sample_Y(res.params, res.Z, Xt_list, n_sample=400, seed=1, device="cpu")[0]
    assert np.corrcoef(est, ys400.mean(0).numpy())[0, 1] > 0.9
    _, _, corrs = tp.sample_FY(res.params, res.Z, np.linspace(0, 1, 20), n_sample=20, device="cpu")
    np.testing.assert_allclose(np.diagonal(corrs.numpy(), axis1=-2, axis2=-1), 1.0, atol=1e-5)
    assert np.all(np.abs(corrs.numpy()) <= 1.0 + 1e-6)


def test_divergence_rollback_recovers_and_is_inert_when_healthy(capsys):
    """tests/test_dsvi_e2e.py:388-430 on the port: an absurd rate (30) takes
    rollbacks, each halving every param group's rate, and ends with every
    kept loss finite; a healthy run takes none and its losses equal the
    unguarded run's (the guard only observes; here bit for bit, the
    generator untouched); a schedule is refused."""
    X, Y, _, _ = sim_illustration_low_freq(seed=22)
    z = np.linspace(0, 1, 8)
    run = lambda **kw: td.inference(X, Y, z, batch_size=64, dim_outputs=2, show_ELBO=False,  # noqa: E731
                                    dtype=torch.float64, device="cpu", **kw)
    bad = run(itnum=8, lr=30.0, divergence_rollback=True, max_rollbacks=4)
    assert bad.rollbacks >= 1 and len(bad.loss_list) == 8 * 4
    assert np.all(np.isfinite(np.asarray(bad.loss_list)))
    assert "divergence rollback #1: retrying 1 epoch(s) from epoch" in capsys.readouterr().out
    ok_g = run(itnum=6, lr=0.01, divergence_rollback=True)
    ok_u = run(itnum=6, lr=0.01)
    assert ok_g.rollbacks == 0
    np.testing.assert_allclose(np.asarray(ok_g.loss_list), np.asarray(ok_u.loss_list), rtol=1e-5)
    with pytest.raises(ValueError, match="divergence_rollback"):
        run(itnum=4, lr=0.01, lr_decay=0.99, divergence_rollback=True)
    # the JAX package guards only its fast path: with verbose the guard is off
    off = run(itnum=3, lr=30.0, divergence_rollback=True, verbose=True)
    assert off.rollbacks == 0


def test_rollback_restores_the_epoch_it_retries(monkeypatch):
    """A rolled-back epoch is retried from the same parameters, optimizer
    state and generator: a rollback of epoch 1 forced once, with the rate
    kept (factor 1), gives the unguarded run bit for bit, and the lists of
    the retried epoch, the chunked trace's too, are cut back first."""
    X, Y, Xt, Yt = sim_illustration_low_freq(seed=22)
    kw = dict(batch_size=64, dim_outputs=2, itnum=3, lr=0.02, show_ELBO=False, X_test_list=Xt,
              Y_test_list=Yt, chunked_test_trace=True, dtype=torch.float64, device="cpu")
    real, seen = td._diverged, []

    def diverged_at_epoch_1_once(losses, n_before):
        seen.append(n_before)
        return len(seen) == 2 or real(losses, n_before)

    monkeypatch.setattr(td, "_diverged", diverged_at_epoch_1_once)
    res = td.inference(X, Y, np.linspace(0, 1, 6), divergence_rollback=True,
                       rollback_lr_factor=1.0, **kw)
    monkeypatch.setattr(td, "_diverged", real)
    base = td.inference(X, Y, np.linspace(0, 1, 6), **kw)
    assert res.rollbacks == 1 and seen == [0, 4, 4, 8]
    np.testing.assert_array_equal(np.asarray(res.loss_list), np.asarray(base.loss_list))
    assert res.rmse_test_list == base.rmse_test_list and len(res.time_list) == 3 * 4
    assert [e for _, e, _ in res.rmse_trace] == [1, 2, 3]


def test_chunked_test_trace_records_each_epoch_and_trains_alike():
    """chunked_test_trace: one (wall seconds, epochs done, rmse) entry per
    epoch, `rmse_test_list` the same RMSEs; training consumes the same
    generator draws as with the per-step RMSE, so the last RMSE of the two
    runs and their losses agree (rtol 1e-10, float64)."""
    X, Y, Xt, Yt = sim_illustration_low_freq(seed=22)
    kw = dict(batch_size=64, dim_outputs=2, itnum=3, show_ELBO=False, X_test_list=Xt,
              Y_test_list=Yt, dtype=torch.float64, device="cpu")
    per_step = td.inference(X, Y, np.linspace(0, 1, 8), **kw)
    chunked = td.inference(X, Y, np.linspace(0, 1, 8), chunked_test_trace=True, **kw)
    assert len(per_step.rmse_test_list) == 3 * 4 and per_step.rmse_trace == []
    assert [e for _, e, _ in chunked.rmse_trace] == [1, 2, 3]
    assert [r for _, _, r in chunked.rmse_trace] == chunked.rmse_test_list
    times = [t for t, _, _ in chunked.rmse_trace]
    assert times == sorted(times) and times[0] > 0
    np.testing.assert_allclose(chunked.rmse_test_list[-1], per_step.rmse_test_list[-1], rtol=1e-10)
    np.testing.assert_allclose(chunked.loss_list, per_step.loss_list, rtol=1e-10)
    # verbose takes the per-step path, as in the JAX package
    v = td.inference(X, Y, np.linspace(0, 1, 8), chunked_test_trace=True, verbose=True, **kw)
    assert v.rmse_trace == [] and len(v.rmse_test_list) == 3 * 4


@pytest.mark.parametrize("optimizer", ["adam", "adam_bf16"])
def test_inference_resume_from_checkpoint(tmp_path, optimizer):
    """tests/test_dsvi_e2e.py:186-204 on the port: a run saves, a second
    resumes from PATH and starts far below a fresh start; the frozen
    length scales are re-applied from `hyperpars`."""
    X, Y, _, _ = sim_illustration_low_freq(seed=22)
    z = np.linspace(0, 1, 6)
    path = os.path.join(tmp_path, "ckpt.pkl")
    kw = dict(batch_size=0, dim_outputs=2, lr=0.01, hyperpars=HYPERPARS, seed=0, show_ELBO=False,
              PATH=path, optimizer=optimizer, device="cpu")
    res1 = td.inference(X, Y, z, itnum=20, save_model=True, **kw)
    res2 = td.inference(X, Y, z, itnum=10, continuous_training=True, **kw)
    assert res2.loss_list[0] < 0.7 * res1.loss_list[0]
    assert float(res2.params.length_scales_L0_log) == 2.0
    assert tckpt.LAST_IO_SECONDS["load"] is not None


def test_a_jax_trained_model_resumes_in_the_port(tmp_path):
    """The JAX `inference()` trains 20 epochs and saves (PATH, save_model);
    the port's `inference()` resumes from that file below 0.7x a fresh
    start (the criterion of tests/test_dsvi_e2e.py:186-204), trains on and
    saves; the JAX package resumes from the port's file as far below."""
    X, Y, _, _ = sim_illustration_low_freq(seed=22)
    z = np.linspace(0, 1, 6)
    path = os.path.join(tmp_path, "jax.pkl")
    kw = dict(batch_size=0, dim_outputs=2, lr=0.01, hyperpars=HYPERPARS, seed=0, show_ELBO=False,
              PATH=path)
    j1 = jd.inference(X, Y, z, itnum=20, save_model=True, **kw)
    t2 = td.inference(X, Y, z, itnum=2, continuous_training=True, save_model=True,
                      dtype=torch.float64, device="cpu", **kw)
    fresh = td.inference(X, Y, z, itnum=1, dtype=torch.float64, device="cpu",
                         **{k: v for k, v in kw.items() if k != "PATH"})
    assert t2.loss_list[0] < 0.7 * fresh.loss_list[0]
    j3 = jd.inference(X, Y, z, itnum=2, continuous_training=True, **kw)
    assert j3.loss_list[0] < 0.7 * j1.loss_list[0]
