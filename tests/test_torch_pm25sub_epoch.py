"""The port's fused DSVI trainer (`infer/dsvi.make_scan_epochs`) over one
whole heterotopic epoch, op by op on the CPU in float64, against the
benchmark's plain reference (`portbench/reference/cnmgp.negative_selbo`)
with Adam written out, at small PM2.5-like sizes: the PM2.5 study's
hyperparameters, rate and starting scales (the reference's
`code/NMGP_PM25.py`, `drivers/run_workload.WORKLOADS["pm25"]`), outputs of
unequal lengths, several batches, the last padded with rows of weight 0.

Both sides take the same data (`portbench.data.observations`), the same
starting weights (`portbench.data.cnmgp_weights`), the same shuffle keys
and the same noise (`portbench.data.sort_keys`, `train_noise`, in the
port's draw order from one seeded generator).  The reference shares no
code with the port, so the two agree to float64 rounding only: every
step's loss within rtol 1e-10 (the largest gap read, 3.6e-13) and every
parameter entry after the epoch within 1e-10 (a hundred-millionth of the
rate, 0.01, by which Adam moves an entry each step; a wrong gradient moves
it by about the rate).  The largest parameter gap read, 6.1e-12, is on
sigma2_tildeell_log: its gradient passes through the tilde-ell Gram, near
singular at the frozen length-scale log of 10 (condition ~ M / jitter),
and Adam's later steps carry its relative rounding, ~1e-10.  The D = 2
case has one offdiagonal group, which keeps the test honest about the
group sets' sizes.
"""

import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi as td
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp as tc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import profiling
from portbench import data
from portbench.reference import cnmgp as ref

torch.set_num_threads(1)
# Adam 0.01, the three length-scale logs frozen at 10, mu_v = 1, the
# variance logs at 0 and the noise's at the port's starting -2
STUDY = dict(
    lr=0.01, jitter=1e-4, init_scale_mean=0.1, init_scale_sqrt=0.1, mu_v_init=1.0,
    log_hyperpars={"sigma2_tildeell_log": 0.0, "length_scales_tildeell_log": 10.0,
                   "sigma2_L0_log": 0.0, "length_scales_L0_log": 10.0,
                   "sigma2_L1_log": 0.0, "length_scales_L1_log": 10.0, "sigma2_err_log": -2.0},
    frozen=["length_scales_tildeell_log", "length_scales_L0_log", "length_scales_L1_log"],
)
F64 = torch.float64
B1, B2, EPS = 0.9, 0.999, 1e-8
LOSS_RTOL, PARAM_ATOL = 1e-10, 1e-10
# 60 rows in 4 batches of 16 (4 rows of padding); 22 rows in 3 batches of 8 (2)
CASES = {
    "d6": dict(D=6, M=7, B=16, lengths=[13, 9, 11, 9, 9, 9]),
    "d2": dict(D=2, M=7, B=8, lengths=[13, 9]),
}
SEED_W, SEED_D = 2**33 + 101, 2**40 + 7


def _config(case):
    c = CASES[case]
    span = float(sum(c["lengths"]))
    return dict(STUDY, D=c["D"], M=c["M"], B=c["B"],
                data={"generator": "sine", "lengths": c["lengths"], "x_max": span,
                      "period": span / 20})


def _port_epoch(cfg, x, y, idx, Z, w):
    """One epoch of the port's fused trainer: its (num_batches,) losses and
    the parameters after it."""
    D, M, B = cfg["D"], cfg["M"], cfg["B"]
    n = x.shape[0]
    params = tc.init_params(torch.Generator().manual_seed(0), D, M, dtype=F64, device="cpu",
                            **{k: w[k].clone() for k in tc.CNMGPParams._fields[:6]})
    params = td.apply_hyperpars(params, cfg["log_hyperpars"])
    params = tc.CNMGPParams(*(t.requires_grad_(True) for t in params))
    mask = td.freeze_mask(params, bool(cfg["frozen"]))
    opt = td.make_optimizer(params, "adam", cfg["lr"])
    run = td.make_scan_epochs(opt, float(n), cfg["jitter"], -(-n // B), B)
    losses = run(params, mask, Z, x, y, idx, torch.Generator().manual_seed(SEED_D), 1)
    return losses, dict(zip(ref.FIELDS, (p.detach() for p in params)))


def _reference_epoch(cfg, x, y, idx, Z, w):
    """The same epoch in the plain reference: the rows sorted by the same
    keys and zero-padded, each step's noise drawn at the full batch, the
    masked Adam of the trainer (non-finite gradient entries to 0, the frozen
    logs held)."""
    D, M, B = cfg["D"], cfg["M"], cfg["B"]
    n = x.shape[0]
    nb = -(-n // B)
    gen = torch.Generator().manual_seed(SEED_D)
    order = torch.sort(data.sort_keys(gen, n), stable=True).indices
    pad = nb * B - n

    def padded(a):
        return torch.cat([a[order], a.new_zeros(pad)]).reshape(nb, B)

    ex, ey, ei = padded(x), padded(y), padded(idx)
    ew = torch.cat([x.new_ones(n), x.new_zeros(pad)]).reshape(nb, B)
    p = {k: w[k].clone().requires_grad_(True) for k in ref.FIELDS}
    frozen = set(cfg["frozen"])
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    losses = []
    for t in range(1, nb + 1):
        nz = data.train_noise(gen, M, B, D, dtype=F64)
        loss = ref.negative_selbo(p, Z, ex[t - 1], ey[t - 1], ei[t - 1], ew[t - 1], float(n), nz,
                                  cfg["jitter"])
        grads = torch.autograd.grad(loss, [p[k] for k in ref.FIELDS])
        losses.append(loss.item())
        with torch.no_grad():
            for k, g in zip(ref.FIELDS, grads):
                g = torch.where(torch.isfinite(g), g, 0.0) * (0.0 if k in frozen else 1.0)
                m[k] = B1 * m[k] + (1 - B1) * g
                v[k] = B2 * v[k] + (1 - B2) * g * g
                mhat, vhat = m[k] / (1 - B1**t), v[k] / (1 - B2**t)
                p[k] -= cfg["lr"] * mhat / (torch.sqrt(vhat) + EPS)
    return torch.tensor(losses, dtype=F64), {k: t.detach() for k, t in p.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_heterotopic_epoch_matches_the_plain_reference(case):
    cfg = _config(case)
    x, y, idx, Z = data.observations(cfg, "cpu", dtype=F64)
    n, B = x.shape[0], cfg["B"]
    assert idx.bincount().tolist() == CASES[case]["lengths"] and n % B != 0
    w = data.cnmgp_weights(cfg, SEED_W, "cpu", dtype=F64)
    got_losses, got = _port_epoch(cfg, x, y, idx, Z, w)
    want_losses, want = _reference_epoch(cfg, x, y, idx, Z, w)
    assert got_losses.shape == (-(-n // B),)
    torch.testing.assert_close(got_losses, want_losses, rtol=LOSS_RTOL, atol=0.0)
    for k in ref.FIELDS:
        torch.testing.assert_close(got[k], want[k], rtol=0.0, atol=PARAM_ATOL,
                                   msg=lambda s, k=k: f"{k}: {s}")
    # the epoch moved every leaf but the frozen logs
    for k in ref.FIELDS:
        moved = float((want[k] - w[k]).abs().max())
        assert (moved == 0.0) == (k in cfg["frozen"]), (k, moved)


def test_an_epoch_off_the_card_counts_no_graph_kernels():
    """The CPU runs the epoch op by op: no graph is captured, so neither the
    counter `dsvi.step_graph_kernels` nor `dsvi.captures` moves."""
    cfg = _config("d2")
    x, y, idx, Z = data.observations(cfg, "cpu", dtype=F64)
    names = ("dsvi.step_graph_kernels", "dsvi.captures")
    before = [profiling.counters().get(k) for k in names]
    _port_epoch(cfg, x, y, idx, Z, data.cnmgp_weights(cfg, SEED_W, "cpu", dtype=F64))
    assert [profiling.counters().get(k) for k in names] == before
