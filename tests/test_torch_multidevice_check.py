"""The body of the multi-rank checks (`drivers/multidevice_check.py`) at a
tiny width, two ranks of a gloo group on the CPU, and the pieces it shares
with the one-process gates: the ECoG gradient problem and
`ops.cuda_kernels.plain_versions`."""

import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
    multidevice_check as mdc,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.launch import (
    spawn,
)

TARGET = ("collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers."
          "multidevice_check:card_ranks")
TINY = dict(device="cpu", D=5, M=16, B=64, dp_steps=2, svc_n=16, chees_warmup=8,
            chees_samples=4, particles=64, smc_n=8, mutations=1, nuts_warmup=3, nuts_samples=2)


@pytest.fixture(scope="module")
def ranks():
    return spawn(TARGET, 2, TINY, timeout=240)


def test_data_parallel_gradient_within_the_float64_gate(ranks):
    """The two ranks' summed gradient against the one-process float64
    gradient: at most 3x the worst plain float32 error of the three row
    orders + 1e-5 of max, the gate that chip_smoke.py holds at ECoG width."""
    errors = ranks[0]["dp"]["grad_errors"]
    assert set(errors) == set(mdc.cnmgp.CNMGPParams._fields)
    for name, e in errors.items():
        assert e["dp_kernels"] <= 3 * max(e["plain"]) + 1e-5, name
    assert "grad_errors" not in ranks[1]["dp"]


def test_ranks_agree_after_the_steps(ranks):
    r0, r1 = (r["dp"] for r in ranks)
    assert r0["loss"] == r1["loss"] and r0["params_checksum"] == r1["params_checksum"]
    assert abs(r0["loss"] - r0["loss64"]) <= 1e-5 * abs(r0["loss64"])


def test_sharded_samplers_adapt_alike_and_stay_finite(ranks):
    c0, c1 = ranks[0]["chees"], ranks[1]["chees"]
    assert c0["finite"] and c1["finite"] and c0["shape"] == [4, 4, 65]
    assert (c0["step_size"], c0["trajectory_length"]) == (c1["step_size"],
                                                          c1["trajectory_length"])
    for name, m in ranks[0]["smc"]["models"].items():
        assert m["last_beta"] == 1.0 and m == {**ranks[1]["smc"]["models"][name],
                                               "s": m["s"]}, name
        assert torch.isfinite(torch.tensor(m["log_z"]))
    assert ranks[0]["nuts"]["finite"] and ranks[1]["nuts"]["finite"]


def test_ecog_problem_orders_are_one_sum():
    """The three row orders of the gradient problem sum the same terms: in
    float64 their losses and gradients agree to rounding."""
    x, y, idx, Z = mdc.ecog_data(torch.device("cpu"), D=3, M=8)
    prob = mdc.ecog_problem(x, y, idx, Z, torch.Generator().manual_seed(3), D=3, B=32)
    assert prob.rows.shape == (32,) and len(prob.orders) == 3
    runs = [prob.grads(torch.float64, o) for o in prob.orders]
    for loss, grads in runs[1:]:
        assert loss == pytest.approx(runs[0][0], rel=1e-12)
        for g, g0 in zip(grads, runs[0][1]):
            torch.testing.assert_close(g, g0, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("names", [ck.KERNELS, ("chol_inv",), ()])
def test_plain_versions_routes_and_restores(names):
    kernels = {n: getattr(ck, f"{n}_cuda") for n in ck.KERNELS}
    with pytest.raises(RuntimeError, match="inside"):
        with ck.plain_versions(names):
            for n in ck.KERNELS:
                want = getattr(ck, f"{n}_plain") if n in names else kernels[n]
                assert getattr(ck, f"{n}_cuda") is want
            raise RuntimeError("inside")
    assert all(getattr(ck, f"{n}_cuda") is kernels[n] for n in ck.KERNELS)
