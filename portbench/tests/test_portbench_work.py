"""The frozen work counts against `utils/profiling.flops_of` over the port's
plain versions at small widths.

`flops_of` counts the dense products of the plain versions (a quadform's
triangle as a full square); the counts here take the triangle once, so a
kernel's ratio is fixed by M alone.  The step's ratio (the kernels' work
against every matmul-like operator of a plain step) is printed; at the
ECoG width PR 14 measured 182.17 GFLOP a step by `flops_of`.
"""

from __future__ import annotations

import pytest
import torch

from portbench import work

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (  # noqa: E402
    cnmgp as tc,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (  # noqa: E402
    cuda_kernels as ck,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.profiling import (  # noqa: E402
    flops_of,
)


@pytest.mark.parametrize("S,G,M,N", [(1, 6, 8, 20), (2, 3, 12, 9)])
def test_quadform_counts(S, G, M, N):
    A, W = torch.randn(S, M, N), torch.randn(S, G, M, M).tril()
    vbar = torch.randn(G, N)
    ops, nbytes = work.quadform(S, G, M, N)
    # the plain einsum's full square: 2 M^2 a (s, g, n) against M^2 + 3 M
    assert ops * 2 * M == flops_of(ck.quadform_diag_plain, A, W) * (M + 3)
    for count, plain in ((work.quadform_dw, ck.quadform_diag_dw_plain),
                         (work.quadform_da, ck.quadform_diag_da_plain)):
        # two dense products of 2 M^2 a (g, n) against 2 M (M + 1)
        assert count(G, M, N)[0] * 2 * M == flops_of(plain, A[0], W[0], vbar) * (M + 1)
    assert nbytes == 4 * (S * M * N + S * G * M * (M + 1) // 2 + S * G * N)


def test_step_count_against_flops_of():
    D, M, B = 4, 10, 30
    g = torch.Generator().manual_seed(0)
    params = tc.CNMGPParams(*(t.requires_grad_(True) for t in tc.init_params(
        g, D, M, dtype=torch.float64, device="cpu")))
    Z = torch.linspace(0, 10, M, dtype=torch.float64)
    x = torch.rand(B, generator=g, dtype=torch.float64) * 10
    y = torch.randn(B, generator=g, dtype=torch.float64)
    idx = torch.randint(0, D, (B,), generator=g)
    nz = tc.draw_train_noise(g, 1, M, B, D, dtype=torch.float64)

    def step():
        tc.negative_selbo(params, Z, x, y, idx, torch.ones_like(y), 100.0, nz, 1e-4).backward()

    counted = flops_of(step)
    ops, least = work.total(work.dsvi_step(D, M, B))
    ratio = ops / counted
    print(f"D={D} M={M} B={B}: counted kernel work {ops:.0f}, flops_of {counted:.0f}, "
          f"ratio {ratio:.4f}")
    assert 0.2 < ratio < 1.0 and least > 0
    ecog = work.total(work.dsvi_step(78, 100, 512))[0]
    assert abs(ecog / 182.173e9 - 0.45016) < 1e-4


def test_least_time_takes_the_larger_bound():
    assert work.least_s((495e12, 0)) == pytest.approx(1.0)
    assert work.least_s((0, 3.35e12)) == pytest.approx(1.0)
    assert work.least_s((495e12, 6.7e12)) == pytest.approx(2.0)
