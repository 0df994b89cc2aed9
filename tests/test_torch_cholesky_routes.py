"""The batched Cholesky at batch 1 and 4 on the CPU: the port's
differentiable `ops.linalg.cholesky` (through the kernel's plain version)
against `jnp.linalg.cholesky`, a member that is not positive-definite
included (NaN in its lower triangle, zero above, the others unchanged), in
float64 (rtol 1e-10).  And the choice between the two routes of
`csrc/cholesky.cu` (one block per matrix below the measured crossover,
many CTAs per matrix from it on), which the wrapper makes on the host.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import linalg as tl
from torch_port_helpers import assert_close

torch.set_num_threads(1)


def _spd(r, batch, m):
    A = r.standard_normal((batch, m, m))
    return np.einsum("bij,bkj->bik", A, A) / m + 0.1 * np.eye(m)


@pytest.mark.parametrize("batch, m", [(1, 1), (1, 45), (4, 33), (4, 130)])
def test_cholesky_matches_jnp_with_a_non_pd_member(batch, m):
    r = np.random.default_rng(batch * m)
    K = _spd(r, batch, m)
    K[-1, m // 2, m // 2] = -1.0  # the last member is not PD
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(K)))
    got = tl.cholesky(torch.as_tensor(K))
    lower = np.tril(np.ones((m, m), dtype=bool))
    assert np.isnan(want[-1][lower]).all()
    assert torch.isnan(got[-1][torch.as_tensor(lower)]).all()
    assert (got[-1][~torch.as_tensor(lower)] == 0).all()
    assert_close(got[:-1], want[:-1], rtol=1e-10, atol=1e-13)


def test_cholesky_matches_jnp_on_a_pd_batch_with_gradient():
    r = np.random.default_rng(5)
    K = _spd(r, 4, 20)
    Kt = torch.tensor(K, requires_grad=True)
    L = tl.cholesky(Kt)
    assert_close(L, jnp.linalg.cholesky(jnp.asarray(K)), rtol=1e-10, atol=1e-13)
    assert torch.isfinite(torch.autograd.grad(L.sum(), Kt)[0]).all()


def test_cholesky_route_follows_the_measured_crossover():
    x = ck.CHOLESKY_CROSSOVER_M
    assert set(ck.CHOLESKY_ROUTES) == {"one_block", "multi_cta"}
    assert ck.cholesky_route(x - 1) == "one_block" and ck.cholesky_route(x) == "multi_cta"
    assert ck.cholesky_route(1) == "one_block" and ck.cholesky_route(4096) == "multi_cta"
    assert ck.cholesky_route(4096, "one_block") == "one_block"
    with pytest.raises(ValueError):
        ck.cholesky_route(100, "cooperative")


def test_cholesky_wrapper_takes_the_plain_version_on_cpu():
    K = torch.as_tensor(_spd(np.random.default_rng(1), 2, 9))
    before = dict(ck.LAUNCHES)
    for cpu in (K, K.float()):
        assert ck.pick("cholesky", cpu) is ck.cholesky_plain
        assert torch.equal(ck.pick("cholesky", cpu)(cpu), ck.cholesky_plain(cpu))
        with pytest.raises(TypeError, match="CUDA float32"):
            ck.cholesky_cuda(cpu, "multi_cta")
    assert ck.LAUNCHES == before
