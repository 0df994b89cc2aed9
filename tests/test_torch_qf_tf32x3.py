"""The arithmetic of the tensor-core quadform backward kernels, emulated on
the CPU.

`csrc/quadform_diag_dw.cu` and `csrc/quadform_diag_da.cu` take both of
their products on the tensor cores by split operands (`csrc/qf_mma.cuh`):
each float32 operand x is cut into P TF32 pieces, x0 = tf32(x), x1 =
tf32(x - x0), ..., rounded as `cvt.rna.tf32.f32` rounds (to 10 explicit
mantissa bits, ties away from zero), and a product is the sum of the piece
products a_i b_j with i + j < P, the smallest first.  P = 2 is "3xTF32".  A
TF32 product is exact in float32, so float32 einsums over the pieces give
the kernels' arithmetic up to the order of their float32 sums.

Held here on the path's kind of inputs, whitened grams of lengthscale 40
at ECoG-like width (as `chip_smoke.ecog_gradients` sets them), against the
gate `chip_smoke.py` holds the kernels to (at most 3x the plain float32
einsum's error against float64, plus its floor):
  - the kernels' split (three pieces for C = A^T W, whose sums cancel, 3xTF32
    for the product after it) passes;
  - 3xTF32 for C as well does not (W's entries are ~100x C's, and x0 + x1
    holds x only to ~2^-23), which is why the kernels take three pieces;
  - one TF32 product alone does not, which shows that the gate can fail.
"""

import numpy as np
import pytest
import torch

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
    cuda_kernels as ck,
)

torch.set_num_threads(2)

# chip_smoke.backward_kernels' floor, of max |float64 result|
FLOOR = 1e-6


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, ties away from zero, by integer
    ops on the bits (`cvt.rna.tf32.f32`: the low 13 mantissa bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pieces(x, p):
    """x as p TF32 pieces, largest first; each difference is exact."""
    out = []
    for _ in range(p):
        out.append(tf32(x))
        x = x - out[-1]
    return out


def product(spec, a, b, p):
    """einsum(spec, a, b) in float32 as the tensor cores take it from p
    pieces an operand: the piece products a_i b_j, i + j < p, smallest
    first."""
    pa, pb = pieces(a, p), pieces(b, p)
    out = None
    for s in range(p - 1, -1, -1):
        for i in range(s, -1, -1):
            term = torch.einsum(spec, pa[i], pb[s - i])
            out = term if out is None else out + term
    return out


def emulated(A, W, vbar, p_c, p_d):
    """(dW, dA) of the kernels' arithmetic: C = A^T W_g from p_c pieces, E =
    2 vbar C, then dW = tril(A E_g) and dA = sum_g W_g E_g^T from p_d."""
    C = product("mn,gmk->gnk", A, W, p_c)
    E = 2.0 * vbar[..., None] * C
    return product("mn,gnk->gmk", A, E, p_d).tril(), product("gmk,gnk->mn", W, E, p_d)


def path_inputs(M, N, G, seed):
    """A = Lp^-1 K_zx and W_g = Lp^-1 tril(S_g) of the RBF prior of
    lengthscale 40 on Z = linspace(0, 800, M) (+ 1e-4 jitter), inputs on
    the ECoG time axis, and a random cotangent vbar; float32."""
    r = np.random.default_rng(seed)
    Z = np.linspace(0.0, 800.0, M)
    x = np.sort(r.uniform(0.0, 800.0, N))
    k = lambda a, b: np.exp(-0.5 * ((a[:, None] - b[None, :]) / 40.0) ** 2)  # noqa: E731
    Lp = np.linalg.cholesky(k(Z, Z) + 1e-4 * np.eye(M))
    Lp_inv = np.linalg.solve(Lp, np.eye(M))
    S = np.tril(0.1 * r.standard_normal((G, M, M))) + np.eye(M)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    return f32(Lp_inv @ k(Z, x)), f32(np.tril(Lp_inv @ S)), f32(r.standard_normal((G, N)))


def rel_err(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("M", [100, 200])
def test_the_kernels_split_passes_the_float64_gate_and_3xtf32_does_not(M):
    A, W, vbar = path_inputs(M, 512, 16, seed=M)
    refs = {
        "dW": ck.quadform_diag_dw_plain(A.double(), W.double(), vbar.double()),
        "dA": ck.quadform_diag_da_plain(A.double(), W.double(), vbar.double()),
    }
    plain = {"dW": ck.quadform_diag_dw_plain(A, W, vbar), "dA": ck.quadform_diag_da_plain(A, W, vbar)}
    splits = {(p_c, p_d): dict(zip(("dW", "dA"), emulated(A, W, vbar, p_c, p_d)))
              for p_c, p_d in ((3, 2), (2, 2), (1, 1))}
    for name, ref in refs.items():
        tol = 3 * rel_err(plain[name], ref) + FLOOR
        errs = {key: rel_err(got[name], ref) for key, got in splits.items()}
        assert errs[3, 2] <= tol, (name, errs, tol)  # the kernels' split
        assert errs[2, 2] > tol, (name, errs, tol)  # 3xTF32 throughout
        assert errs[1, 1] > tol, (name, errs, tol)  # one TF32 product


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0**-10  # TF32's spacing at 1
    x = torch.tensor([one, one + 0.49 * ulp, one + 0.5 * ulp, one + 0.51 * ulp,
                      -(one + 0.5 * ulp), 3.0e-3, -7.25e5], dtype=torch.float32)
    want = [one, one, one + ulp, one + ulp, -(one + ulp)]
    assert tf32(x)[:5].tolist() == want
    p2, p3 = pieces(x, 2), pieces(x, 3)
    assert all(torch.equal(p, tf32(p)) for p in p2 + p3)
    # two pieces hold x to about 2^-23 of |x|, three exactly
    rel = lambda ps: (sum(p.double() for p in ps) - x.double()).abs() / x.double().abs()  # noqa: E731
    assert float(rel(p2).max()) <= 2.0**-22 and float(rel(p3).max()) == 0.0
