"""Hand-written CUDA kernels of the port, with their plain versions.

The counterpart of the JAX package's `ops/pallas_kernels.py`.  Every TPU
kernel there has one here (the Gibbs and RBF grams, the Kronecker matvec,
the batched Cholesky, the fused Cholesky + triangular inverse, the
variance quadratic form and its two backward kernels, and the fused
backward that computes both of its gradients from one C), and two kernels
of its own (the whitened coefficient factors and their backward, a chain
the JAX package leaves to XLA's fusion), and each has:

  - a wrapper (`gibbs_cuda`, `rbf_cuda`, `kron_mv_cuda`, `cholesky_cuda`,
    `chol_inv_cuda`, `quadform_diag_cuda`, `quadform_diag_dw_cuda`,
    `quadform_diag_da_cuda`, `quadform_diag_bwd_cuda`,
    `whitened_factors_cuda`, `whitened_factors_bwd_cuda`) that launches the
    kernel for CUDA float32 tensors, or raises, and counts the launch in
    `LAUNCHES`, each call the span `kernel.<name>` (`utils.profiling.span`:
    its checks, allocations and the ctypes call).  A launch recorded into a
    CUDA graph being captured is not one: it is tallied apart
    (`take_captured`), and each replay of the graph adds the tally to
    `LAUNCHES` and `REPLAYED` (`count_replay`);
  - a plain PyTorch version (`gibbs_plain`, `rbf_plain`, `kron_mv_plain`,
    `cholesky_plain`, `chol_inv_plain`, `quadform_diag_plain`,
    `quadform_diag_dw_plain`, `quadform_diag_da_plain`,
    `quadform_diag_bwd_plain`, `whitened_factors_plain`,
    `whitened_factors_bwd_plain`) with the same math (the last two the
    composition of ops the model runs off the card, with the KL pieces, and
    its vector-Jacobian product by autograd).  The CPU tests run it, and
    `chip_smoke.py` holds each kernel against it on the card.

This module alone decides which of the two an op of `ops/` runs:
`use_kernel(name, ...)`, through `pick`, gives the kernel for CUDA float32
operands within the op's limit in `_LIMITS` (Gibbs points of dimension <=
4, 1-D RBF inputs, the whitened factors' M), the plain version otherwise,
as the JAX package takes Pallas only for float32.  The quadform backward
is one op to its callers: `pick` gives the fused kernel or the pair of
backward kernels by `quadform_bwd_route`.

Sources live in `../csrc/*.cu` (with the shared headers `chol_blocked.cuh`,
`chol_multi_cta.cuh`, `qf_mma.cuh` and `whitened.cuh`).
Each is compiled on first use with `nvcc` for `sm_90a` into `build/` at the
repository root (one shared library per source, named by a hash of the
sources and flags) and bound with `ctypes`; every C entry returns
`cudaGetLastError()`.  Nothing is compiled or loaded at import time.  A
build is the span `kernel.build` and adds to the counters `kernel.builds`
(sources compiled) and `kernel.build_s`; a load is the span `kernel.load`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable

import torch

from ..utils import profiling
from . import kernels as _kernels  # sq_dist and the point layout, for the Gibbs gram

__all__ = [
    "KERNELS",
    "LAUNCHES",
    "GIBBS_MAX_DIM",
    "use_kernel",
    "pick",
    "REPLAYED",
    "reset_launches",
    "take_captured",
    "count_replay",
    "plain_versions",
    "build",
    "gibbs_cuda",
    "gibbs_plain",
    "rbf_cuda",
    "rbf_plain",
    "kron_mv_cuda",
    "kron_mv_plain",
    "cholesky_cuda",
    "cholesky_plain",
    "cholesky_route",
    "CHOLESKY_ROUTES",
    "CHOLESKY_CROSSOVER_M",
    "chol_inv_cuda",
    "chol_inv_route",
    "CHOL_INV_ROUTES",
    "CHOL_INV_CROSSOVER_M",
    "chol_inv_plain",
    "cholesky_nan",
    "quadform_diag_cuda",
    "quadform_diag_plain",
    "quadform_diag_dw_cuda",
    "quadform_diag_dw_plain",
    "quadform_diag_da_cuda",
    "quadform_diag_da_plain",
    "quadform_diag_bwd_cuda",
    "quadform_diag_bwd_plain",
    "quadform_bwd_route",
    "QF_BWD_FUSED_MAX_M",
    "QF_BWD_FUSED_MAX_N",
    "QF_BWD_FUSED_MAX_G_WIDE",
    "whitened_factors_cuda",
    "whitened_factors_plain",
    "whitened_factors_bwd_cuda",
    "whitened_factors_bwd_plain",
    "max_m",
]

KERNELS = (
    "gibbs", "rbf", "kron_mv", "cholesky", "chol_inv", "quadform_diag",
    "quadform_diag_dw", "quadform_diag_da", "quadform_diag_bwd", "whitened_factors",
    "whitened_factors_bwd",
)

# The routes of `csrc/cholesky.cu` (its `route` argument): one block per
# matrix, or each matrix spread over many CTAs.
CHOLESKY_ROUTES = {"one_block": 0, "multi_cta": 1}
# Smallest M that takes the multi-CTA route by default: on the H100 at batch
# 2 the two routes tie at M = 100 and the multi-CTA one is faster from
# M = 128 on (chip_smoke.py's crossover table; PERF.md).
CHOLESKY_CROSSOVER_M = 128

# The routes of `csrc/chol_inv.cu` (its `route` argument): the whole matrix
# resident in one CTA's shared memory (M up to ~240 on the H100), or each
# matrix spread over many CTAs.
CHOL_INV_ROUTES = {"resident": 0, "multi_cta": 1}
# Smallest M that takes the multi-CTA route by default: on the H100 at batch
# 4 the resident route is faster through M = 224 and the multi-CTA one at
# M = 240, its limit (chip_smoke.py's crossover table; PERF.md).
CHOL_INV_CROSSOVER_M = 240

# The quadform backward's route (`quadform_bwd_route`): on the H100 the fused
# kernel beat 6b + 6c at M = 64 and 100 for every G up to 3003 where N <= 512
# (one cluster of its 64-column blocks holds N), and at N = 1000 and 2000 for
# G <= 15, and lost at G = 105 and beyond there, and at M = 120 and 200
# (PERF.md, the fused kernel's row).
QF_BWD_FUSED_MAX_M = 112
QF_BWD_FUSED_MAX_N = 512
QF_BWD_FUSED_MAX_G_WIDE = 15

# The largest input dimension the Gibbs kernel takes (the JAX function takes any).
GIBBS_MAX_DIM = 4

# Launches of each kernel since the last `reset_launches()`, those of CUDA
# graph replays included; `REPLAYED` holds those alone.
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
REPLAYED: Dict[str, int] = {name: 0 for name in KERNELS}
# Launches recorded into CUDA graphs under capture since `take_captured()`.
_CAPTURED: Dict[str, int] = {name: 0 for name in KERNELS}

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_ARGTYPES = {
    # x1, x2, l1, l2, scale2, out, s, n, m, d, stream
    "gibbs": [_P, _P, _P, _P, _F, _P, _I, _I, _I, _I, _P],
    # x1, x2, scale2, ls, out, s, n, m, stream
    "rbf": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # K, B, y, out, c, n1, n2, m1, m2, K's strides (chain, row, column), B's
    # and y's chain strides, stream
    "kron_mv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _P],
    # a, l_out, flags, diag, batch, m, route, stream
    "cholesky": [_P, _P, _P, _P, _I, _I, _I, _P],
    # a, l_out, linv_out, lw, xw, flags, diag, dinv, batch, m, route, stream
    "chol_inv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # A, W, V, s, g, m, n, stream
    "quadform_diag": [_P, _P, _P, _I, _I, _I, _I, _P],
    # A, W, vbar, dW, s, g, m, n, stream
    "quadform_diag_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # A, W, vbar, partial, dA, s, g, m, n, chunks, stream
    "quadform_diag_da": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # A, W, vbar, dA_part, dW_part, dA, dW, s, g, m, n, stream
    "quadform_diag_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # X, P0, P1, W0, W1, tr0, tr1, ld0, ld1, s, g, g0, m, jitter, stream
    "whitened_factors": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # X, P0, P1, dW0, dW1, W0, W1, dtr0, dtr1, dld0, dld1, part, dX, dP0, dP1, s, g, g0,
    # m, jitter, stream
    "whitened_factors_bwd": [_P] * 15 + [_I, _I, _I, _I, _F, _P],
}
_LIBS: Dict[str, ctypes.CDLL] = {}
_MAX_M: Dict[tuple, int] = {}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        REPLAYED[name] = 0


def take_captured() -> Dict[str, int]:
    """The launches recorded into CUDA graphs under capture since the last
    call (the kernels a replay of the graph captured meanwhile launches),
    and start the tally again."""
    taken = dict(_CAPTURED)
    for name in KERNELS:
        _CAPTURED[name] = 0
    return taken


def count_replay(recorded: Dict[str, int]) -> None:
    """Count one replay of a CUDA graph that recorded `recorded` launches
    (`take_captured` after its capture): a replay launches each again."""
    for name, n in recorded.items():
        LAUNCHES[name] += n
        REPLAYED[name] += n


@contextmanager
def plain_versions(names: Iterable[str] = KERNELS):
    """Route the named kernel wrappers (default every one) to their plain
    PyTorch versions while the context is open: the computation that a
    kernel is held against, on the same inputs."""
    module = sys.modules[__name__]
    saved = {name: getattr(module, f"{name}_cuda") for name in names}
    try:
        for name in saved:
            setattr(module, f"{name}_cuda", getattr(module, f"{name}_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, f"{name}_cuda", fn)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return path


def _library_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    return _BUILD / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, one `nvcc` process
    per source, all started together.  Returns each new build's compiler
    output (with `-Xptxas=-v`: registers, shared memory, spills).  Raises
    with the compiler's output if any build fails."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    todo = [name for name in names if not _library_path(name).exists()]
    if not todo:
        return {}
    t0 = time.perf_counter()
    logs, failures = {}, []
    with profiling.span("kernel.build", kernels=len(todo)):
        running = {}
        for name in todo:
            out = _library_path(name)
            tmp = out.with_name(out.name + ".tmp")
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            running[name] = (proc, tmp, out)
        for name, (proc, tmp, out) in running.items():
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            else:
                tmp.replace(out)
    profiling.count("kernel.builds", len(todo))
    profiling.count("kernel.build_s", time.perf_counter() - t0)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return logs


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        with profiling.span("kernel.load", kernel=name):
            lib = ctypes.CDLL(str(_library_path(name)))
        launch = getattr(lib, f"{name}_launch")  # attribute access caches the function
        launch.argtypes = _ARGTYPES[name]
        launch.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def max_m(name: str, device=None, route=None) -> int:
    """Largest M that kernel `name` (any of `KERNELS` but "gibbs" and
    "rbf") takes on `device`: the layout of its shared memory
    (`smem_bytes` in its source) meets the card's opt-in limit; for
    "kron_mv", the largest task dimension it keeps in registers; for
    "cholesky" and "chol_inv", their multi-CTA route's limit, or with
    `route` that route's (cholesky's "one_block" takes M up to ~3400,
    chol_inv's "resident" 240).  Queried once per device."""
    device = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if device.index is None else device.index
    query = f"{name}_max_m" if route in (None, "multi_cta") else f"{name}_{route}_max_m"
    key = (query, index)
    if key not in _MAX_M:
        with torch.cuda.device(index):
            m = getattr(_library(name), query)()
        if m < 0:
            raise RuntimeError(f"{name}: could not query device {index}'s shared memory")
        _MAX_M[key] = m
    return _MAX_M[key]


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_library(name), f"{name}_launch")(*args, stream)
        captured = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    if captured:
        _CAPTURED[name] += 1  # recorded into a graph: launched at each replay
    else:
        LAUNCHES[name] += 1


def _spanned(wrapper):
    """`wrapper` (`<name>_cuda`) with each call the span `kernel.<name>`."""
    name = "kernel." + wrapper.__name__[: -len("_cuda")]

    @functools.wraps(wrapper)
    def spanned(*args, **kwargs):
        if not profiling.recording():  # the launch path's one check while off
            return wrapper(*args, **kwargs)
        with profiling.span(name):
            return wrapper(*args, **kwargs)

    return spanned


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


# The ops whose kernels take only some of the shapes their plain versions
# take, and what those are; the other kernels raise above their `max_m`.
_LIMITS = {
    "gibbs": lambda x1, *_: _kernels._as_points(x1).shape[-1] <= GIBBS_MAX_DIM,
    "rbf": lambda x1, x2, *_: x1.ndim == 1 and x2.ndim == 1,
    "whitened_factors": lambda X, *_: X.shape[-1] <= min(
        max_m("whitened_factors", X.device), max_m("whitened_factors_bwd", X.device)),
}


def use_kernel(name: str, *operands) -> bool:
    """The one dispatch rule of the port's ops, the JAX package's own (Pallas
    only for float32: `_use_pallas`, ops/kernels.py:78-92, and the
    quadform's test, ops/linalg.py:407-415): op `name` runs its kernel when
    every tensor among `operands` lies on a CUDA card in float32 and the
    op's limit in `_LIMITS`, if any, holds; else its plain version.  The
    device and dtype are judged first: off the card no library is built to
    read a limit.  Decided before the call: no kernel failure is caught."""
    on_card = all(_device_type(t) == "cuda" and t.dtype == torch.float32
                  for t in operands if isinstance(t, torch.Tensor))
    return on_card and (name not in _LIMITS or _LIMITS[name](*operands))


def pick(name: str, *operands):
    """What op `name` runs on `operands`: `{name}_cuda` where
    `use_kernel(name, *operands)` holds, else `{name}_plain`.  For
    "quadform_diag_bwd" the kernel route is the fused kernel or, where
    `quadform_bwd_route` says "pair", the two backward kernels."""
    if not use_kernel(name, *operands):
        return globals()[f"{name}_plain"]
    if name == "quadform_diag_bwd" and quadform_bwd_route(*operands[:2]) == "pair":
        return _quadform_diag_bwd_pair
    return globals()[f"{name}_cuda"]


def _check_cuda_f32(name: str, *tensors: torch.Tensor) -> torch.device:
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: all inputs must be on {device}, got {t.device}")
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes CUDA float32 tensors, got "
                            f"{t.device.type} {t.dtype}")
    return device


# ---------------------------------------------------------------------------
# Gibbs gram
# ---------------------------------------------------------------------------


def gibbs_plain(x1, x2, ell1, ell2, scale2=1.0):
    """Gibbs gram in plain PyTorch, the formula of the JAX `ops.kernels.gibbs`.

    x1 (N,) or (N, d); x2 (M,) or (M, d); ell1 (N,) or (S, N); ell2 (M,) or
    (S, M).  Returns (N, M), or (S, N, M) when either lengthscale carries
    the draw dimension.
    """
    r2 = _kernels.sq_dist(x1, x2)
    e1 = ell1[..., :, None]
    e2 = ell2[..., None, :]
    denom = e1 * e1 + e2 * e2
    pref = torch.sqrt(2.0 * (e1 * e2) / denom)
    return scale2 * pref * torch.exp(-r2 / denom)


@_spanned
def gibbs_cuda(x1, x2, ell1, ell2, scale2=1.0):
    """Gibbs gram through `csrc/gibbs.cu` for CUDA float32 tensors (d <= 4).
    Shapes as `gibbs_plain`."""
    p1, p2 = _kernels._as_points(x1), _kernels._as_points(x2)
    n, d = p1.shape
    m = p2.shape[0]
    if p2.shape[1] != d:
        raise ValueError(f"gibbs: input dims differ, {d} and {p2.shape[1]}")
    if d > GIBBS_MAX_DIM:
        raise ValueError(
            f"gibbs: the CUDA kernel takes inputs of dimension <= {GIBBS_MAX_DIM}, got {d}"
        )
    batched = ell1.ndim == 2 or ell2.ndim == 2
    s = ell1.shape[0] if ell1.ndim == 2 else (ell2.shape[0] if ell2.ndim == 2 else 1)
    l1 = ell1.expand(s, n).contiguous()
    l2 = ell2.expand(s, m).contiguous()
    p1, p2 = p1.contiguous(), p2.contiguous()
    device = _check_cuda_f32("gibbs", p1, p2, l1, l2)
    out = torch.empty((s, n, m), dtype=torch.float32, device=device)
    if out.numel():
        _launch(
            "gibbs", device, p1.data_ptr(), p2.data_ptr(), l1.data_ptr(), l2.data_ptr(),
            float(scale2), out.data_ptr(), s, n, m, d,
        )
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# Stationary RBF gram
# ---------------------------------------------------------------------------


def scaled_sq_dist(x1, x2, length_scale):
    """sq_dist(x1 / l, x2 / l), the distance `rbf` exponentiates.  l a scalar
    (a float or a 0-d tensor) gives (N, M); l of shape (S,) gives (S, N, M),
    one per lengthscale, each the exact `sq_dist` of the scaled inputs."""
    if not (isinstance(length_scale, torch.Tensor) and length_scale.ndim == 1):
        return _kernels.sq_dist(x1 / length_scale, x2 / length_scale)
    p1, p2 = _kernels._as_points(x1), _kernels._as_points(x2)
    if p1.shape[-1] > 4:
        return torch.stack([_kernels.sq_dist(p1 / l, p2 / l) for l in length_scale])
    l = length_scale[:, None, None]
    diff = (p1 / l)[:, :, None, :] - (p2 / l)[:, None, :, :]
    return torch.sum(diff * diff, dim=-1)


def _pair_axis(value):
    """A per-pair (S,) scale as (S, 1, 1), to broadcast over the grams;
    anything else is a scalar and stays."""
    return value[:, None, None] if isinstance(value, torch.Tensor) and value.ndim == 1 else value


def rbf_plain(x1, x2, scale2=1.0, length_scale=1.0):
    """RBF gram scale2 * exp(-0.5 sq_dist(x1 / l, x2 / l)) in plain PyTorch,
    the formula of the JAX `ops.kernels.rbf`.  scale2 and length_scale are
    scalars, or (S,) tensors of (scale, lengthscale) pairs (one broadcast to
    the other): then (S, N, M), one gram per pair."""
    r2 = scaled_sq_dist(x1, x2, length_scale)
    return _pair_axis(scale2) * torch.exp(-0.5 * r2)


@_spanned
def rbf_cuda(x1, x2, scale2=1.0, length_scale=1.0):
    """RBF gram through `csrc/rbf.cu` for 1-D CUDA float32 inputs, all pairs
    in one launch.  Shapes as `rbf_plain`."""
    if x1.ndim != 1 or x2.ndim != 1:
        raise ValueError(
            f"rbf: the CUDA kernel takes 1-D inputs, got {tuple(x1.shape)} and {tuple(x2.shape)}"
        )
    device = x1.device
    sc = torch.as_tensor(scale2, dtype=torch.float32, device=device)
    ls = torch.as_tensor(length_scale, dtype=torch.float32, device=device)
    if sc.ndim > 1 or ls.ndim > 1:
        raise ValueError(f"rbf: scale and lengthscale must be scalars or (S,), got "
                         f"{tuple(sc.shape)} and {tuple(ls.shape)}")
    batched = sc.ndim == 1 or ls.ndim == 1
    s = torch.broadcast_shapes(sc.shape, ls.shape, (1,))[0]
    sc = sc.expand(s).contiguous()
    ls = ls.expand(s).contiguous()
    p1, p2 = x1.contiguous(), x2.contiguous()
    _check_cuda_f32("rbf", p1, p2, sc, ls)
    n, m = p1.shape[0], p2.shape[0]
    out = torch.empty((s, n, m), dtype=torch.float32, device=device)
    if out.numel():
        _launch("rbf", device, p1.data_ptr(), p2.data_ptr(), sc.data_ptr(), ls.data_ptr(),
                out.data_ptr(), s, n, m)
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# Kronecker matvec
# ---------------------------------------------------------------------------


def kron_mv_plain(B, K, y):
    """(B kron K) y = vec((K Y B^T)^T) in plain PyTorch, Y = y reshaped (M2,
    N2) and transposed, as the JAX `ops.kron.kron_mv`.  B (..., M1, M2), K
    (..., N1, N2), y (..., M2 * N2), leading (chain) axes broadcast; returns
    (..., M1 * N1)."""
    m2, n2 = B.shape[-1], K.shape[-1]
    Y = y.reshape(y.shape[:-1] + (m2, n2)).transpose(-1, -2)
    A = K @ Y @ B.transpose(-1, -2)  # (..., N1, M1)
    return A.transpose(-1, -2).reshape(A.shape[:-2] + (-1,))


def _chain_operand(t, c, inner):
    """A small operand (B or y) as a contiguous (1 or c, *inner) tensor and its
    chain stride: 0 when one copy serves every chain (no expanded copy)."""
    shared = t.ndim == len(inner) or t.shape[0] == 1
    base = (t if t.ndim > len(inner) else t[None])[:1 if shared else c].contiguous()
    return base, 0 if shared or c == 1 else base[0].numel()


def _kron_mv_operands(B, K, y):
    """Check the operands of the Kronecker-matvec kernel and lay them out for
    it without copying K.  Returns (K, B, y, args, batched): K as the (C, N1,
    N2) view the kernel reads, B and y as `_chain_operand`s, and args =
    (c, n1, n2, m1, m2, sc, sr, sn, b_sc, y_sc), K's element (c, r, n) lying
    at K[c sc + r sr + n sn] with sn == 1 (rows) or sr == 1 (columns, a
    transposed K).  A K shared by the chains has sc = 0.  A K in neither
    layout is made contiguous (a copy)."""
    if B.ndim not in (2, 3) or K.ndim not in (2, 3) or y.ndim not in (1, 2):
        raise ValueError(f"kron_mv: expected B (C, M1, M2), K (C, N1, N2), y (C, M2 N2) or "
                         f"no C; got {tuple(B.shape)}, {tuple(K.shape)}, {tuple(y.shape)}")
    (m1, m2), (n1, n2) = B.shape[-2:], K.shape[-2:]
    if y.shape[-1] != m2 * n2:
        raise ValueError(f"kron_mv: y has {y.shape[-1]} entries, expected {m2} x {n2}")
    lead = [t.shape[0] for t, d in ((B, 3), (K, 3), (y, 2)) if t.ndim == d]
    c = torch.broadcast_shapes(*((n,) for n in lead))[0] if lead else 1
    Kc = (K if K.ndim == 3 else K[None]).expand(c, n1, n2)
    # the stride of a dimension of size 1 is never used: set it so that the
    # layout test sees the other one
    sc, sr, sn = Kc.stride()
    sc = 0 if c == 1 else sc
    sn = 1 if n2 == 1 else sn
    sr = 1 if n1 == 1 and sn != 1 else sr
    if sn != 1 and sr != 1:
        Kc = Kc.contiguous()
        sc, sr, sn = (0 if c == 1 else n1 * n2), n2, 1
    Bc, b_sc = _chain_operand(B, c, (m1, m2))
    yc, y_sc = _chain_operand(y, c, (m2 * n2,))
    return Kc, Bc, yc, (c, n1, n2, m1, m2, sc, sr, sn, b_sc, y_sc), bool(lead)


@_spanned
def kron_mv_cuda(B, K, y):
    """`kron_mv_plain` through `csrc/kron_mv.cu` for CUDA float32 tensors
    with M1, M2 <= max_m("kron_mv") (16) and at most one leading chain axis
    (broadcast across the three operands), one pass over K, read in place:
    as stored or transposed, and once for all chains when it has no chain
    axis (`_kron_mv_operands`)."""
    Kc, Bc, yc, args, batched = _kron_mv_operands(B, K, y)
    c, n1, n2, m1, m2 = args[:5]
    device = _check_cuda_f32("kron_mv", Kc, Bc, yc)
    if max(m1, m2) > max_m("kron_mv", device) or c > 65535:
        raise ValueError(f"kron_mv: task dims ({m1}, {m2}) above {max_m('kron_mv', device)} "
                         f"or {c} chains")
    out = torch.empty((c, m1 * n1), dtype=torch.float32, device=device)
    if out.numel():
        _launch("kron_mv", device, Kc.data_ptr(), Bc.data_ptr(), yc.data_ptr(), out.data_ptr(),
                *args)
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# Batched Cholesky
# ---------------------------------------------------------------------------


def _square_batch(name, K):
    m = K.shape[-1]
    if K.ndim < 2 or K.shape[-2] != m:
        raise ValueError(f"{name}: expected (..., M, M), got {tuple(K.shape)}")
    Kb = K.reshape(-1, m, m).contiguous()
    return Kb, m, _check_cuda_f32(name, Kb)


def cholesky_plain(K):
    """Lower Cholesky factor of K (..., M, M), NaN in the lower triangle of a
    member whose factorization fails (`cholesky_nan`)."""
    return cholesky_nan(K)[0]


def cholesky_route(m: int, route=None) -> str:
    """The route of `csrc/cholesky.cu` for matrices of size m: `route` if
    given, else "one_block" below CHOLESKY_CROSSOVER_M and "multi_cta" from
    it on."""
    if route is None:
        route = "multi_cta" if m >= CHOLESKY_CROSSOVER_M else "one_block"
    if route not in CHOLESKY_ROUTES:
        raise ValueError(f"cholesky: route {route!r} is not one of {tuple(CHOLESKY_ROUTES)}")
    return route


@_spanned
def cholesky_cuda(K, route=None):
    """Lower Cholesky factor through `csrc/cholesky.cu` for a CUDA float32
    K (..., M, M), M <= max_m("cholesky"), with `cholesky_plain`'s failure
    semantics, on the route `cholesky_route(M, route)` picks (the one-block
    route takes M <= ~3400)."""
    Kb, m, device = _square_batch("cholesky", K)
    route = cholesky_route(m, route)
    limit = max_m("cholesky", device, route)
    if m > limit or (route != "one_block" and Kb.shape[0] > 65535):
        raise ValueError(f"cholesky: M={m} above the {route} route's {limit}, or "
                         f"{Kb.shape[0]} matrices")
    L = torch.empty_like(Kb)
    if Kb.numel():
        flags = torch.zeros(Kb.shape[0], dtype=torch.int32, device=device)
        diag = torch.empty((Kb.shape[0], -(-m // 32), 32, 32), dtype=torch.float32, device=device)
        _launch("cholesky", device, Kb.data_ptr(), L.data_ptr(), flags.data_ptr(),
                diag.data_ptr(), Kb.shape[0], m, CHOLESKY_ROUTES[route])
    return L.reshape(K.shape)


# ---------------------------------------------------------------------------
# Fused Cholesky + triangular inverse
# ---------------------------------------------------------------------------


def cholesky_nan(K):
    """Lower Cholesky factor with `jnp.linalg.cholesky`'s failure semantics:
    a matrix that is not numerically positive-definite gets NaN in its
    lower triangle (zero above) instead of an error.  Returns (L, failed)
    with `failed` of shape (..., 1, 1)."""
    L, info = torch.linalg.cholesky_ex(K)
    failed = (info != 0)[..., None, None]
    nan_lower = torch.full_like(L, float("nan")).tril()
    return torch.where(failed, nan_lower, L), failed


def chol_inv_plain(K, route=None):
    """(L, L^-1) of SPD K (..., M, M) in plain PyTorch.  A member whose
    factorization fails gets NaN in L's lower triangle and in all of L^-1,
    as the JAX `chol_tri_inv` gives.

    A float32 member whose float32 factorization fails is factored again in
    float64 arithmetic, its L rounded to float32 (the kernel's resident
    route does the same, so this holds where `chol_inv_route(M, route)` is
    "resident"): near-singular prior grams whose float32 rounding is still
    positive-definite keep a finite factor.  L^-1 is solved in K's dtype
    from the factor either way.  Both factorizations always run, so the
    call waits on no host read and can be captured in a CUDA graph."""
    L, failed = cholesky_nan(K)
    if K.dtype == torch.float32 and chol_inv_route(K.shape[-1], route) == "resident":
        L64, failed64 = cholesky_nan(K.double())
        L = torch.where(failed, L64.to(K.dtype), L)
        failed = failed & failed64
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    safe = torch.where(failed, eye, L)
    Linv = torch.linalg.solve_triangular(safe, eye.expand_as(K), upper=False)
    return L, torch.where(failed, torch.full_like(Linv, float("nan")), Linv)


def chol_inv_route(m: int, route=None) -> str:
    """The route of `csrc/chol_inv.cu` for matrices of size m: `route` if
    given, else "resident" below CHOL_INV_CROSSOVER_M and "multi_cta" from
    it on."""
    if route is None:
        route = "multi_cta" if m >= CHOL_INV_CROSSOVER_M else "resident"
    if route not in CHOL_INV_ROUTES:
        raise ValueError(f"chol_inv: route {route!r} is not one of {tuple(CHOL_INV_ROUTES)}")
    return route


@_spanned
def chol_inv_cuda(K, route=None):
    """(L, L^-1) through `csrc/chol_inv.cu` for a CUDA float32 K (..., M,
    M), M <= max_m("chol_inv"), with the failure semantics of
    `chol_inv_plain` (the resident route refactors a float32 failure in
    float64, the multi-CTA route does not), on the route
    `chol_inv_route(M, route)` picks (the
    resident route takes M <= ~240; the multi-CTA route pads M to a multiple
    of 64 in a workspace unless it is one)."""
    Kb, m, device = _square_batch("chol_inv", K)
    route = chol_inv_route(m, route)
    nb = Kb.shape[0]
    limit = max_m("chol_inv", device, route)
    if m > limit or nb > 65535:
        raise ValueError(f"chol_inv: M={m} above the {route} route's {limit}, or {nb} matrices")
    L = torch.empty_like(Kb)
    Linv = torch.empty_like(Kb)
    if Kb.numel():
        work = [None] * 5  # lw, xw, flags, diag, dinv
        if route == "multi_cta":
            mp = -(-m // 64) * 64
            lw, xw = (L, Linv) if mp == m else (Kb.new_empty((nb, mp, mp)) for _ in range(2))
            flags = torch.zeros(nb, dtype=torch.int32, device=device)
            diag = Kb.new_empty((nb, mp // 32, 32, 32))
            dinv = Kb.new_empty((nb, mp // 64, 64, 64))
            work = [t.data_ptr() for t in (lw, xw, flags, diag, dinv)]
        _launch("chol_inv", device, Kb.data_ptr(), L.data_ptr(), Linv.data_ptr(), *work, nb, m,
                CHOL_INV_ROUTES[route])
    return L.reshape(K.shape), Linv.reshape(K.shape)


# ---------------------------------------------------------------------------
# Variance quadratic form
# ---------------------------------------------------------------------------


def quadform_diag_plain(A, W):
    """V[..., g, n] = sum_k (sum_m A[..., m, n] W[..., g, m, k])^2 in plain
    PyTorch.  A (M, N) or (S, M, N); W (G, M, M) or (S, G, M, M), any W.
    Builds the (..., G, N, M) intermediate."""
    C = torch.einsum("...mn,...gmk->...gnk", A, W)
    return torch.sum(C * C, dim=-1)


def _quadform_operands(name, A, W, vbar=None):
    """Check and batch the operands of the three quadform kernels: A (M, N)
    with W (G, M, M) and vbar (G, N), or the same with a leading S.  Returns
    contiguous (S, ...) operands, (s, g, m, n), whether the input was
    batched and the device."""
    batched = A.ndim == 3
    if A.ndim not in (2, 3) or W.ndim != A.ndim + 1:
        raise ValueError(
            f"{name}: expected A (S, M, N) with W (S, G, M, M), or A (M, N) "
            f"with W (G, M, M); got {tuple(A.shape)} and {tuple(W.shape)}"
        )
    Ab = A if batched else A[None]
    Wb = W if batched else W[None]
    s, m, n = Ab.shape
    g = Wb.shape[1]
    if Wb.shape != (s, g, m, m):
        raise ValueError(f"{name}: W {tuple(W.shape)} does not match A {tuple(A.shape)}")
    ops = [Ab.contiguous(), Wb.contiguous()]
    if vbar is not None:
        vb = vbar if batched else vbar[None]
        if vb.shape != (s, g, n):
            raise ValueError(f"{name}: vbar {tuple(vbar.shape)} does not match V {(s, g, n)}")
        ops.append(vb.contiguous())
    device = _check_cuda_f32(name, *ops)
    if m > max_m(name, device) or s > 65535:
        raise ValueError(f"{name}: M={m} (max {max_m(name, device)}) or S={s} too large")
    return ops, (s, g, m, n), batched, device


@_spanned
def quadform_diag_cuda(A, W):
    """`quadform_diag_plain` through `csrc/quadform_diag.cu` for CUDA float32
    tensors (M <= max_m("quadform_diag"), ~800 on the H100), without the
    (G, N, M) intermediate.

    W must be lower-triangular in its last two dims, as it is on the path
    (W = Lp^-1 @ tril(sqrt)): the kernel reads only that triangle (what
    lies above it is taken as zero) and skips most of the products with its
    zeros.
    """
    (Ab, Wb), (s, g, m, n), batched, device = _quadform_operands("quadform_diag", A, W)
    V = (torch.empty if m else torch.zeros)((s, g, n), dtype=torch.float32, device=device)
    if V.numel() and m:
        _launch("quadform_diag", device, Ab.data_ptr(), Wb.data_ptr(), V.data_ptr(), s, g, m, n)
    return V if batched else V[0]


# ---------------------------------------------------------------------------
# Backward of the variance quadratic form
# ---------------------------------------------------------------------------
#
# With C_g = A^T W_g and E_g[n, k] = 2 vbar[g, n] C_g[n, k], the VJP of
# V[g, n] = sum_k C_g[n, k]^2 is  dW_g = A E_g  and  dA = sum_g W_g E_g^T.


def quadform_diag_dw_plain(A, W, vbar):
    """dW of `quadform_diag_plain` for the cotangent vbar, in plain PyTorch:
    the lower triangle of A E_g, zero above it (what reaches a parameter
    when W is lower-triangular; see `quadform_diag_dw_cuda`).  A (M, N) or
    (S, M, N); W (G, M, M) or (S, G, M, M); vbar (G, N) or (S, G, N).
    Builds the (..., G, N, M) intermediates."""
    C = torch.einsum("...mn,...gmk->...gnk", A, W)
    E = 2.0 * vbar[..., None] * C
    return torch.einsum("...mn,...gnk->...gmk", A, E).tril()


def quadform_diag_da_plain(A, W, vbar):
    """dA of `quadform_diag_plain` for the cotangent vbar, in plain PyTorch:
    sum_g W_g E_g^T.  Shapes as `quadform_diag_dw_plain`."""
    C = torch.einsum("...mn,...gmk->...gnk", A, W)
    E = 2.0 * vbar[..., None] * C
    return torch.einsum("...gmk,...gnk->...mn", W, E)


@_spanned
def quadform_diag_dw_cuda(A, W, vbar):
    """`quadform_diag_dw_plain` through `csrc/quadform_diag_dw.cu` for CUDA
    float32 tensors (M <= max_m("quadform_diag_dw")), recomputing C tile by
    tile instead of holding the (G, N, M) intermediate, both products on the
    tensor cores by split TF32 operands (`csrc/qf_mma.cuh`; float32-level
    accuracy).

    W must be lower-triangular, as it is on the path (W = Lp^-1 @
    tril(sqrt)).  Only dW's lower triangle is computed and zeros are written
    above it: the strictly-upper part reaches no parameter, since the
    matmul's backward turns it into strictly-upper cotangents of Lp^-1 and
    of tril(sqrt), which the Cholesky-inverse backward and the tril masks
    drop.
    """
    (Ab, Wb, vb), (s, g, m, n), batched, device = _quadform_operands(
        "quadform_diag_dw", A, W, vbar
    )
    dW = torch.empty((s, g, m, m), dtype=torch.float32, device=device)
    if dW.numel():
        _launch("quadform_diag_dw", device, Ab.data_ptr(), Wb.data_ptr(), vb.data_ptr(),
                dW.data_ptr(), s, g, m, n)
    return dW if batched else dW[0]


@_spanned
def quadform_diag_da_cuda(A, W, vbar):
    """`quadform_diag_da_plain` through `csrc/quadform_diag_da.cu` for CUDA
    float32 tensors (M <= max_m("quadform_diag_da")): partial sums over
    chunks of groups on the tensor cores by split TF32 operands, then a fixed-order
    reduction of the chunks (both in the kernel's source, deterministic).
    W must be lower-triangular:
    only that triangle is read."""
    (Ab, Wb, vb), (s, g, m, n), batched, device = _quadform_operands(
        "quadform_diag_da", A, W, vbar
    )
    if g == 0 or m == 0 or n == 0:
        dA = torch.zeros((s, m, n), dtype=torch.float32, device=device)
        return dA if batched else dA[0]
    with torch.cuda.device(device):  # six blocks per SM, at most one chunk per group
        chunks = _library("quadform_diag_da").quadform_diag_da_chunks(s, g, m, n)
    if chunks < 1:
        raise RuntimeError(f"quadform_diag_da: could not query device {device}")
    partial = torch.empty((s, chunks, m, n), dtype=torch.float32, device=device)
    dA = torch.empty((s, m, n), dtype=torch.float32, device=device)
    _launch("quadform_diag_da", device, Ab.data_ptr(), Wb.data_ptr(), vb.data_ptr(),
            partial.data_ptr(), dA.data_ptr(), s, g, m, n, chunks)
    return dA if batched else dA[0]


def quadform_diag_bwd_plain(A, W, vbar):
    """(dA, dW) of `quadform_diag_plain` for the cotangent vbar from one C, in
    plain PyTorch: the math of `quadform_diag_da_plain` and
    `quadform_diag_dw_plain` (dW's lower triangle, zero above it).  Shapes
    as `quadform_diag_dw_plain`.  Builds the (..., G, N, M) intermediates."""
    C = torch.einsum("...mn,...gmk->...gnk", A, W)
    E = 2.0 * vbar[..., None] * C
    return (torch.einsum("...gmk,...gnk->...mn", W, E),
            torch.einsum("...mn,...gnk->...gmk", A, E).tril())


@_spanned
def quadform_diag_bwd_cuda(A, W, vbar):
    """`quadform_diag_bwd_plain` through `csrc/quadform_diag_bwd.cu` for CUDA
    float32 tensors (M <= max_m("quadform_diag_bwd")): C once a tile for
    both gradients, on the tensor cores by split TF32 operands, dW's panels
    summed over N in a thread-block cluster and dA's over chunks of groups
    in a fixed order (deterministic).  W must be lower-triangular; dW is
    its lower triangle, as `quadform_diag_dw_cuda` says.  Returns (dA, dW)."""
    (Ab, Wb, vb), (s, g, m, n), batched, device = _quadform_operands(
        "quadform_diag_bwd", A, W, vbar
    )
    if g == 0 or m == 0 or n == 0:
        dA = torch.zeros((s, m, n), dtype=torch.float32, device=device)
        dW = torch.zeros((s, g, m, m), dtype=torch.float32, device=device)
        return (dA, dW) if batched else (dA[0], dW[0])
    lib = _library("quadform_diag_bwd")
    with torch.cuda.device(device):  # the cut of the launch, from the shape and the card
        parts = lib.quadform_diag_bwd_parts(s, g, m, n)
        supers = lib.quadform_diag_bwd_supers(s, g, m, n)
    if parts < 1 or supers < 1:
        raise RuntimeError(f"quadform_diag_bwd: could not plan ({s}, {g}, {m}, {n}) on {device}")
    # scratch from torch.empty, so a CUDA graph's capture takes it from its pool
    dA_part = torch.empty((s, parts, m, n), dtype=torch.float32, device=device)
    dW_part = (torch.empty((supers, s, g, m, m), dtype=torch.float32, device=device)
               if supers > 1 else None)
    dA = torch.empty((s, m, n), dtype=torch.float32, device=device)
    dW = torch.empty((s, g, m, m), dtype=torch.float32, device=device)
    _launch("quadform_diag_bwd", device, Ab.data_ptr(), Wb.data_ptr(), vb.data_ptr(),
            dA_part.data_ptr(), None if dW_part is None else dW_part.data_ptr(),
            dA.data_ptr(), dW.data_ptr(), s, g, m, n)
    return (dA, dW) if batched else (dA[0], dW[0])


def quadform_bwd_route(A, W) -> str:
    """Which kernels the quadform's backward launches for CUDA float32
    operands when both gradients are needed: "fused"
    (`quadform_diag_bwd_cuda`) or "pair" (6b and 6c), by the rule measured
    on the H100 (PERF.md): the fused kernel where M <= QF_BWD_FUSED_MAX_M
    and one cluster of its blocks holds N (N <= QF_BWD_FUSED_MAX_N) or the
    groups are few (G <= QF_BWD_FUSED_MAX_G_WIDE); the pair elsewhere, where
    the fused kernel lost (M = 120 and 200, and G = 105 at N = 1000)."""
    m, n, g = A.shape[-2], A.shape[-1], W.shape[-3]
    fused = m <= min(QF_BWD_FUSED_MAX_M, max_m("quadform_diag_bwd", A.device)) and (
        n <= QF_BWD_FUSED_MAX_N or g <= QF_BWD_FUSED_MAX_G_WIDE)
    return "fused" if fused else "pair"


def _quadform_diag_bwd_pair(A, W, vbar):
    """(dA, dW) by the two backward kernels, `quadform_diag_da_cuda` and
    `quadform_diag_dw_cuda`, looked up in this module at the call (so
    `plain_versions` reaches them)."""
    return quadform_diag_da_cuda(A, W, vbar), quadform_diag_dw_cuda(A, W, vbar)


# ---------------------------------------------------------------------------
# Whitened coefficient factors
# ---------------------------------------------------------------------------
#
# For the factor parameter X (G, M, M) cut into group sets of `sizes` groups
# (the offdiagonal and diagonal coefficient groups of sqrt_U, or sqrt_W's
# one set), each set with its prior inverse factor P (S, M, M):
#   T = tril_regularized(X), W_set = P @ T[set] (S, n, M, M),
#   trace_set = ||W_set||_F^2 (S, n), logdet_set = sum log |diag T[set]| (n).


def whitened_factors_plain(X, Ps, sizes, jitter):
    """(Ws, traces, logdets), each a tuple over the group sets: the
    composition of ops the model runs off the card (`linalg.tril_regularized`
    on the whole X, `linalg.whiten`, ||W||^2 summed, the log of
    `linalg.regularized_diag` of each set's groups).  X (G, M, M); Ps a
    (S, M, M) lower-triangular factor a set; `sizes` the sets' group counts
    (summing to G), in X's order."""
    from . import linalg  # linalg imports this module

    Ws = linalg.whiten(linalg.tril_regularized(X, jitter), Ps, sizes)
    traces = tuple(torch.sum(W * W, dim=(-2, -1)) for W in Ws)
    logdets, start = [], 0
    for n in sizes:
        dq = linalg.regularized_diag(X[start:start + n], jitter)
        logdets.append(torch.sum(torch.log(torch.abs(dq)), dim=-1))
        start += n
    return Ws, traces, tuple(logdets)


def _check_whitened(name, X, Ps, sizes):
    """Check X (G, M, M), one (S, M, M) factor a set and the sets' sizes;
    returns (s, g, m, device)."""
    if X.ndim != 3 or X.shape[-1] != X.shape[-2]:
        raise ValueError(f"{name}: expected X (G, M, M), got {tuple(X.shape)}")
    g, m = X.shape[0], X.shape[-1]
    if len(Ps) != len(sizes) or len(sizes) not in (1, 2) or sum(sizes) != g:
        raise ValueError(f"{name}: {len(Ps)} factors for group sets {tuple(sizes)} of {g} groups")
    s = Ps[0].shape[0] if Ps[0].ndim == 3 else -1
    for P in Ps:
        if P.shape != (s, m, m):
            raise ValueError(f"{name}: expected factors (S, {m}, {m}), got {tuple(P.shape)}")
    device = _check_cuda_f32(name, X, *Ps)
    if m > max_m(name, device) or s < 1 or s > 65535:
        raise ValueError(f"{name}: M={m} (max {max_m(name, device)}) or S={s} out of range")
    return s, g, m, device


def _pair(items):
    """The sets' tensors as the kernels' two slots (None: an absent set)."""
    return list(items) + [None] * (2 - len(items))


def _ptr(t):
    return None if t is None else t.data_ptr()


@_spanned
def whitened_factors_cuda(X, Ps, sizes, jitter):
    """`whitened_factors_plain` through `csrc/whitened_factors.cu` for CUDA
    float32 tensors (M <= max_m("whitened_factors")): X read once, each W
    written once (zeros above its diagonal), the traces and log-determinants
    summed in the same pass.  A
    non-finite entry above X's diagonal makes its column of W NaN on and
    below the diagonal, and the set's trace NaN, as the plain product's
    mask multiply does."""
    sizes = tuple(int(n) for n in sizes)
    Ps = tuple(P.contiguous() for P in Ps)
    s, g, m, device = _check_whitened("whitened_factors", X, Ps, sizes)
    X = X.contiguous()
    Ws = tuple(torch.empty((s, n, m, m), dtype=torch.float32, device=device) for n in sizes)
    trs = tuple(torch.empty((s, n), dtype=torch.float32, device=device) for n in sizes)
    lds = tuple(torch.empty((n,), dtype=torch.float32, device=device) for n in sizes)
    if g and m:
        _launch("whitened_factors", device, X.data_ptr(), *map(_ptr, _pair(Ps)),
                *map(_ptr, _pair(Ws)), *map(_ptr, _pair(trs)), *map(_ptr, _pair(lds)),
                s, g, sizes[0], m, float(jitter))
    return Ws, trs, lds


def whitened_factors_bwd_plain(X, Ps, sizes, jitter, Ws, dWs, dtrs, dlds):
    """(dX, dPs) of `whitened_factors_plain` for the cotangents dWs, dtrs and
    dlds (each a tuple over the sets, an entry None where absent): the
    composition's vector-Jacobian product by autograd, its forward run
    again (Ws, the kernel's saved outputs, are not read)."""
    with torch.enable_grad():
        X = X.detach().requires_grad_(True)
        Ps = tuple(P.detach().requires_grad_(True) for P in Ps)
        outs = [t for ts in whitened_factors_plain(X, Ps, sizes, jitter) for t in ts]
        given = [(t, d) for t, d in zip(outs, (*dWs, *dtrs, *dlds)) if d is not None]
        grads = torch.autograd.grad([t for t, _ in given], (X, *Ps), [d for _, d in given],
                                    allow_unused=True)
    dX, *dPs = (torch.zeros_like(t) if d is None else d for t, d in zip((X, *Ps), grads))
    return dX, tuple(dPs)


@_spanned
def whitened_factors_bwd_cuda(X, Ps, sizes, jitter, Ws, dWs, dtrs, dlds):
    """`whitened_factors_bwd_plain` through `csrc/whitened_factors_bwd.cu`
    for CUDA float32 tensors (M <= max_m("whitened_factors_bwd")): dX
    written once in X's layout, each dP summed over its set's groups by
    blocks and then in a fixed order (deterministic, no atomics), the
    (S, G, M, M) broadcast gradient never formed.  Returns (dX, dPs)."""
    sizes = tuple(int(n) for n in sizes)
    Ps = tuple(P.contiguous() for P in Ps)
    s, g, m, device = _check_whitened("whitened_factors_bwd", X, Ps, sizes)
    X = X.contiguous()

    def given(ts, shape):
        out = []
        for t, n in zip(ts, sizes):
            if t is not None:
                t = t.contiguous()
                if t.shape != shape(n):
                    raise ValueError(f"whitened_factors_bwd: expected {shape(n)}, got "
                                     f"{tuple(t.shape)}")
                _check_cuda_f32("whitened_factors_bwd", X, t)
            out.append(t)
        return out

    Ws = given(Ws, lambda n: (s, n, m, m))
    dWs = given(dWs, lambda n: (s, n, m, m))
    dtrs = given(dtrs, lambda n: (s, n))
    dlds = given(dlds, lambda n: (n,))
    dX = torch.empty_like(X)
    dPs = tuple(torch.empty((s, m, m), dtype=torch.float32, device=device) for _ in sizes)
    if g == 0 or m == 0:
        return dX, tuple(P.zero_() for P in dPs)
    n1 = sizes[1] if len(sizes) == 2 else 0
    with torch.cuda.device(device):  # the cut of the launch, from the shape and the card
        slots = _library("whitened_factors_bwd").whitened_factors_bwd_slots(s, sizes[0], n1, m)
    if slots < 1:
        raise RuntimeError(f"whitened_factors_bwd: could not plan ({s}, {g}, {m}) on {device}")
    # scratch from torch.empty, so a CUDA graph's capture takes it from its pool
    part = torch.empty((slots, s, m, m), dtype=torch.float32, device=device)
    _launch("whitened_factors_bwd", device, X.data_ptr(), *map(_ptr, _pair(Ps)),
            *map(_ptr, _pair(dWs)), *map(_ptr, _pair(Ws)), *map(_ptr, _pair(dtrs)),
            *map(_ptr, _pair(dlds)), part.data_ptr(), dX.data_ptr(), *map(_ptr, _pair(dPs)),
            s, g, sizes[0], m, float(jitter))
    return dX, dPs
