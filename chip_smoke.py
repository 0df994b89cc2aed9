#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of CNMGP (DSVI training, posterior
prediction, fully-Bayesian NUTS/HMC/ChEES and SMC model comparison) on
one CUDA card.

    python3 chip_smoke.py

In order: builds the eight hand-written kernels from
`collaborative_nonstationary_multivariate_gaussian_process_tpu_torch/csrc`
with nvcc; holds each kernel against its plain PyTorch version on the card
at the shapes of the path (the serving forwards; the forward of the
quadratic form and its two backward kernels against float64 at M = 100
and 200, the forward also on the path's kind of inputs and timed against
its einsum at every shape of the training and serving paths; the Gibbs
and RBF grams at every shape of the paths beside the launch floor, the RBF
also at 70,001 pairs); serves `predict_Y`,
`sample_Y` and `sample_FY` at the full ECoG width (D=78 outputs, M=100
inducing points, B=512 test points) from seeded random parameters, checks
that every kernel of each path was launched, and holds each call, and the
same call through the plain versions, against a float64 run on the same
noise; serves the model the JAX package fitted to
`sim_illustration_low_freq` (the committed fixture) and compares its
predictions; trains an epoch by `inference()` at ECoG width (D=78, N=62,400,
B=512), checks that all five kernels were launched and the losses are
finite, and holds every parameter's gradient on one batch against float64
(a float64 run, which the dispatch rule sends to the plain versions with no
kernel launched);
times training steps at ECoG and PM2.5-sub width (D=6, M=100, B=2000) with
the kernels and with the plain versions, and profiles one step; fits
`sim_illustration_low_freq` by `inference()` and holds the fit to the
assertions of `tests/test_dsvi_e2e.py`; times kernels, plain versions, the
library yardstick and the requests with CUDA events; trains an epoch at
the reference's ECoG M = 200 (Z = linspace(0, 800, 200)), checks that all
five kernels were launched, and times its steps on both routes; runs the
Cholesky-inverse witness study (`chol_inv_witness`: the ECoG gradient gate
and the card test's small model at ten draws each, on every kernel, on the
plain versions, with only chol_inv swapped either way and with each of its
two outputs alone, and the factor alone against float64 and cuSOLVER);
runs the `dsvi_options` phase (a forced divergence caught by
`divergence_rollback`, an ECoG epoch with the test RMSE every step and one
with `chunked_test_trace`, and a checkpoint saved, resumed and, where
ml_dtypes imports, saved with bf16 moments); runs the fused trainer
(`scan_epochs_phase`, after the training phase): two epochs of
`make_scan_epochs` replayed as CUDA graphs at ECoG width against the eager
epoch body from the same state, in float32 with the kernels (the launches
of a replayed epoch: the capture's count a step times its steps) and in
float64, steps/s of the graph against the eager step at ECoG M = 100 and
200 and PM2.5-sub with the device's busy share, the capture's seconds and
the graph pools' memory, and `inference()` on the graph through a forced
rollback.  Every `inference()` epoch without a per-step probe runs on the
graphs, and its launches are counted at each replay.  Then the
fully-Bayesian path: holds the RBF, Cholesky, Kronecker-matvec and
Cholesky-inverse kernels against float64 runs of their plain versions at
the path's shapes (the Cholesky-inverse at M = 200 and 1024, NaN on a
non-PD member; RBF and Cholesky also on the path's own whitening grams;
the Cholesky on both of its routes at (1, 401), (2, 100), (2, 1024) and
(4, 2048) with the routes' crossover table; the Kronecker matvec on each
layout of K, as stored, transposed and shared by the chains; the
Cholesky-inverse at (4, 100), (32, 100), (4, 200), (4, 1024) and (4, 2048)
against float64 and timed against the plain pair, with its routes'
crossover table);
runs `scripts/run_mcmc_sim.py`'s default study through the port
(sim_mnts M=2, N=100; empirical init; the whitened SVC density, dim 401;
NUTS, 4 chains, max depth 8, diagonal mass; its 400 warmup and 400 samples
cut to 100 and 60 to fit the time limit, and the chains started at the MAP
that `run_map` finds from the empirical init, see FB_WARMUP), holds
the log-posterior and its gradient at the empirical init and at that start
against float64, checks the
launches, R-hat, the recovery of the lengthscale and correlation processes,
and prints samples/s, ESS/s and the host reads; profiles one leapfrog;
predicts from its 240 draws through `models/prediction.py`
(`prediction_phase`: `svc_predsample` on a 200-point grid and at the
study's x, the latent processes, the MAP band and its sampling form, with
the launches of gibbs, rbf and cholesky, every output against float64 and
the draws' coverage of the observations; every other entry point on 64
draws around the truth, the hadamard families on a 25% holdout of the flat
data by `data_split_non`; the three kernels at the path's shapes against
float64 and timed, and the two SVC entry points timed with the kernels and
the plain versions in turns, with the device's busy share); then
the whitened SNMGP at N=1024 (MN = 2048, the Kronecker eigen route through
the matvec kernel): value and gradient against float64, a short HMC run,
and `mvn_logpdf_kron` timed on both routes at MN = 1024 and 2048; then
`scripts/run_mcmc_sim.py --sampler chees` through the port's driver
(`drivers/mcmc_sim.py`: the same SVC study by ChEES-HMC from its
overdispersed start, its 400 samples cut to 120, see CHEES_WARMUP):
acceptance, trajectory length, R-hat and recovery against bounds from the
JAX package's own run, the log-posterior and gradient at the start
against float64, and the DIC of the draws; and
`scripts/run_model_comparison.py` at its defaults, uncut, through
`drivers/model_comparison.py` (SMC over LMC, SNMGP and SVC, N=48, 512
particles): each log Z in a band of the JAX package's runs, beta reaching
1, a nonstationary model best, each tempered density against float64, and
chol_inv at (512, 96, 96) and gibbs at (512, 48, 48) on its inputs against
float64 and timed.  Then the real-data path (`realdata_phases`):
`scripts/run_workload.py` through `drivers/run_workload.py` at ECoG width
(D=78, with the spatial analysis of 200 draws on 200 grid points), HCP
(D=15) and PM2.5-full (D=6, N=302,537; its 100 epochs cut to 12), each
held to the script's keys, no rollback, every step's loss finite, the
final loss below the first, coverage >= 0.9 and a test RMSE and CI length
within 1.25x the JAX package's recorded run; chol_inv's float64 refactor
of a float32 failure on the HCP tilde_ell prior at trained variances
against float64; `negative_selbo` at an HCP and a PM2.5-full batch
against float64 at three row orders;
6a/6b/6c and the fused backward at (G, N) = (105, 1000) and (15, 1000) and
gibbs (1, 1000, 100) timed; `scripts/baseline_parity.py` through `drivers/baseline_parity.py`
in float32 with the kernels against its float64 run (its Adam steps cut 10x
in both, BASELINE_STEP_CUT), the baselines'
likelihoods and gradients against float64, `fit_sicm` at PM2.5-sub width
and cholesky at (1, 100, 100) and (1, 200, 200) timed; and
`scripts/sim_parity.py` once at its protocol, held to the assertions of
`tests/test_dsvi_e2e.py`.  Then the multi-device layer
(`multidevice_phase`): the native host library against NumPy;
`inference(mesh=make_mesh())` on an NCCL group of one rank at ECoG width,
the all-reduce captured in the step graph, bit for bit the run without a
mesh, and the two graphs' steps/s in turns; two gloo ranks spawned on the
card (`drivers/multidevice_check.py`): a data-parallel ECoG step of 256
rows a rank, its gradient against float64 and its all-reduce's share of
the step, `run_chees_sharded` on the SVC study (cut to 40 + 10 + 20),
`run_smc_sharded` on the three models of the comparison (each log Z in its
band) and a short `run_nuts_sharded`; `graft_entry.dryrun_multichip(2)`
and `entry()`; the training kernels at one rank's shapes and chol_inv and
gibbs at SMC's 256 particles a rank, timed; a `utils.profiling` trace of
three ECoG steps, `print_mem`, and the FLOPs and MFU of an ECoG step.  The
ranks' kernel launches come back with their results and count in the
kernels line.  Each phase prints its seconds, and the script its total.  The second-to-last line is a JSON object with one entry per kernel (its
other shapes and routes under "more"); the last
line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, when no CUDA card is present, the port
package is not beside this script, or any check fails.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack, contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch

# The kernels a DSVI training step launches (the rest serve the other paths):
# the quadform's backward is the fused kernel wherever M is within its limit.
TRAIN_KERNELS = ("gibbs", "chol_inv", "quadform_diag", "quadform_diag_bwd", "whitened_factors",
                 "whitened_factors_bwd")
# ... and at M = 200, where the measured route (`quadform_bwd_route`) keeps 6b
# and 6c
TRAIN_KERNELS_M200 = ("gibbs", "chol_inv", "quadform_diag", "quadform_diag_dw", "quadform_diag_da")
# scripts/run_mcmc_sim.py's default run: N, chains, max depth, and its
# hyperparameters (:115-118, drivers/mcmc_sim.HYPERS) as they are; its 400
# warmup and 400 samples cut to FB_WARMUP and FB_SAMPLES.  Every transition of that run saturates the
# depth (255 leapfrogs, 4 chains in lockstep), and a leapfrog pass of the
# port's eager loop costs ~8.5 ms of host time on the H100 (PERF.md), so the
# 880 transitions of the full run would take ~30 minutes, more than this
# script's time limit; the width is not cut.  The chains start at the MAP
# that `run_map` finds from the empirical init (MAP_LR, MAP_STEPS), not at
# the init itself (log-posterior about -31,000, the mode about +90): from
# there one chain of four stayed in a region of lower density through 100
# and through 150 warmup transitions (R-hat max 2.35 and 2.49), where the
# JAX package's own run of the same study cut to 100 + 100 converged on
# the CPU (R-hat max 1.011); `svc_init_study.py` counts such chains.  The
# samples are cut to 60: a pass's host time varies up to ~1.8x between
# machines (6.5 to 11.5 ms), and at 100 + 100 the slowest took 641 s of
# the script's 831, past half its time limit.
FB_N, FB_CHAINS, FB_DEPTH = 100, 4, 8
FB_WARMUP, FB_SAMPLES = 100, 60
FB_FULL = (400, 400)
MAP_LR, MAP_STEPS = 0.2, 2000
# the SNMGP check of the Kronecker eigen route: MN = 2 x 1024 > KRON_DENSE_MAX_DIM
SNMGP_N = 1024
# its short HMC run's warmup and samples (once 20 + 20), held finite
SNMGP_HMC = 10
# the Cholesky's shapes on the path, (batch, M): the dense NUTS metric of the
# SVC study, the SVC and SNMGP whitening factors, the dense Kronecker
# route's size; and the sizes at batch 2 where its two routes are compared
CHOL_SHAPES = ((1, 401), (2, 100), (2, 1024), (4, 2048))
CHOL_CROSSOVER_SIZES = (16, 32, 64, 100, 128, 200, 256, 401, 512, 1024)
SNMGP_HYPERS = dict(alpha_tilde_l=3.0, beta_tilde_l=0.4, alpha_tilde_sigma=1.0, beta_tilde_sigma=0.4)
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and non-tensor FP32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12  # dense, on the tensor cores
# TF32 products per FP32 product in the quadform backward kernels: six for
# C = A^T W (three pieces an operand), three for the product after it
# (3xTF32); csrc/qf_mma.cuh
QF_TF32_PRODUCTS = (6 + 3) / 2
# and in the fused backward, over its three products: 6 for C, 3 and 3 after it
QF_FUSED_TF32_PRODUCTS = (6 + 3 + 3) / 3
EPS32 = float(torch.finfo(torch.float32).eps)
D_ECOG, M_ECOG, B_ECOG = 78, 100, 512  # scripts/bench_ecog.py:46-52
M_ECOG200 = 200  # the reference's M=200 ECoG block (scripts/ecog_per_m_study.py:11)
D_PM, M_PM, B_PM, N_PM = 6, 100, 2000, 28_768  # bench.py:110-123
TRAIN_STEPS = 20
HYPERPARS = {  # tests/test_dsvi_e2e.py:32-40
    "sigma2_L0_log": 0, "length_scales_L0_log": 2, "sigma2_L1_log": 0,
    "length_scales_L1_log": 2, "sigma2_tildeell_log": 0, "length_scales_tildeell_log": 0,
    "sigma2_err_log": -2,
}
S_CHUNK = 8
N_DRAWS = 16
JITTER = 1e-4
# Busy-wait queued ahead of a timed run, ~5 ms at the H100's clock: the host
# enqueues the timed calls meanwhile, so the events time the device alone.
# A rep whose enqueue outlasts it is run again with a wait twice as long.
SLEEP_CYCLES = 10_000_000
SLEEP_DOUBLINGS = 4
FAILURES: list[str] = []
PORT = "collaborative_nonstationary_multivariate_gaussian_process_tpu_torch"


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def rel_to_max(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, that over max |b|)."""
    a, b = a.double(), b.double()
    err = float((a - b).abs().max()) if a.numel() else 0.0
    scale = float(b.abs().max()) if b.numel() else 1.0
    return err, err / max(scale, 1e-300)


def device_ms(fn, reps: int = 20, inner: int = 1, waits_ok: bool = False) -> float:
    """Median over `reps` of the device time per call of `inner` calls, by
    CUDA events.  A busy-wait kernel queued first holds the card while the
    host enqueues the calls, so the host's launch overhead is not timed.  A
    rep whose enqueue outlasted the wait is discarded and run again with a
    wait twice as long; one that outlasts SLEEP_DOUBLINGS doublings fails
    the run.  With `waits_ok` (a library call that waits on the device from
    the host, as cuSOLVER's batched Cholesky does at M = 2048), a call whose
    first enqueue outlasts the wait is timed back to back instead, and
    said so."""
    fn()
    torch.cuda.synchronize()
    times = []
    for rep in range(reps):
        for doubling in range(SLEEP_DOUBLINGS + 1):
            wait, start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            wait.record()
            torch.cuda._sleep(SLEEP_CYCLES << doubling)
            t0 = time.perf_counter()
            start.record()
            for _ in range(inner):
                fn()
            stop.record()
            host = 1e3 * (time.perf_counter() - t0)
            stop.synchronize()
            if host <= wait.elapsed_time(start):
                times.append(start.elapsed_time(stop) / inner)
                break
            if waits_ok and rep == 0:
                print("  (the call waits on the host: timed back to back)")
                return back_to_back_ms(fn, reps, inner)
        else:
            check(False, f"device timing: host enqueue {host:.2f} ms outlasted the "
                  f"{wait.elapsed_time(start):.2f} ms wait")
    return float(np.median(times))


def back_to_back_ms(fn, reps: int = 20, inner: int = 1) -> float:
    """Median over `reps` of the CUDA-event time per call of `inner` calls
    issued back to back, the host's launch overhead included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return float(np.median(times))


def host_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median host-clock time of a call that ends in a device sync."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ecog_request(seed: int):
    """B=512 flat test points across the 78 outputs, inputs on the ECoG
    time axis [0, 800] (the training inputs are tile(arange(800), 78))."""
    rng = np.random.default_rng(seed)
    sizes = [len(a) for a in np.array_split(np.arange(B_ECOG), D_ECOG)]
    return [np.sort(rng.uniform(0.0, 800.0, n)) for n in sizes]


def profile_breakdown(fn, top: int = 8, watch=()) -> None:
    """Profile one call: wall time, summed device-kernel time (its share of
    the wall is the device's busy share), the number of kernels and those
    that take most, and any kernel whose name holds one of `watch` (or
    that none ran).  The optimizer's own annotation range on the device
    timeline ("Optimizer.step#...") spans kernels already counted, so it is
    left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.key.startswith("Optimizer.")]
    busy = sum(e.device_time_total for e in events) / 1e3
    if not events:
        print(f"profile: wall {wall:.3f} ms; the profiler recorded no device time")
        return
    print(f"profile: wall {wall:.3f} ms, device kernels {busy:.3f} ms in "
          f"{sum(e.count for e in events)} kernels (busy {busy / wall:.1%}, idle {1 - busy / wall:.1%})")
    ranked = sorted(events, key=lambda e: -e.device_time_total)
    for e in ranked[:top]:
        print(f"profile:   {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    for w in watch:
        hits = [e for e in ranked if w in e.key]
        print(f"profile:   {w}: " + ("; ".join(f"{e.device_time_total / 1e3:.3f} ms x{e.count} "
                                               f"{e.key[:60]}" for e in hits) or "no kernel ran"))


@contextmanager
def recording(ck, names, calls):
    """Route each named kernel wrapper through a recorder that appends a
    detached copy of its arguments to calls[name], then calls the wrapper."""
    with ExitStack() as stack:
        for name in names:
            def rec(*args, _real=getattr(ck, f"{name}_cuda"), _name=name):
                calls.setdefault(_name, []).append(
                    tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args))
                return _real(*args)

            stack.enter_context(mock.patch.object(ck, f"{name}_cuda", rec))
        yield


def backward_kernels(ck, gen, dev, M=M_ECOG, G=None, N=None):
    """The quadform's backward kernels at a training shape (A (M, N),
    lower-triangular W (G, M, M), random vbar; by default ECoG's G = 3003
    and N = 512): 6b, 6c and the fused backward (dA and dW from one C).
    Each f32 result is held against float64 on the same inputs (kernel at
    most 3x the plain version's error + 1e-6 of max; the fused kernel's dA
    and dW each), dW zero above the diagonal, the fused kernel's two
    launches bitwise equal; then each is timed.  Returns {name: (timing
    row, max |kernel - plain|, tensor-core bounds)}: the bounds in ms of the
    kernel's split and of 3xTF32 throughout, on the dense TF32 rate."""
    G = D_ECOG * (D_ECOG - 1) // 2 if G is None else G
    N = B_ECOG if N is None else N
    shape = f"({G},{M},{M})x({M},{N})"
    A = torch.randn(M, N, device=dev, generator=gen)
    W = 0.1 * torch.randn(G, M, M, device=dev, generator=gen).tril()
    vbar = torch.randn(G, N, device=dev, generator=gen)
    A64, W64, v64 = A.double(), W.double(), vbar.double()
    # the library yardstick, the einsum composition of the plain versions
    C = lambda: torch.einsum("mn,gmk->gnk", A, W)  # noqa: E731

    def both():
        E = 2.0 * vbar[..., None] * C()
        return torch.einsum("gmk,gnk->mn", W, E), torch.einsum("mn,gnk->gmk", A, E)

    library = {
        "quadform_diag_dw": lambda: torch.einsum("mn,gnk->gmk", A, 2.0 * vbar[..., None] * C()),
        "quadform_diag_da": lambda: torch.einsum("gmk,gnk->mn", W, 2.0 * vbar[..., None] * C()),
        "quadform_diag_bwd": both,
    }
    tri = 4 * G * M * (M + 1) // 2
    n_bytes = {
        "quadform_diag_dw": 4 * (M * N + G * N + G * M * M) + tri,
        "quadform_diag_da": 4 * (M * N + G * N + M * N) + tri,
        "quadform_diag_bwd": 4 * (2 * M * N + G * N + G * M * M) + tri,
    }
    ops = 2 * G * N * M * (M + 1)  # M (M + 1) FMAs per (g, n): C, then the product
    # TF32 products per FMA of the triangle: 6b and 6c (6 + 3) over two
    # products; the fused kernel 6 + 3 + 3 over three
    products = {"quadform_diag_dw": (QF_TF32_PRODUCTS, 2),
                "quadform_diag_da": (QF_TF32_PRODUCTS, 2),
                "quadform_diag_bwd": (QF_FUSED_TF32_PRODUCTS, 3)}
    out = {}
    for name in ("quadform_diag_dw", "quadform_diag_da", "quadform_diag_bwd"):
        kern, plain = getattr(ck, f"{name}_cuda"), getattr(ck, f"{name}_plain")
        per, n_prod = products[name]
        n_ops = n_prod * ops // 2
        tc = {"tc_bound_ms": per * n_ops / PEAK_TF32_PER_S * 1e3,
              "tc3_bound_ms": 3 * n_ops / PEAK_TF32_PER_S * 1e3}
        got, ref, ref64 = kern(A, W, vbar), plain(A, W, vbar), plain(A64, W64, v64)
        if name == "quadform_diag_bwd":
            again = kern(A, W, vbar)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} {shape}: two launches bitwise equal")
            del again
            parts = tuple(zip(("dA", "dW"), got, ref, ref64))
        else:
            parts = ((name, got, ref, ref64),)
        torch.cuda.synchronize()
        abs_err = 0.0
        for what, g_, r_, r64 in parts:
            err_k, err_p = rel_to_max(g_, r64)[1], rel_to_max(r_, r64)[1]
            abs_err = max(abs_err, rel_to_max(g_, r_)[0])
            check(err_k <= 3 * err_p + 1e-6 and bool(torch.isfinite(g_).all()),
                  f"{name} {what} {shape} vs float64, of max: kernel {err_k:.3e}, plain "
                  f"{err_p:.3e}; tol 3x plain + 1e-6")
        dW = got[1] if name == "quadform_diag_bwd" else got if name == "quadform_diag_dw" else None
        if dW is not None:
            check(torch.equal(dW, dW.tril()), f"{name} writes zeros above dW's diagonal")
        del got, ref, ref64, parts, dW
        row = (device_ms(lambda: kern(A, W, vbar)), device_ms(lambda: plain(A, W, vbar)),
               device_ms(library[name]), bound_ms(n_bytes[name], n_ops))
        print(f"time {name} {shape}: kernel {row[0]:.4f} ms on the device, plain "
              f"{row[1]:.4f} ms, library {row[2]:.4f} ms, bound {row[3][0]:.4f} ms ({row[3][1]}), "
              f"{row[3][0] / row[0]:.1%} of bound, {n_ops / (row[0] * 1e-3) / 1e9:.0f} GFLOP/s; "
              f"tensor-core bound {tc['tc_bound_ms']:.4f} ms ({tc['tc_bound_ms'] / row[0]:.1%}), "
              f"3xTF32 throughout {tc['tc3_bound_ms']:.4f} ms")
        out[name] = (row, abs_err, tc)
    pair = out["quadform_diag_dw"][0][0] + out["quadform_diag_da"][0][0]
    print(f"time quadform backward {shape}: fused {out['quadform_diag_bwd'][0][0]:.4f} ms, "
          f"the pair 6b + 6c {pair:.4f} ms ({pair / out['quadform_diag_bwd'][0][0]:.2f}x)")
    return out


# The shapes of the fused backward's gate (G, M, N): ECoG's two group sets,
# M = 200, a data-parallel rank, PM2.5-sub's offdiagonal groups, HCP's
BWD_SHAPES = ((3003, 100, 512), (78, 100, 512), (3003, 200, 512), (3003, 100, 256),
              (15, 100, 2000), (105, 100, 1000))


def bwd_main() -> int:
    """The quadform backward kernels' gate and times at BWD_SHAPES alone, with
    their build (~1-2 min):
    python3 -u -c 'import sys, chip_smoke; sys.exit(chip_smoke.bwd_main())'"""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    dev = torch.device("cuda")
    names = ("quadform_diag_dw", "quadform_diag_da", "quadform_diag_bwd")
    for name, log in ck.build(names).items():
        print(f"build {name}:\n{log}")
    print(f"max_m: {ck.max_m('quadform_diag_bwd')} fused, {ck.max_m('quadform_diag_dw')} 6b, "
          f"{ck.max_m('quadform_diag_da')} 6c ({smi})")
    for i, (G, M, N) in enumerate(BWD_SHAPES):
        backward_kernels(ck, torch.Generator(device=dev).manual_seed(20 + i), dev, M, G=G, N=N)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    return 0


def path_qf_inputs(dev, M, N, G, seed):
    """The quadform's operands as the path makes them, where C = A^T W
    cancels (W's entries ~100x C's): A = Lp^-1 K_zx and W_g = Lp^-1
    tril(S_g) of the RBF prior of lengthscale 40 on Z = linspace(0, 800, M)
    (+ 1e-4 jitter), inputs on the ECoG time axis; float32 on the card."""
    r = np.random.default_rng(seed)
    Z = np.linspace(0.0, 800.0, M)
    x = np.sort(r.uniform(0.0, 800.0, N))
    k = lambda a, b: np.exp(-0.5 * ((a[:, None] - b[None, :]) / 40.0) ** 2)  # noqa: E731
    Lp_inv = np.linalg.solve(np.linalg.cholesky(k(Z, Z) + 1e-4 * np.eye(M)), np.eye(M))
    S = np.tril(0.1 * r.standard_normal((G, M, M))) + np.eye(M)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return f32(Lp_inv @ k(Z, x)), f32(np.tril(Lp_inv @ S))


# 6a's shapes (S, G, M, N) on the main paths: ECoG training's three calls a
# step (G = 3003 and 78, S = 1, N = B = 512) at M = 100 and 200, PM2.5-sub
# training's (G = 15 and 6, N = 2000), sample_Y's chunks of 8 draws,
# sample_FY's N = 64 and the illustration fit's D = 2 (G = 1 and 2, M = 10,
# N = 200)
QF_PATH_SHAPES = (
    (1, 3003, 100, 512), (1, 78, 100, 512), (1, 3003, 200, 512), (1, 78, 200, 512),
    (1, 15, 100, 2000), (1, 6, 100, 2000), (8, 78, 100, 512), (8, 3003, 100, 64),
    (8, 78, 100, 64), (1, 1, 10, 200), (1, 2, 10, 200),
)


def qf_bound(S, G, M, N):
    """6a's bound: per (g, n) M (M + 1) / 2 FMAs for C and M for its squares;
    W's triangle, A and V moved once."""
    return bound_ms(4 * (S * M * N + S * G * M * (M + 1) // 2 + S * G * N), S * G * N * (M * M + 3 * M))


def forward_kernel(ck, gen, dev):
    """6a held against float64 at M = 100 and 200 (A (M, 512), G = 3003), on
    random lower-triangular W and on the path's kind of inputs: kernel at
    most 3x the plain f32 version's error + 1e-6 of max; then timed against
    the plain version and the einsum at every shape of QF_PATH_SHAPES.
    Returns (max |kernel - plain|, the timing rows)."""
    G, N = D_ECOG * (D_ECOG - 1) // 2, B_ECOG
    errs = []
    for M in (M_ECOG, M_ECOG200):
        A = torch.randn(M, N, device=dev, generator=gen)
        W = 0.1 * torch.randn(G, M, M, device=dev, generator=gen).tril()
        for kind, (a, w) in (("random", (A, W)), ("path", path_qf_inputs(dev, M, N, G, M))):
            got, plain = ck.quadform_diag_cuda(a, w), ck.quadform_diag_plain(a, w)
            ref64 = ck.quadform_diag_plain(a.double(), w.double())
            torch.cuda.synchronize()
            errs.append(witnessed(f"quadform_diag ({kind} inputs)", got, plain, ref64, 1e-6,
                                  f"({G},{M},{M})x({M},{N})"))
            del got, plain, ref64
        del A, W
    rows = []
    for S, G, M, N in QF_PATH_SHAPES:
        A = torch.randn(S, M, N, device=dev, generator=gen)
        W = 0.1 * torch.randn(S, G, M, M, device=dev, generator=gen).tril()
        rows.append(timing_entry(
            f"quadform_diag ({S},{G},{M},{M})x({S},{M},{N})", lambda: ck.quadform_diag_cuda(A, W),
            lambda: ck.quadform_diag_plain(A, W),
            lambda: torch.einsum("smn,sgmk->sgnk", A, W).square().sum(-1), qf_bound(S, G, M, N),
            inner=1))
        check(rows[-1]["ms"] < rows[-1]["library_ms"],
              f"{rows[-1]['at']}: kernel {rows[-1]['ms']:.4f} ms below the einsum "
              f"{rows[-1]['library_ms']:.4f} ms")
        del A, W
    return max(errs), rows


# The Gibbs gram's shapes (S, N, M) on the paths: DSVI's cross and inducing
# grams a step, serving's chunks of 8 draws, the SVC NUTS gradient and the
# SNMGP prior at N = 1024
GIBBS_PATH_SHAPES = ((1, 512, 100), (1, 100, 100), (8, 512, 100), (8, 100, 100), (4, 100, 100),
                     (4, 1024, 1024))


def gibbs_shapes(ck, gen, dev):
    """The Gibbs kernel at every shape of GIBBS_PATH_SHAPES (d = 1): rtol
    1e-5 against the plain version, then timed beside the launch floor (a
    near-empty kernel, `torch.cuda._sleep` of a few cycles, by the same
    timer).  Returns (max |kernel - plain|, the timing rows)."""
    floor = device_ms(lambda: torch.cuda._sleep(8), inner=10)
    print(f"time launch floor (torch.cuda._sleep(8)): {floor:.5f} ms on the device", flush=True)
    errs, rows = [], []
    for S, n, m in GIBBS_PATH_SHAPES:
        x1 = 800.0 * torch.rand(n, device=dev, generator=gen)  # the ECoG time axis
        x2 = 800.0 * torch.rand(m, device=dev, generator=gen)
        l1 = torch.exp(2.5 + 0.3 * torch.randn(S, n, device=dev, generator=gen))
        l2 = torch.exp(2.5 + 0.3 * torch.randn(S, m, device=dev, generator=gen))
        K, K_ref = ck.gibbs_cuda(x1, x2, l1, l2, 1.0), ck.gibbs_plain(x1, x2, l1, l2, 1.0)
        torch.cuda.synchronize()
        errs.append(float((K - K_ref).abs().max()))
        check(float(((K - K_ref).abs() - 1e-5 * K_ref.abs() - 1e-30).max()) <= 0.0
              and bool(torch.isfinite(K).all()), f"gibbs ({S},{n},{m}): max|K-plain| {errs[-1]:.3e}, rtol 1e-5")
        el = S * n * m
        row = timing_entry(f"gibbs ({S},{n},{m})", lambda: ck.gibbs_cuda(x1, x2, l1, l2, 1.0),
                           lambda: ck.gibbs_plain(x1, x2, l1, l2, 1.0), None,
                           bound_ms(4 * (n + m + S * (n + m) + el), el * 15), inner=10)
        row["floor_ms"] = floor
        rows.append(row)
        print(f"  gibbs ({S},{n},{m}): {row['ms'] - floor:.5f} ms above the launch floor", flush=True)
        del K, K_ref
    # inputs on [0, 1], lengthscales ~0.1: most entries lie far out on the
    # exponential (|x1 - x2|^2 / (l1^2 + l2^2) up to ~50), where two float32
    # evaluations of the same formula differ by ~1e-5 of the entry (an ulp
    # of the exponent's argument); both held against float64 instead
    S, n, m = GIBBS_PATH_SHAPES[-1]
    x1, x2 = torch.rand(n, device=dev, generator=gen), torch.rand(m, device=dev, generator=gen)
    l1 = torch.exp(-2.3 + 0.3 * torch.randn(S, n, device=dev, generator=gen))
    l2 = torch.exp(-2.3 + 0.3 * torch.randn(S, m, device=dev, generator=gen))
    f64 = [t.double() for t in (x1, x2, l1, l2)]
    errs.append(witnessed("gibbs (far entries)", ck.gibbs_cuda(x1, x2, l1, l2, 1.0),
                          ck.gibbs_plain(x1, x2, l1, l2, 1.0), ck.gibbs_plain(*f64, 1.0), 1e-6,
                          f"({S},{n},{m})"))
    return max(errs), rows


# The RBF gram's shapes (S, N, M) on the paths, with the span of their
# inputs and their (scale^2, lengthscale) pairs: predict_y_mean's cross and
# inducing grams at ECoG width (six a call, one pair each; the test trace
# of training runs them every epoch or step), the SVC whitening grams at
# N = 100 and the SNMGP ones at N = 1024 (logdensities._prior_chols)
RBF_PATH_SHAPES = ((1, 512, 100), (1, 100, 100), (2, 100, 100), (2, 1024, 1024))
RBF_PATH_INPUTS = {(1, 512, 100): (800.0, None), (1, 100, 100): (800.0, None),
                   (2, 100, 100): (1.0, ((9.0, 0.4), (25.0, 1.0))),
                   (2, 1024, 1024): (1.0, ((9.0, 0.4), (1.0, 0.4)))}


def rbf_shapes(ck, gen, dev):
    """The RBF kernel at every shape of RBF_PATH_SHAPES: rtol 1e-5 against
    the plain version (and the share of entries equal to it bit for bit),
    within 3x the plain f32 error of float64 + 1e-6 of max, then timed
    beside the launch floor; and once at 70,001 pairs (above a grid
    dimension's 65,535) with M % 4 != 0.  Returns (max |kernel - plain|,
    the timing rows)."""
    floor = device_ms(lambda: torch.cuda._sleep(8), inner=10)
    errs, rows = [], []
    for S, n, m in RBF_PATH_SHAPES:
        span, pairs = RBF_PATH_INPUTS[(S, n, m)]
        x1 = span * torch.rand(n, device=dev, generator=gen)
        x2 = torch.linspace(0.0, span, m, device=dev) if n != m else x1
        if pairs is None:  # exp of the 0-d log parameters, as predict_y_mean has them
            s2, ls = torch.tensor(1.0, device=dev), torch.tensor(40.0, device=dev)
        else:
            s2, ls = (torch.tensor(v, device=dev) for v in zip(*pairs))
        K, K_ref = ck.rbf_cuda(x1, x2, s2, ls), ck.rbf_plain(x1, x2, s2, ls)
        torch.cuda.synchronize()
        errs.append(float((K - K_ref).abs().max()))
        same = float((K == K_ref).double().mean())
        check(float(((K - K_ref).abs() - 1e-5 * K_ref.abs() - 1e-30).max()) <= 0.0
              and bool(torch.isfinite(K).all()),
              f"rbf ({S},{n},{m}): max|K-plain| {errs[-1]:.3e}, rtol 1e-5; {same:.1%} of the "
              f"entries equal to the plain version's")
        witnessed("rbf", K, K_ref, ck.rbf_plain(x1.double(), x2.double(), s2.double(), ls.double()),
                  1e-6, f"({S},{n},{m})")
        el = S * n * m
        row = timing_entry(f"rbf ({S},{n},{m})", lambda: ck.rbf_cuda(x1, x2, s2, ls),
                           lambda: ck.rbf_plain(x1, x2, s2, ls), None,
                           bound_ms(4 * (n + m + 2 * S + el), 5 * el), inner=10)
        row.update(floor_ms=floor, equal_to_plain=same)
        rows.append(row)
        print(f"  rbf ({S},{n},{m}): {row['ms'] - floor:.5f} ms above the launch floor", flush=True)
        del K, K_ref
    S, n, m = 70_001, 3, 5
    x1, x2 = torch.rand(n, device=dev, generator=gen), torch.rand(m, device=dev, generator=gen)
    s2 = torch.rand(S, device=dev, generator=gen) + 0.5
    ls = torch.rand(S, device=dev, generator=gen) + 0.1
    K, K_ref = ck.rbf_cuda(x1, x2, s2, ls), ck.rbf_plain(x1, x2, s2, ls)
    torch.cuda.synchronize()
    errs.append(float((K - K_ref).abs().max()))
    check(float(((K - K_ref).abs() - 1e-5 * K_ref.abs() - 1e-30).max()) <= 0.0,
          f"rbf ({S},{n},{m}), more pairs than a grid dimension holds: max|K-plain| "
          f"{errs[-1]:.3e}, rtol 1e-5")
    return max(errs), rows


def ecog_lists():
    """The ECoG-width synthetic data (`drivers/multidevice_check.ecog_lists`):
    78 outputs, each on the time axis 0..799, y = sin(t / 40)."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
        multidevice_check,
    )

    return multidevice_check.ecog_lists(D_ECOG)


def pm25_data(dev):
    """The PM2.5-sub-width synthetic data (bench.py:110-123): D=6, N=28,768
    sorted inputs in [0, 1), random outputs, y = sin(7 x) + noise."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.random(N_PM)).astype(np.float32)
    idx = rng.integers(0, D_PM, N_PM)
    y = (np.sin(7 * x) + 0.1 * rng.standard_normal(N_PM)).astype(np.float32)
    T = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    return T(x), T(y), T(idx, torch.int64), torch.linspace(0.0, 1.0, M_PM, device=dev)


def step_closure(td, tc, x, y, idx, Z, D, B, seed=0):
    """One DSVI step on a batch of B rows drawn on the device, with fresh
    noise, as `inference()` takes it (Adam, lr 0.005, length scales
    frozen), from `init_params` with `seed`."""
    dev, M = x.device, Z.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tc.init_params(gen, D, M, device=dev)
    params = tc.CNMGPParams(*(t.requires_grad_(True) for t in params))
    step = td.make_train_step(td.make_optimizer(params, "adam", 0.005), float(x.shape[0]))
    mask = td.freeze_mask(params, True)
    w = torch.ones(B, device=dev)

    def one():
        sel = torch.randint(x.shape[0], (B,), device=dev, generator=gen)
        noise = tc.draw_train_noise(gen, 1, M, B, D)
        return step(params, mask, Z, x[sel], y[sel], idx[sel], w, noise)

    return one


def time_steps(one, n=TRAIN_STEPS):
    """(median ms of a step synced alone, steps/s of n steps back to back,
    their losses)."""
    for _ in range(3):
        one()
    torch.cuda.synchronize()
    per = []
    for _ in range(n):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        per.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    losses = torch.stack([one() for _ in range(n)])
    torch.cuda.synchronize()
    return float(np.median(per)), n / (time.perf_counter() - t0), losses


def training_rates(ck, td, tc, name, data, D, B):
    """Steps/s and median step time with the kernels and with the plain
    versions, in turns kernels, plain, plain, kernels."""
    x, y, idx, Z = data
    res = {}
    for route in ("kernels", "plain", "plain", "kernels"):
        with ck.plain_versions() if route == "plain" else ExitStack():
            med, rate, losses = time_steps(step_closure(td, tc, x, y, idx, Z, D, B))
        check(bool(torch.isfinite(losses).all()), f"{name} {route}: {TRAIN_STEPS} finite losses")
        res.setdefault(route, []).append((med, rate))
        print(f"train {name} ({route}): {rate:.2f} steps/s back to back, median step "
              f"{med:.3f} ms synced, over {TRAIN_STEPS} steps")
    return res


def ecog_problem(x, y, idx, Z, gen):
    """The ECoG gradient check's problem at ECoG width
    (`drivers/multidevice_check.ecog_problem`, which the data-parallel
    ranks take too): returns grads(dtype, order) -> (loss, every
    parameter's gradient) and the three row orders."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
        multidevice_check,
    )

    prob = multidevice_check.ecog_problem(x, y, idx, Z, gen, D_ECOG, B_ECOG)
    return prob.grads, prob.orders


def ecog_grad_tol(plain_errs):
    """The ECoG gradient gates' tolerance, of max: 3x the worst plain f32
    error of the three row orders + 1e-5."""
    return 3 * max(plain_errs) + 1e-5


def ecog_gradients(ck, tc, x, y, idx, Z, gen):
    """Every parameter's gradient on one batch and one noise draw, with the
    lengthscales set to 40 (dense priors), kernels and plain versions in f32
    against the plain versions in float64.  A scalar hyperparameter's
    gradient is a sum of many large terms that cancel, so one f32 run's
    error is a noisy witness: the batch rows (and their noise) are also
    taken in two other orders, the same sum rounded otherwise, and the
    kernels' error may be at most 3x the worst plain error of the three
    orders + 1e-5 of max."""
    grads, orders = ecog_problem(x, y, idx, Z, gen)
    ck.reset_launches()
    runs_k = [grads(torch.float32, o) for o in orders]
    torch.cuda.synchronize()
    launched = dict(ck.LAUNCHES)
    with ck.plain_versions():
        runs_p = [grads(torch.float32, o) for o in orders]
    ck.reset_launches()  # float64 takes the plain versions by the dispatch rule
    loss_64, g_64 = grads(torch.float64, orders[0])
    torch.cuda.synchronize()
    check(all(launched[k] > 0 for k in TRAIN_KERNELS) and sum(ck.LAUNCHES.values()) == 0,
          f"ECoG gradient: three float32 loss.backward() launched {launched}; the float64 one "
          f"{dict(ck.LAUNCHES)}")
    print(f"ECoG gradient batch: loss kernels {runs_k[0][0]:.6e}, plain {runs_p[0][0]:.6e}, "
          f"float64 {loss_64:.6e}")
    worst = 0.0
    for i, (name, g64) in enumerate(zip(tc.CNMGPParams._fields, g_64)):
        errs_k = [rel_to_max(r[1][i], g64)[1] for r in runs_k]
        errs_p = [rel_to_max(r[1][i], g64)[1] for r in runs_p]
        tol = ecog_grad_tol(errs_p)
        worst = max(worst, errs_k[0] / tol)
        check(errs_k[0] <= tol,
              f"grad {name} vs float64, of max: kernels {errs_k[0]:.3e} (other orders "
              f"{errs_k[1]:.3e}, {errs_k[2]:.3e}), plain " + ", ".join(f"{e:.3e}" for e in errs_p)
              + "; tol 3x the worst plain + 1e-5")
    print(f"ECoG gradients: worst kernel error / tolerance {worst:.3f}")


def small_problem(tc, dev, seed):
    """The small model of `tests/test_torch_cuda.py::
    test_negative_selbo_backward_on_the_card_matches_plain` (D=3, M=12,
    B=40), drawn as that test draws it from a generator seeded `seed` (the
    test's own draw is seed 0).  Returns grads(dtype, witness=False) ->
    every parameter's gradient; with `witness`, also the test's float64
    witness of each: the largest entry of the prior stack's vector-Jacobian
    product toward the parameter with cotangent |fl32(dK) - dK|."""
    D, M, B = 3, 12, 40
    g = torch.Generator(device=dev).manual_seed(seed)
    params = tc.init_params(g, D, M, device=dev)
    params = params._replace(
        mu_v=torch.full((M,), -1.5, device=dev),
        length_scales_tildeell_log=torch.tensor(-1.5, device=dev),
        length_scales_L0_log=torch.tensor(-1.2, device=dev),
        length_scales_L1_log=torch.tensor(-1.0, device=dev),
    )
    Z = torch.linspace(0.0, 1.0, M, device=dev)
    x = torch.rand(B, device=dev, generator=g)
    idx = torch.randint(0, D, (B,), device=dev, generator=g)
    y = torch.sin(6 * x)
    w = torch.ones(B, device=dev)
    noise = tc.draw_train_noise(g, 1, M, B, D)

    def grads(dtype, witness=False):
        p = tc.CNMGPParams(*(t.detach().to(dtype).clone().requires_grad_(True) for t in params))
        nz = tc.CNMGPNoise(*(None if z is None else z.to(dtype) for z in noise))
        stacks = []

        def keep(factor):
            def run(K, *args):
                stacks.append(K)
                return factor(K, *args)
            return run

        with mock.patch.object(tc, "chol_tri_inv", keep(tc.chol_tri_inv)), \
                mock.patch.object(tc, "chol_tri_inv_robust", keep(tc.chol_tri_inv_robust)):
            loss = tc.negative_selbo(p, Z.to(dtype), x.to(dtype), y.to(dtype), idx,
                                     w.to(dtype), 1000.0, nz)
        if not witness:
            loss.backward()
            return [t.grad for t in p]
        (K,) = stacks
        dK, *got = torch.autograd.grad(loss, (K, *p), retain_graph=True)
        moved = torch.autograd.grad(K, tuple(p), (dK.float().double() - dK).abs(),
                                    allow_unused=True)
        return got, np.array([0.0 if m is None else float(m.abs().max()) for m in moved])

    return grads


# The chol_inv witness study: ten draws of each witness, each from a
# generator of its own (seeds WITNESS_SEED + draw for ECoG, draw for the
# small model), so that no other check of this script changes its inputs.
WITNESS_DRAWS = 10
WITNESS_SEED = 100


def witness_routes(ck):
    """The study's routes, each a context that sends kernel wrappers to
    their plain versions: none, all, only chol_inv, all but chol_inv; then,
    with every other kernel plain, chol_inv's L with L^-1 solved from it by
    the library (`solve_triangular`), and the library's L with the kernel's
    L^-1, which tell which of the two outputs carries a fault."""
    others = tuple(k for k in ck.KERNELS if k != "chol_inv")
    kernel = ck.chol_inv_cuda

    def l_only(K):
        L = kernel(K)[0]
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        return L, torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)

    def linv_only(K):
        return ck.chol_inv_plain(K)[0], kernel(K)[1]

    @contextmanager
    def hybrid(fn):
        with ck.plain_versions(others), mock.patch.object(ck, "chol_inv_cuda", fn):
            yield

    return {"kernels": lambda: ck.plain_versions(()),
            "plain": lambda: ck.plain_versions(),
            "chol_inv plain": lambda: ck.plain_versions(("chol_inv",)),
            "chol_inv kernel": lambda: ck.plain_versions(others),
            "kernel L": lambda: hybrid(l_only),
            "kernel L^-1": lambda: hybrid(linv_only)}


def factor_errors(ck, K):
    """(L, L^-1) of the f32 stack K by the kernel and by cuSOLVER's f32
    (`chol_inv_plain`), each against float64 factors of the same f32 input:
    {route: (L error of max, L^-1 error of max, max |L^-1 L - I|, the share
    of L's and of L^-1's lower-triangle entries equal to the library's bit
    for bit)} over the members float64 factors."""
    K = K.reshape(-1, K.shape[-1], K.shape[-1])
    L64, Li64 = ck.chol_inv_plain(K.double())
    ok = torch.isfinite(Li64).flatten(1).all(1)
    eye = torch.eye(K.shape[-1], dtype=torch.float64, device=K.device)
    lower = torch.ones_like(eye, dtype=torch.bool).tril().expand(int(ok.sum()), -1, -1)
    Lp, Lip = (t[ok] for t in ck.chol_inv_plain(K))
    out = {}
    for route, fn in (("kernel", ck.chol_inv_cuda), ("cuSOLVER", ck.chol_inv_plain)):
        L, Li = fn(K)
        L, Li = L[ok], Li[ok]
        out[route] = (rel_to_max(L, L64[ok])[1], rel_to_max(Li, Li64[ok])[1],
                      float((Li.double() @ L.double() - eye).abs().max()),
                      float((L == Lp)[lower].float().mean()), float((Li == Lip)[lower].float().mean()))
    return out


def _worst(ratios, fields):
    i = int(np.argmax(ratios))
    return float(ratios[i]), fields[i]


def chol_inv_witness(ck, tc, dev, smi):
    """The study of chol_inv's factor rounding.  Witness (a) is the ECoG gradient
    gate (`ecog_gradients`: lengthscales 40, three row orders, tolerance 3x
    the worst plain error + 1e-5 of max), witness (b) the card test's small
    model (D=3, M=12, B=40, tolerance 3x the larger of the plain error and
    the test's float64 witness, + 1e-5 of max).
    Each draw runs every route of `witness_routes` and prints each route's
    worst parameter error / tolerance, then the factor alone on the draw's
    prior stack (the first input chol_inv gets) against float64, for the
    kernel and for cuSOLVER.  Gate: the kernels pass witness (a) at every
    draw, and witness (b) at the test's own draw; a failing draw that fails
    as much (0.9x or more, and above 1) with only chol_inv sent to its plain
    version is noise from another kernel and is reported, not counted.
    Returns a summary for the kernels line."""
    fields = tc.CNMGPParams._fields
    routes = witness_routes(ck)
    x, y, idx, Z = ecog_data(dev, M_ECOG)
    summary = {}
    print(f"chol_inv witness ({smi}): per draw, each route's worst gradient error / tolerance "
          f"(parameter), then the factor alone vs float64, of max, kernel / cuSOLVER f32")
    t0 = time.perf_counter()
    for witness in ("a", "b"):
        worst = {r: 0.0 for r in routes}
        failed, excused, factor = [], [], {"kernel": [0.0] * 3, "cuSOLVER": [0.0] * 3}
        equal = [1.0, 1.0]
        for d in range(WITNESS_DRAWS):
            calls = {}
            if witness == "a":
                gen = torch.Generator(device=dev).manual_seed(WITNESS_SEED + d)
                grads_o, orders = ecog_problem(x, y, idx, Z, gen)
                grads = lambda dtype, _g=grads_o, _o=orders: _g(dtype, _o[0])[1]  # noqa: E731
                with ck.plain_versions():
                    g_p = [grads_o(torch.float32, o)[1] for o in orders]
            else:
                grads = small_problem(tc, dev, d)
                with ck.plain_versions():
                    g_p = [grads(torch.float32)]
            if witness == "a":
                g64, wit = grads(torch.float64), 0.0
            else:
                g64, wit = grads(torch.float64, witness=True)
            scale = [float(g.abs().max()) for g in g64]
            err = lambda gs: np.array([rel_to_max(a, b)[0] for a, b in zip(gs, g64)])  # noqa: E731
            err_p = np.max([err(g) for g in g_p], axis=0)
            tol = 3 * np.maximum(err_p, wit) + 1e-5 * np.array(scale)
            ratio = {}
            for route, context in routes.items():
                if route == "plain":
                    gs = g_p[0]
                else:
                    with context(), recording(ck, ("chol_inv",) if route == "kernels" else (),
                                              calls):
                        gs = grads(torch.float32)
                ratio[route] = _worst(err(gs) / tol, fields)
                worst[route] = max(worst[route], ratio[route][0])
            fe = factor_errors(ck, calls["chol_inv"][0][0])
            for r, v in fe.items():
                factor[r] = [max(a, b) for a, b in zip(factor[r], v[:3])]
            equal = [min(a, b) for a, b in zip(equal, fe["kernel"][3:])]
            k, c = ratio["kernels"][0], ratio["chol_inv plain"][0]
            if k > 1.0:
                (excused if c > 1.0 and c >= 0.9 * k else failed).append(d)
            print(f"  witness ({witness}) draw {d}: " + ", ".join(
                f"{r} {v:.3f} ({n})" for r, (v, n) in ratio.items())
                + "; L {:.3e} / {:.3e}, L^-1 {:.3e} / {:.3e}, |L^-1 L - I| {:.3e} / {:.3e}; "
                  "the kernel's L and L^-1 equal to the library's bit for bit at {:.1%} and "
                  "{:.1%} of the entries".format(
                    fe["kernel"][0], fe["cuSOLVER"][0], fe["kernel"][1], fe["cuSOLVER"][1],
                    fe["kernel"][2], fe["cuSOLVER"][2], fe["kernel"][3], fe["kernel"][4]),
                flush=True)
        summary[witness] = {"worst": worst, "failed": failed, "excused": excused,
                            "factor_worst": factor, "least_equal": equal}
        print(f"  witness ({witness}): worst error / tolerance over {WITNESS_DRAWS} draws "
              + ", ".join(f"{r} {v:.3f}" for r, v in worst.items())
              + f"; kernels fail at draws {failed}, excused (as bad with chol_inv plain) {excused}"
              + "; factor worst kernel L {:.3e} L^-1 {:.3e} |L^-1 L - I| {:.3e}, cuSOLVER L "
                "{:.3e} L^-1 {:.3e} |L^-1 L - I| {:.3e}".format(*factor["kernel"],
                                                                 *factor["cuSOLVER"])
              + "; least share equal to the library bit for bit L {:.1%}, L^-1 {:.1%}".format(*equal))
    print(f"chol_inv witness phase {time.perf_counter() - t0:.1f} s")
    check(not summary["a"]["failed"],
          f"chol_inv witness (a), ECoG gradient gate at {WITNESS_DRAWS} draws: the kernels fail "
          f"at draws {summary['a']['failed']} (excused {summary['a']['excused']})")
    check(0 not in summary["b"]["failed"],
          "chol_inv witness (b), the card test's small model at its own draw (0): kernels pass")
    return summary


def illustration_fit(ck, td, tp, sim):
    """The fit of tests/test_dsvi_e2e.py:43-62 on the card (f32): 150
    full-batch epochs of sim_illustration_low_freq(seed=22), M=10, the
    length scales frozen, ELBO every 50 epochs over 30 draws; held to the
    assertions of test_dsvi_e2e.py:65-117."""
    X_list, Y_list, Xt_list, Yt_list = sim.sim_illustration_low_freq(seed=22)
    ck.reset_launches()
    t0 = time.perf_counter()
    res = td.inference(X_list, Y_list, np.linspace(0, 1, 10), batch_size=0, dim_outputs=2,
                       lr=0.01, itnum=150, hyperpars=HYPERPARS, fix_hyperpars=True, seed=0,
                       show_ELBO=True, elbo_every=50, elbo_samples=30)
    fit_s = time.perf_counter() - t0
    losses = np.asarray(res.loss_list)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    replayed = sum(ck.REPLAYED.values())
    check(bool(np.all(np.isfinite(losses))) and last < 0.5 * first and replayed > 0,
          f"illustration fit {fit_s:.2f} s through the graphs of make_scan_epochs ({replayed} "
          f"replayed launches), launches {dict(ck.LAUNCHES)}: mean loss of the first "
          f"10 epochs {first:.4f}, of the last 10 {last:.4f} (must halve)")
    check(res.elbo_trace[-1] > res.elbo_trace[0], f"illustration ELBO rises: {res.elbo_trace}")
    p = res.params
    check(float(p.length_scales_L0_log) == 2.0 and float(p.length_scales_L1_log) == 2.0
          and float(p.length_scales_tildeell_log) == 0.0 and float(p.sigma2_err_log) != -2.0,
          "illustration: frozen length scales exact, sigma2_err_log moved "
          f"({float(p.sigma2_err_log):.4f})")
    y_test = np.concatenate([np.ravel(yt) for yt in Yt_list])
    ys = tp.sample_Y(p, res.Z, Xt_list, n_sample=50, seed=0)[0].cpu().numpy()
    rmse = float(np.sqrt(np.mean((ys.mean(0) - y_test) ** 2)))
    check(rmse < float(np.std(y_test)),
          f"illustration sample_Y x50: rmse {rmse:.4f} < std(y_test) {np.std(y_test):.4f}")
    est = tp.predict_Y(p, res.Z, Xt_list).cpu().numpy()
    ys400 = tp.sample_Y(p, res.Z, Xt_list, n_sample=400, seed=1)[0].cpu().numpy()
    corr = float(np.corrcoef(est, ys400.mean(0))[0, 1])
    check(corr > 0.9, f"illustration predict_Y vs mean of 400 draws: corr {corr:.4f} > 0.9")


def training(ck, td, tc, tp, sim, dev, gen, smi):
    """The training phases; returns the launches of one ECoG epoch."""
    torch.cuda.reset_peak_memory_stats()
    X_list, Y_list = ecog_lists()
    ck.reset_launches()
    t0 = time.perf_counter()
    res = td.inference(X_list, Y_list, np.linspace(0.0, 800.0, M_ECOG), batch_size=B_ECOG,
                       dim_outputs=D_ECOG, lr=0.005, itnum=1, seed=0, show_ELBO=False)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launched = dict(ck.LAUNCHES)
    losses = np.asarray(res.loss_list)
    check(all(launched[k] > 0 for k in TRAIN_KERNELS) and bool(np.all(np.isfinite(losses))),
          f"ECoG epoch by inference() (D=78, N=62,400, M=100, B=512, {len(losses)} steps, "
          f"{epoch_s:.2f} s with set-up): finite losses {losses[0]:.4e} .. {losses[-1]:.4e}, "
          f"launches {launched}")
    print(f"peak device memory of the ECoG epoch {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    data = ecog_data(dev, M_ECOG)
    ecog_gradients(ck, tc, *data, gen)
    rates = {"ECoG": training_rates(ck, td, tc, "ECoG D=78 M=100 B=512", data, D_ECOG, B_ECOG)}
    one = step_closure(td, tc, *data, D_ECOG, B_ECOG)
    print(f"profile of one ECoG training step ({smi}):")
    profile_breakdown(one)
    rates["PM2.5-sub"] = training_rates(ck, td, tc, "PM2.5-sub D=6 M=100 B=2000", pm25_data(dev),
                                        D_PM, B_PM)
    print("profile of one PM2.5-sub training step:")
    profile_breakdown(step_closure(td, tc, *pm25_data(dev), D_PM, B_PM))
    for cell, r in rates.items():
        k = [rate for _, rate in r["kernels"]]
        pl = [rate for _, rate in r["plain"]]
        print(f"train {cell}: kernels {k[0]:.2f} / {k[1]:.2f} steps/s, plain versions "
              f"{pl[0]:.2f} / {pl[1]:.2f} steps/s ({smi})")
    illustration_fit(ck, td, tp, sim)
    return launched

def ecog_data(dev, M):
    """The flat ECoG training data on the card and Z = linspace(0, 800, M)
    (`drivers/multidevice_check.ecog_data`)."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
        multidevice_check,
    )

    return multidevice_check.ecog_data(dev, D_ECOG, M)


# The fused trainer's phase: graph against eager at ECoG width, the rates
# of the three training shapes, and `inference()` on the graph.
SCAN_PARITY_EPOCHS = 2
SCAN_SHAPES = (("ECoG D=78 M=100 B=512", D_ECOG, M_ECOG, B_ECOG, 1),
               ("ECoG D=78 M=200 B=512", D_ECOG, M_ECOG200, B_ECOG, 1),
               ("PM2.5-sub D=6 M=100 B=2000", D_PM, M_PM, B_PM, 4))


def scan_trainer(td, tc, data, D, B, dtype=torch.float32, seed=0, mesh=None):
    """A fresh `make_scan_epochs` trainer as `inference()` builds it (Adam,
    lr 0.005, the length scales frozen) over `init_params` with `seed`, on
    the flat data (x, y, idx, Z) cast to `dtype`, data-parallel over
    `mesh` if given.  Returns (run, params, mask, (Z, x, y, idx), batches
    an epoch)."""
    x, y, idx, Z = data
    x, y, Z = (t.to(dtype) for t in (x, y, Z))
    dev, n = x.device, x.shape[0]
    params = tc.init_params(torch.Generator(device=dev).manual_seed(seed), D, Z.shape[0],
                            dtype=dtype, device=dev)
    params = tc.CNMGPParams(*(t.requires_grad_(True) for t in params))
    nb = -(-n // B)
    run = td.make_scan_epochs(td.make_optimizer(params, "adam", 0.005), float(n), JITTER, nb, B,
                              mesh=mesh)
    return run, params, td.freeze_mask(params, True), (Z, x, y, idx), nb


def scan_parity(ck, td, tc, data, D, B, dtype, tol, smi):
    """SCAN_PARITY_EPOCHS graphed epochs against as many epochs of the eager
    body, from the same parameters, optimizer state and generator state:
    the losses and every parameter within `tol` relative (the same kernels
    in the same order: equality expected).  Returns (the kernel launches a
    step replay makes, the launches counted, batches an epoch)."""
    run, p_g, mask, (Z, x, y, idx), nb = scan_trainer(td, tc, data, D, B, dtype)
    run_e, p_e, _, _, _ = scan_trainer(td, tc, data, D, B, dtype)
    dev, M, E = x.device, Z.shape[0], SCAN_PARITY_EPOCHS
    ck.reset_launches()
    t0 = time.perf_counter()
    lg = run(p_g, mask, Z, x, y, idx, torch.Generator(device=dev).manual_seed(1), E)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(ck.LAUNCHES)
    (graphs,) = run.graphs.values()
    capture_s, step_launches = graphs.capture_s, graphs.step_launches
    del graphs, run  # the graphs hold the model and its optimizer state
    draws = td.EpochDraws(torch.Generator(device=dev).manual_seed(1), M, B, D, dtype)
    le = torch.cat([td._eager_epoch(run_e.step, p_e, mask, Z, x, y, idx, draws, nb, B)
                    for _ in range(E)])
    torch.cuda.synchronize()
    gap_l = float(((lg.double() - le.double()).abs() / le.double().abs()).max())
    gap_p = max(rel_to_max(a.detach(), b.detach())[1] for a, b in zip(p_g, p_e))
    check(bool(torch.isfinite(lg).all()) and max(gap_l, gap_p) <= tol,
          f"scan_epochs {dtype} D={D} M={M} B={B}: {E} graphed epochs ({E * nb} steps, "
          f"{wall:.2f} s with the capture's {capture_s:.2f} s) against the eager body: "
          f"largest relative gap losses {gap_l:.3e}, parameters {gap_p:.3e} (of max), tol {tol:g} "
          f"({smi})")
    return step_launches, launched, nb


def scan_rates(ck, td, tc, name, data, D, B, per_turn, smi):
    """Steps/s of the graphed epochs against the eager `make_train_step`
    epoch body on the same trainer, in turns graph, eager, eager, graph, of
    `per_turn` epochs each, with the kernels; the capture's seconds, the
    graph pools' memory and the peak; the device busy share of a replayed
    epoch (its CUDA-event device time, the host's enqueue hidden, over the
    host wall of a graphed epoch).  Returns the launches."""
    run, params, mask, (Z, x, y, idx), nb = scan_trainer(td, tc, data, D, B)
    dev, M = x.device, Z.shape[0]
    draws = td.EpochDraws(torch.Generator(device=dev).manual_seed(2), M, B, D, torch.float32)
    ck.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    run(params, mask, Z, x, y, idx, draws, 1)  # the capture, then one epoch
    torch.cuda.synchronize()
    (graphs,) = run.graphs.values()
    peak = torch.cuda.max_memory_allocated() / 2**30
    turns = {
        "graph": lambda: run(params, mask, Z, x, y, idx, draws, per_turn),
        "eager": lambda: torch.cat([td._eager_epoch(run.step, params, mask, Z, x, y, idx, draws,
                                                    nb, B) for _ in range(per_turn)]),
    }
    rates = {}
    for route in ("graph", "eager", "eager", "graph"):
        t0 = time.perf_counter()
        losses = turns[route]()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(bool(torch.isfinite(losses).all()), f"scan rates {name} ({route}): finite losses")
        rates.setdefault(route, []).append(per_turn * nb / wall)
    epoch_ms = device_ms(lambda: run(params, mask, Z, x, y, idx, draws, 1), reps=1)
    wall_ms = 1e3 * nb / max(rates["graph"])
    launched = dict(ck.LAUNCHES)
    g, e = rates["graph"], rates["eager"]
    print(f"scan {name}: graph {g[0]:.2f} / {g[1]:.2f} steps/s, eager make_train_step "
          f"{e[0]:.2f} / {e[1]:.2f} steps/s ({per_turn * nb} steps a turn, turns graph, eager, "
          f"eager, graph); a replayed epoch {epoch_ms:.2f} ms on the device "
          f"({epoch_ms / nb:.3f} ms a step), busy {epoch_ms / wall_ms:.1%} of its host wall; "
          f"capture {graphs.capture_s:.2f} s, graph pools {graphs.pool_bytes / 2**30:.3f} GiB, "
          f"peak {peak:.2f} GiB; {sum(graphs.step_launches.values())} port kernels a step "
          f"({smi})")
    return launched


def scan_epochs_phase(ck, td, tc, dev, smi):
    """The fused trainer on the card: (a) graph against eager at ECoG width
    in float32 with the kernels (all five in the step graph, each launch
    counted at every replay) and in float64 through the plain versions;
    (b) steps/s of the graph against the eager step at the three training
    shapes; (c) `inference()`'s fast path on the graph at ECoG width, a
    rollback of epoch 1 forced once at factor 1 giving the unguarded
    losses bit for bit.  Returns the launches of the phase."""
    launched = {k: 0 for k in ck.KERNELS}

    def add(counts):
        for k in ck.KERNELS:
            launched[k] += counts[k]

    ecog = ecog_data(dev, M_ECOG)
    step_launches, counts, nb = scan_parity(ck, td, tc, ecog, D_ECOG, B_ECOG, torch.float32,
                                            1e-5, smi)
    add(counts)
    per_epoch = {k: n * nb for k, n in step_launches.items()}
    check(all(step_launches[k] > 0 for k in TRAIN_KERNELS)
          and all(counts[k] >= SCAN_PARITY_EPOCHS * per_epoch[k] for k in ck.KERNELS),
          f"scan_epochs: the step graph holds all five DSVI kernels; launches a replayed ECoG "
          f"epoch ({nb} step replays, the capture's count a step times {nb}): {per_epoch}")
    step64, counts64, _ = scan_parity(ck, td, tc, ecog, D_ECOG, B_ECOG, torch.float64, 1e-12, smi)
    check(sum(counts64.values()) == 0 and sum(step64.values()) == 0,
          f"scan_epochs float64: the plain versions, no kernel launched ({counts64})")

    for name, D, M, B, per_turn in SCAN_SHAPES:
        data = ecog_data(dev, M) if D == D_ECOG else pm25_data(dev)
        add(scan_rates(ck, td, tc, name, data, D, B, per_turn, smi))

    X_list, Y_list = ecog_lists()
    kw = dict(batch_size=B_ECOG, dim_outputs=D_ECOG, lr=0.005, itnum=2, seed=0, show_ELBO=False)
    real, seen = td._diverged, []

    def diverged_at_epoch_1_once(losses, n_before):
        seen.append(n_before)
        return len(seen) == 2 or real(losses, n_before)

    Zn = np.linspace(0.0, 800.0, M_ECOG)
    ck.reset_launches()
    with mock.patch.object(td, "_diverged", diverged_at_epoch_1_once):
        guarded = td.inference(X_list, Y_list, Zn, divergence_rollback=True,
                               rollback_lr_factor=1.0, **kw)
    replayed = sum(ck.REPLAYED.values())
    add(ck.LAUNCHES)
    ck.reset_launches()
    base = td.inference(X_list, Y_list, Zn, **kw)
    add(ck.LAUNCHES)
    check(guarded.rollbacks == 1 and seen == [0, nb, nb] and replayed > 0
          and guarded.loss_list == base.loss_list,
          f"scan_epochs inference() at ECoG width on the graph ({replayed} replayed launches): a "
          f"rollback of epoch 1 forced once at factor 1 gives the unguarded run's "
          f"{len(base.loss_list)} losses bit for bit")
    return launched


def ecog_m200(ck, td, tc, dev, smi):
    """The ECoG configuration the reference runs at M = 200 inducing points
    (D=78, B=512, Z = linspace(0, 800, 200)): one `inference()` epoch from
    `init_params`, the DSVI kernels of M = 200 (TRAIN_KERNELS_M200)
    launched and the losses finite,
    then steps/s with the kernels and the plain versions in turns.  Returns
    the epoch's launches."""
    X_list, Y_list = ecog_lists()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    t0 = time.perf_counter()
    res = td.inference(X_list, Y_list, np.linspace(0.0, 800.0, M_ECOG200), batch_size=B_ECOG,
                       dim_outputs=D_ECOG, lr=0.005, itnum=1, seed=0, show_ELBO=False)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launched = dict(ck.LAUNCHES)
    losses = np.asarray(res.loss_list)
    check(all(launched[k] > 0 for k in TRAIN_KERNELS_M200) and bool(np.all(np.isfinite(losses))),
          f"ECoG M=200 epoch by inference() (D=78, N=62,400, M=200, B=512, {len(losses)} steps, "
          f"{epoch_s:.2f} s with set-up): finite losses {losses[0]:.4e} .. {losses[-1]:.4e}, "
          f"launches {launched}")
    print(f"peak device memory of the ECoG M=200 epoch "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rates = training_rates(ck, td, tc, "ECoG D=78 M=200 B=512", ecog_data(dev, M_ECOG200),
                           D_ECOG, B_ECOG)
    k = [rate for _, rate in rates["kernels"]]
    pl = [rate for _, rate in rates["plain"]]
    print(f"train ECoG M=200: kernels {k[0]:.2f} / {k[1]:.2f} steps/s, plain versions "
          f"{pl[0]:.2f} / {pl[1]:.2f} steps/s ({smi})")
    return launched

def dsvi_options(ck, td, sim, dev, smi, ckpt, optimizers):
    """The options of `inference()` beyond plain training, on the card.
    (a) A forced divergence (tests/test_dsvi_e2e.py:388-430): M = 8, B =
    64, lr 30 on sim_illustration_low_freq(seed=22) with
    `divergence_rollback` takes a rollback and keeps only finite losses; at
    lr 0.01 the guarded and unguarded losses agree.  (b) ECoG width, one
    epoch with the test RMSE every step on 512 held-out points and one
    with `chunked_test_trace`: the same final RMSE.  (c) The checkpoint at
    ECoG width: one epoch saved, one resumed (its first loss below 0.7x the
    fresh first loss, the JAX test's criterion), and where ml_dtypes
    imports a bf16-moment save, under 0.75x the float32 file, whose
    moments come back within 2^-8.  Returns the launches of the runs."""
    launched = {k: 0 for k in ck.KERNELS}

    def run(*args, **kw):
        ck.reset_launches()
        t0 = time.perf_counter()
        res = td.inference(*args, show_ELBO=False, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ck.LAUNCHES)
        for k in ck.KERNELS:
            launched[k] += counts[k]
        return res, wall, counts

    # (a) the forced divergence
    X, Y, _, _ = sim.sim_illustration_low_freq(seed=22)
    z = np.linspace(0, 1, 8)
    bad, wall, counts = run(X, Y, z, 64, 2, itnum=8, lr=30.0, divergence_rollback=True,
                            max_rollbacks=4)
    losses = np.asarray(bad.loss_list)
    check(bad.rollbacks >= 1 and losses.size == 8 * 4 and bool(np.all(np.isfinite(losses))),
          f"dsvi_options (a) lr 30, divergence_rollback: {bad.rollbacks} rollback(s), "
          f"{losses.size} kept losses, all finite ({wall:.2f} s, {smi}; launches {counts})")
    ok_g = run(X, Y, z, 64, 2, itnum=6, lr=0.01, divergence_rollback=True)[0]
    ok_u = run(X, Y, z, 64, 2, itnum=6, lr=0.01)[0]
    rel = float(np.max(np.abs(np.asarray(ok_g.loss_list) - ok_u.loss_list) / np.abs(ok_u.loss_list)))
    check(ok_g.rollbacks == 0 and rel <= 1e-5,
          f"dsvi_options (a) lr 0.01: guarded and unguarded losses agree to {rel:.2e} (rtol 1e-5), "
          f"{ok_g.rollbacks} rollbacks")

    # (b) the test trace at ECoG width
    X_list, Y_list = ecog_lists()
    Xt = ecog_request(5)
    Yt = [np.sin(t / 40.0) for t in Xt]
    Z = np.linspace(0.0, 800.0, M_ECOG)
    ecog = dict(batch_size=B_ECOG, dim_outputs=D_ECOG, lr=0.005, itnum=1, seed=0)
    final = {}
    for mode, extra in (("per step", {}), ("chunked", {"chunked_test_trace": True})):
        res, wall, counts = run(X_list, Y_list, Z, X_test_list=Xt, Y_test_list=Yt, **ecog, **extra)
        steps = len(res.loss_list)
        final[mode] = res.rmse_test_list[-1]
        check(counts["rbf"] > 0 and all(counts[k] > 0 for k in TRAIN_KERNELS)
              and bool(np.all(np.isfinite(res.rmse_test_list))),
              f"dsvi_options (b) ECoG epoch, test RMSE {mode}: {steps / wall:.2f} steps/s "
              f"({steps} steps, {wall:.2f} s with set-up), {len(res.rmse_test_list)} RMSEs, "
              f"{len(res.rmse_trace)} trace entries, final RMSE {final[mode]:.6f}, rbf launches "
              f"{counts['rbf']}; launches {counts} ({smi})")
    rel = abs(final["chunked"] - final["per step"]) / abs(final["per step"])
    check(rel <= 1e-5, f"dsvi_options (b) final RMSE, chunked and per step: {rel:.2e} apart (rtol 1e-5)")

    # (c) the checkpoint round trip at ECoG width
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="ckpt-", dir=build))
    try:
        path = str(work / "ecog.pkl")
        fresh, _, _ = run(X_list, Y_list, Z, PATH=path, save_model=True, **ecog)
        save_s, size = ckpt.LAST_IO_SECONDS["save"], os.path.getsize(path)
        resumed, _, _ = run(X_list, Y_list, Z, PATH=path, continuous_training=True, **ecog)
        replayed = sum(ck.REPLAYED.values())
        check(resumed.loss_list[0] < 0.7 * fresh.loss_list[0] and replayed > 0,
              f"dsvi_options (c) ECoG checkpoint, resumed on the graphs of make_scan_epochs "
              f"({replayed} replayed launches): {size} bytes, save {save_s:.3f} s, load "
              f"{ckpt.LAST_IO_SECONDS['load']:.3f} s; resumed first loss "
              f"{resumed.loss_list[0]:.4e} < 0.7x the fresh first {fresh.loss_list[0]:.4e} ({smi})")
        try:
            import ml_dtypes  # noqa: F401
        except ImportError:
            print("dsvi_options (c): ml_dtypes does not import here: the bf16-moment save is "
                  "not run (it needs ml_dtypes)")
        else:
            like_p = resumed.params
            like_o = optimizers.optax_state(td.make_optimizer(list(like_p), "adam", 0.005), like_p)
            p32, o32 = ckpt.load_train_state(path, like_p, like_o)
            half = str(work / "ecog_bf16.pkl")
            ckpt.save_train_state(half, p32, o32, moments_dtype=torch.bfloat16)
            half_size, half_s = os.path.getsize(half), ckpt.LAST_IO_SECONDS["save"]
            p16, o16 = ckpt.load_train_state(half, like_p, o32)
            same_p = all(torch.equal(a, b) for a, b in zip(p32, p16))
            worst = max(float(((b.double() - a.double()).abs() - 2**-8 * a.double().abs()).max())
                        for a, b in zip(o32, o16) if a.is_floating_point())
            check(half_size < 0.75 * size and same_p and worst <= 1e-12
                  and all(a.dtype == b.dtype for a, b in zip(o32, o16)),
                  f"dsvi_options (c) bf16 moments (ml_dtypes imports): {half_size} bytes, "
                  f"{half_size / size:.3f}x the float32 file, save {half_s:.3f} s, load "
                  f"{ckpt.LAST_IO_SECONDS['load']:.3f} s ({smi}); parameters bit for bit, moments "
                  f"within 2^-8 back in float32")
    finally:
        shutil.rmtree(work)
    return launched


# ---------------------------------------------------------------------------
# The fully-Bayesian path
# ---------------------------------------------------------------------------


def witnessed(name, got, plain, ref64, floor, shape):
    """A f32 result of a kernel against float64 on the same input: at most
    3x the plain f32 version's error (of max) + floor.  Returns max |kernel
    - plain|."""
    err_k, err_p = rel_to_max(got, ref64)[1], rel_to_max(plain, ref64)[1]
    check(err_k <= 3 * err_p + floor and bool(torch.isfinite(got).all()),
          f"{name} {shape} vs float64, of max: kernel {err_k:.3e}, plain {err_p:.3e}; "
          f"tol 3x plain + {floor:g}")
    return rel_to_max(got, plain)[0]


def fb_kernel_checks(ck, gen, dev, svc_K):
    """The four kernels of the fully-Bayesian path against float64 runs of
    their plain versions at the path's shapes, NaN semantics of the two
    factorizations, then timed.  `svc_K` is the (4, 200, 200) SVC
    covariance of the NUTS phase's init.  Returns {name: (timing row, max
    |kernel - plain|)}."""
    out = {}
    eye = lambda m: torch.eye(m, device=dev)  # noqa: E731
    # RBF: the whitening grams of the SNMGP check, two (scale, lengthscale) pairs
    N = SNMGP_N
    x = torch.sort(torch.rand(N, device=dev, generator=gen)).values
    s2 = torch.tensor([9.0, 1.0], device=dev)
    ls = torch.tensor([0.4, 0.4], device=dev)
    err = witnessed("rbf", ck.rbf_cuda(x, x, s2, ls), ck.rbf_plain(x, x, s2, ls),
                    ck.rbf_plain(x.double(), x.double(), s2.double(), ls.double()), 1e-6,
                    "(2, 1024, 1024)")
    err = max(err, witnessed("rbf", ck.rbf_cuda(x[:FB_N], x[:FB_N], 4.0, 0.4),
                             ck.rbf_plain(x[:FB_N], x[:FB_N], 4.0, 0.4),
                             ck.rbf_plain(x[:FB_N].double(), x[:FB_N].double(), 4.0, 0.4), 1e-6,
                             "(100, 100) scalar"))
    n_el = 2 * N * N
    out["rbf"] = ((lambda: ck.rbf_cuda(x, x, s2, ls), lambda: ck.rbf_plain(x, x, s2, ls), None, 5,
                   bound_ms(4 * (2 * N + 4 + n_el), 5 * n_el)), err)

    # Cholesky: the whitening factors, (2, 100, 100) and (2, 1024, 1024)
    errs = []
    for m in (FB_N, N):
        K = ck.rbf_plain(x[:m], x[:m], s2, ls) + 4.8e-5 * s2[:, None, None] * eye(m)
        L, Lp, L64 = ck.cholesky_cuda(K), ck.cholesky_plain(K), ck.cholesky_plain(K.double())
        torch.cuda.synchronize()
        errs.append(witnessed("cholesky", L, Lp, L64, 1e-6, f"(2, {m}, {m})"))
        back = rel_to_max(L.double() @ L.double().mT, K.double())[1]
        check(back <= m * EPS32, f"cholesky (2, {m}, {m}) |L L^T - K|/|K| {back:.3e}, tol M eps")
    Kbad = K.clone()
    Kbad[1, N // 3, N // 3] = -1.0
    Lb = ck.cholesky_cuda(Kbad)
    torch.cuda.synchronize()
    lower = torch.ones(N, N, dtype=torch.bool, device=dev).tril()
    check(bool(torch.isnan(Lb[1][lower]).all() and (Lb[1][~lower] == 0).all()
               and torch.isfinite(Lb[0]).all()),
          "cholesky: the non-PD member is NaN in its lower triangle, zero above; the other finite")
    # bytes: K's lower triangle read, L written; m^3/3 flops a matrix
    m = N
    out["cholesky"] = ((lambda: ck.cholesky_cuda(K), lambda: ck.cholesky_plain(K),
                        lambda: torch.linalg.cholesky_ex(K), 3,
                        bound_ms(4 * 2 * (m * (m + 1) // 2 + m * m), 2 * m**3 / 3)), max(errs))

    # (L, L^-1): the SVC covariance at M = 200, random SPD at 1024
    A = torch.randn(4, N, N, device=dev, generator=gen)
    K1024 = A @ A.mT / N + 0.05 * eye(N)
    errs = []
    for K in (svc_K, K1024):
        shape = tuple(K.shape)
        (L, Li), (Lp, Lip), (L64, Li64) = (ck.chol_inv_cuda(K), ck.chol_inv_plain(K),
                                           ck.chol_inv_plain(K.double()))
        torch.cuda.synchronize()
        errs.append(witnessed("chol_inv L", L, Lp, L64, 1e-6, shape))
        errs.append(witnessed("chol_inv L^-1", Li, Lip, Li64, 1e-6, shape))
        mm = K.shape[-1]
        back = rel_to_max(L.double() @ L.double().mT, K.double())[1]
        check(back <= mm * EPS32, f"chol_inv {shape} |L L^T - K|/|K| {back:.3e}, tol M eps")
    Kbad = svc_K.clone()
    Kbad[2] -= 10.0 * float(svc_K[2].diagonal().max()) * eye(svc_K.shape[-1])
    Lb, Lib = ck.chol_inv_cuda(Kbad)
    Lr, Lir = ck.chol_inv_plain(Kbad)
    torch.cuda.synchronize()
    check(torch.equal(torch.isnan(Lb), torch.isnan(Lr)) and torch.equal(torch.isnan(Lib), torch.isnan(Lir))
          and bool(torch.isnan(Lib[2]).all()) and bool(torch.isfinite(Lib[[0, 1, 3]]).all()),
          "chol_inv at M=200: the non-PD member NaN as the plain version has it")
    # bytes: K's lower triangle read, L and L^-1 written; m^3/3 flops each
    # for the factor and the inverse
    m, nb = svc_K.shape[-1], svc_K.shape[0]
    out["chol_inv (4,200,200)"] = ((lambda: ck.chol_inv_cuda(svc_K),
                                    lambda: ck.chol_inv_plain(svc_K), None, 5,
                                    bound_ms(4 * nb * (m * (m + 1) // 2 + 2 * m * m),
                                             nb * 2 * m**3 / 3)), max(errs))

    # Kronecker matvec: the eigen route of the SNMGP check, 4 chains, MN = 2048
    B = torch.randn(4, 2, 2, device=dev, generator=gen)
    Kk = torch.randn(4, N, N, device=dev, generator=gen)
    y = torch.randn(2 * N, device=dev, generator=gen)
    err = witnessed("kron_mv", ck.kron_mv_cuda(B, Kk, y), ck.kron_mv_plain(B, Kk, y),
                    ck.kron_mv_plain(B.double(), Kk.double(), y.double()), 1e-6, "(4, 1024) x (4, 2)")
    Y = y.reshape(2, N).T
    out["kron_mv"] = ((lambda: ck.kron_mv_cuda(B, Kk, y), lambda: ck.kron_mv_plain(B, Kk, y),
                       lambda: Kk @ Y @ B.mT, 10,
                       bound_ms(4 * (4 * N * N + 4 * 4 + 2 * N + 4 * 2 * N),
                                4 * (2 * N * N * 2 + 2 * N * 2 * 2))), err)
    return out


# The whitened factors' shapes (what, S, group sets, M): ECoG's sqrt_U
# (3003 offdiagonal + 78 diagonal groups) and sqrt_W, PM2.5-sub's (15 + 6
# and 6), a serving chunk of ECoG's sqrt_U
WHITENED_SHAPES = (("ECoG sqrt_U", 1, (3003, 78), M_ECOG), ("ECoG sqrt_W", 1, (D_ECOG,), M_ECOG),
                   ("PM2.5 sqrt_U", 1, (15, 6), M_PM), ("PM2.5 sqrt_W", 1, (D_PM,), M_PM),
                   ("ECoG sqrt_U serve", S_CHUNK, (3003, 78), M_ECOG))


def whitened_inputs(gen, dev, S, sizes, M):
    """A factor parameter (G, M, M) at the path's scale, a prior inverse
    factor (S, M, M) a set from a random SPD gram, and cotangents of every
    output (dW lower-triangular), float32."""
    X = 0.1 * torch.randn(sum(sizes), M, M, device=dev, generator=gen)
    Ps = tuple(torch.linalg.inv(torch.linalg.cholesky(_spd(gen, dev, S, M).double())).tril().float()
               for _ in sizes)
    dWs = tuple(torch.randn(S, n, M, M, device=dev, generator=gen).tril() for n in sizes)
    dtrs = tuple(torch.randn(S, n, device=dev, generator=gen) for n in sizes)
    dlds = tuple(torch.randn(n, device=dev, generator=gen) for n in sizes)
    return X, Ps, dWs, dtrs, dlds


def whitened_rows(ck, dev, smi):
    """The whitened factors' two kernels at WHITENED_SHAPES: each output and
    gradient against the float64 plain version (at most 3x the float32
    plain version's error, or 2e-6 of max), then the kernels and their plain
    versions timed, with the bytes bound at 3.35 TB/s.  The plain versions
    are the model's former composition; the backward's yardstick is that
    composition's backward alone (autograd on a kept graph, the same
    cotangents), as the plain backward runs its forward again.  Returns
    the JSON rows."""
    rows = []
    for i, (what, S, sizes, M) in enumerate(WHITENED_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(60 + i)
        X, Ps, dWs, dtrs, dlds = whitened_inputs(gen, dev, S, sizes, M)

        def run(fwd, bwd, X, Ps, dWs, dtrs, dlds):
            Ws, trs, lds = fwd(X, Ps, sizes, JITTER)
            dX, dPs = bwd(X, Ps, sizes, JITTER, Ws, dWs, dtrs, dlds)
            return [*Ws, *trs, *lds, dX, *dPs]

        got = run(ck.whitened_factors_cuda, ck.whitened_factors_bwd_cuda, X, Ps, dWs, dtrs, dlds)
        again = run(ck.whitened_factors_cuda, ck.whitened_factors_bwd_cuda, X, Ps, dWs, dtrs, dlds)
        plain = run(ck.whitened_factors_plain, ck.whitened_factors_bwd_plain, X, Ps, dWs, dtrs, dlds)
        f64 = lambda ts: tuple(t.double() for t in ts)  # noqa: E731
        ref = run(ck.whitened_factors_plain, ck.whitened_factors_bwd_plain, X.double(), f64(Ps),
                  f64(dWs), f64(dtrs), f64(dlds))
        torch.cuda.synchronize()
        errs = [(rel_to_max(a, r)[1], rel_to_max(p, r)[1]) for a, p, r in zip(got, plain, ref)]
        check(all(e <= max(3 * pe, 2e-6) for e, pe in errs)
              and all(torch.equal(a, b) for a, b in zip(got, again)),
              f"whitened factors {what} (S={S}, sets {sizes}, M={M}): kernels / f32 plain errors "
              f"against float64 {', '.join(f'{e:.2e}/{pe:.2e}' for e, pe in errs)}; two runs equal")
        G, tri = sum(sizes), M * (M + 1) // 2
        fwd_bytes = 4 * (G * M * M + len(sizes) * S * M * M + S * G * M * M + S * G + G)
        fwd_ops = 2 * S * G * M * (M + 1) * (M + 2) // 6
        bwd_bytes = 4 * (G * tri + 2 * S * G * tri + len(sizes) * S * M * M + S * G + G
                         + G * M * M + len(sizes) * S * M * M)
        bwd_ops = 2 * S * G * (M * (M + 1) * (M + 2) // 6 + M * (M + 1) * (2 * M + 1) // 6)
        Xg = X.clone().requires_grad_(True)
        Pg = tuple(P.clone().requires_grad_(True) for P in Ps)
        outs = [t for ts in ck.whitened_factors_plain(Xg, Pg, sizes, JITTER) for t in ts]
        cots = [*dWs, *dtrs, *dlds]
        rows.append(timing_entry(
            f"whitened_factors {what} forward", lambda: ck.whitened_factors_cuda(X, Ps, sizes, JITTER),
            lambda: ck.whitened_factors_plain(X, Ps, sizes, JITTER), None,
            bound_ms(fwd_bytes, fwd_ops)))
        Ws = ck.whitened_factors_cuda(X, Ps, sizes, JITTER)[0]
        rows.append(timing_entry(
            f"whitened_factors_bwd {what}",
            lambda: ck.whitened_factors_bwd_cuda(X, Ps, sizes, JITTER, Ws, dWs, dtrs, dlds),
            lambda: ck.whitened_factors_bwd_plain(X, Ps, sizes, JITTER, Ws, dWs, dtrs, dlds),
            lambda: torch.autograd.grad(outs, (Xg, *Pg), cots, retain_graph=True),
            bound_ms(bwd_bytes, bwd_ops)))
        for row in rows[-2:]:
            row.update(S=S, sets=list(sizes), M=M, card=smi)
        fwd, bwd = rows[-2], rows[-1]
        print(f"whitened factors {what}: kernels {fwd['ms'] + bwd['ms']:.4f} ms forward and "
              f"backward, the former composition {fwd['plain_ms'] + bwd['library_ms']:.4f} ms "
              f"({smi})", flush=True)
    return rows


def whitened_main() -> int:
    """The whitened factors' kernels alone, with their build (~1 min):
    python3 -u -c 'import sys, chip_smoke; sys.exit(chip_smoke.whitened_main())'"""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    for name, log in ck.build(("whitened_factors", "whitened_factors_bwd")).items():
        print(f"build {name}:\n{log}")
    print(f"max_m: {ck.max_m('whitened_factors')} forward, {ck.max_m('whitened_factors_bwd')} "
          f"backward ({smi})")
    rows = whitened_rows(ck, torch.device("cuda"), smi)
    print(json.dumps({"whitened_factors": rows}))
    for f in FAILURES:
        print("FAILED: " + f)
    return 1 if FAILURES else 0


def _spd(gen, dev, b, m):
    """b random SPD matrices of size m, condition ~1e2-1e3."""
    A = torch.randn(b, m, m, device=dev, generator=gen)
    return A @ A.mT / m + 0.05 * torch.eye(m, device=dev)


def timing_entry(what, kern, plain, lib, bound, inner=3):
    """Device times of a kernel call, its plain version and the library
    yardstick (None: no one call computes it), with the bound; printed and
    returned as a JSON-ready dict."""
    k_ms = device_ms(kern, inner=inner)
    k_b2b = back_to_back_ms(kern, inner=inner)
    p_ms = device_ms(plain, inner=inner, waits_ok=True)
    l_ms = None if lib is None else device_ms(lib, inner=inner, waits_ok=True)
    print(f"time {what}: kernel {k_ms:.4f} ms on the device ({k_b2b:.4f} ms a call back to back, "
          f"host launch included), plain {p_ms:.4f} ms, library "
          f"{'n/a' if l_ms is None else f'{l_ms:.4f} ms'}, bound {bound[0]:.4f} ms ({bound[1]}), "
          f"{bound[0] / k_ms:.1%} of bound", flush=True)
    return {"at": what, "ms": k_ms, "back_to_back_ms": k_b2b, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": bound[0], "bound_by": bound[1]}


# chol_inv's shapes, (batch, M): the DSVI prior stack of one draw, the
# serving chunk's stack, the SVC covariance, the dense Kronecker route at
# MN = 1024 (the path's largest) and 2048 (the comparison); the sizes at
# batch 4 where its two routes are compared
CHOL_INV_SHAPES = ((4, 100), (32, 100), (4, 200), (4, 1024), (4, 2048))
CHOL_INV_PATH_SHAPES = CHOL_INV_SHAPES[:4]
CHOL_INV_CROSSOVER_SIZES = (32, 64, 100, 128, 160, 200, 208, 216, 224, 240)


def chol_inv_shapes(ck, gen, dev, smi):
    """csrc/chol_inv.cu at each of CHOL_INV_SHAPES on its default route:
    (L, L^-1) against float64 factors of the same input (3x the plain f32
    error + 1e-6 of max), then timed against the plain pair (`cholesky_ex`
    + `solve_triangular`; no one library call computes both) and checked
    faster at every path shape.  Then both routes at batch 4 where the
    crossover lies.  Returns the timing entries."""
    entries = []
    for b, m in CHOL_INV_SHAPES:
        K = _spd(gen, dev, b, m)
        L, Li = ck.chol_inv_cuda(K)
        (Lp, Lip), (L64, Li64) = ck.chol_inv_plain(K), ck.chol_inv_plain(K.double())
        torch.cuda.synchronize()
        shape = f"({b}, {m}, {m}) {ck.chol_inv_route(m)}"
        witnessed("chol_inv L", L, Lp, L64, 1e-6, shape)
        witnessed("chol_inv L^-1", Li, Lip, Li64, 1e-6, shape)
        del L, Li, Lp, Lip, L64, Li64
        bound = bound_ms(4 * b * (m * (m + 1) // 2 + 2 * m * m), b * 2 * m**3 / 3)
        e = timing_entry(f"chol_inv ({b},{m},{m}) {ck.chol_inv_route(m)}",
                         lambda: ck.chol_inv_cuda(K), lambda: ck.chol_inv_plain(K), None, bound,
                         inner=3 if m <= 1024 else 1)
        entries.append(e)
        if (b, m) in CHOL_INV_PATH_SHAPES:
            check(e["ms"] < e["plain_ms"], f"chol_inv ({b},{m},{m}): kernel {e['ms']:.4f} ms "
                  f"faster than the plain pair {e['plain_ms']:.4f} ms ({smi})")
        del K
    print(f"chol_inv crossover, batch 4, device ms (host launch included) ({smi}):")
    for m in CHOL_INV_CROSSOVER_SIZES:
        K = _spd(gen, dev, 4, m)
        row = {r: (device_ms(lambda: ck.chol_inv_cuda(K, r), inner=3),
                   back_to_back_ms(lambda: ck.chol_inv_cuda(K, r), inner=3))
               for r in ck.CHOL_INV_ROUTES}
        print(f"  M={m}: " + ", ".join(f"{r} {t[0]:.4f} ({t[1]:.4f})" for r, t in row.items())
              + f"; default {ck.chol_inv_route(m)}", flush=True)
        entries.append({"at": f"crossover M={m}", **{f"{r}_ms": t[0] for r, t in row.items()}})
    return entries


def cholesky_routes(ck, gen, dev, smi):
    """csrc/cholesky.cu on each of its routes at the path's shapes (the
    dense NUTS metric (1, 401, 401), the SVC whitening (2, 100, 100), the
    SNMGP whitening (2, 1024, 1024), the dense route's (4, 2048, 2048)):
    against float64 runs of the plain version (3x the plain f32 error +
    1e-6 of max), |L L^T - K| / |K| <= M eps, and a non-PD member NaN in its
    lower triangle, zero above, the others finite; then timed.  Then both
    routes at batch 2 from M = 16 to 1024, where the default route's
    crossover lies.  Returns the timing entries."""
    entries = []
    for b, m in CHOL_SHAPES:
        K = _spd(gen, dev, b, m)
        Kbad = K.clone()
        Kbad[-1, m // 3, m // 3] = -1.0
        Lp, L64 = ck.cholesky_plain(K), ck.cholesky_plain(K.double())
        lower = torch.ones(m, m, dtype=torch.bool, device=dev).tril()
        for route in ck.CHOLESKY_ROUTES:
            L = ck.cholesky_cuda(K, route)
            torch.cuda.synchronize()
            witnessed(f"cholesky {route}", L, Lp, L64, 1e-6, f"({b}, {m}, {m})")
            print(f"  cholesky {route} ({b}, {m}, {m}): L equal to cuSOLVER's bit for bit at "
                  f"{float((L == Lp)[lower.expand(b, m, m)].float().mean()):.1%} of the entries")
            back = rel_to_max(L.double() @ L.double().mT, K.double())[1]
            check(back <= m * EPS32 and torch.equal(L, L.tril()),
                  f"cholesky {route} ({b}, {m}, {m}): |L L^T - K|/|K| {back:.3e}, tol M eps; "
                  f"zeros above the diagonal")
            Lb = ck.cholesky_cuda(Kbad, route)
            torch.cuda.synchronize()
            check(bool(torch.isnan(Lb[-1][lower]).all() and (Lb[-1][~lower] == 0).all()
                       and torch.isfinite(Lb[:-1]).all()),
                  f"cholesky {route} ({b}, {m}, {m}): the non-PD member is NaN in its lower "
                  f"triangle, zero above; the others finite")
            bound = bound_ms(4 * b * (m * (m + 1) // 2 + m * m), b * m**3 / 3)
            entries.append(timing_entry(
                f"cholesky {route} ({b},{m},{m})", lambda: ck.cholesky_cuda(K, route),
                lambda: ck.cholesky_plain(K), lambda: torch.linalg.cholesky_ex(K), bound))
        del K, Kbad, Lp, L64
    print(f"cholesky crossover, batch 2, device ms (host launch included) ({smi}):")
    for m in CHOL_CROSSOVER_SIZES:
        K = _spd(gen, dev, 2, m)
        row = {r: (device_ms(lambda: ck.cholesky_cuda(K, r), inner=3),
                   back_to_back_ms(lambda: ck.cholesky_cuda(K, r), inner=3))
               for r in ck.CHOLESKY_ROUTES}
        print(f"  M={m}: " + ", ".join(f"{r} {t[0]:.4f} ({t[1]:.4f})" for r, t in row.items())
              + f"; default {ck.cholesky_route(m)}", flush=True)
    print("profile of one cholesky call (2, 1024, 1024) on the multi-CTA route:")
    profile_breakdown(lambda: ck.cholesky_cuda(K, "multi_cta"))
    return entries


def kron_layouts(ck, gen, dev, smi):
    """csrc/kron_mv.cu on each layout of K at the SNMGP eigen route's shape
    (4 chains, N = 1024, M = 2): K as stored, a transposed view, one K
    shared by the chains, and the eigenvectors' transposes as
    `mvn_logpdf_kron` passes them (and the backward's K^T); each against
    float64 (3x the plain f32 error + 1e-6 of max), read without a copy, and
    timed beside `K @ Y @ B.mT` on the same views.  Returns the timing
    entries."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops.kron import eigh

    N, C = SNMGP_N, FB_CHAINS
    B = torch.randn(C, 2, 2, device=dev, generator=gen)
    Kk = torch.randn(C, N, N, device=dev, generator=gen)
    y = torch.randn(2 * N, device=dev, generator=gen)
    _, vK = eigh(_spd(gen, dev, C, N))
    _, vB = eigh(B @ B.mT + 0.5 * torch.eye(2, device=dev))
    cases = {
        f"rows ({C},{N},{N})": (B, Kk),
        f"transposed view ({C},{N},{N})": (B, Kk.mT),
        f"chain-shared ({N},{N}) x {C} chains": (B, Kk[0]),
        f"eigenvectors^T ({C},{N},{N}), the path's call": (vB.mT, vK.mT),
        f"eigenvectors ({C},{N},{N}), the backward's K^T": (vB, vK),
    }
    Y = y.reshape(2, N).T
    entries = []
    for what, (Bm, K) in cases.items():
        got = ck.kron_mv_cuda(Bm, K, y)
        torch.cuda.synchronize()
        witnessed("kron_mv", got, ck.kron_mv_plain(Bm, K, y),
                  ck.kron_mv_plain(Bm.double(), K.double(), y.double()), 1e-6, what)
        Kc = ck._kron_mv_operands(Bm, K, y)[0]
        check(Kc.data_ptr() == K.data_ptr(), f"kron_mv {what}: K read in place, not copied")
        k_bytes = 4 * K.numel()
        bound = bound_ms(k_bytes + 4 * (Bm.numel() + 2 * N + C * 2 * N), 2 * C * N * N * 2)
        entries.append(timing_entry(f"kron_mv {what}", lambda: ck.kron_mv_cuda(Bm, K, y),
                                    lambda: ck.kron_mv_plain(Bm, K, y), lambda: K @ Y @ Bm.mT,
                                    bound, inner=10))
    return entries


def value_grad_checks(ck, what, fns, q):
    """`fns` = {"kernels": lp, "plain": lp, "float64": lp}: value and
    gradient of each at q (f32, and q in float64 for the last; the plain
    ones with every wrapper on its plain version), the kernels' error at
    most 3x the plain f32 one against float64 + 1e-4 of max."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.hmc import (
        value_and_grad,
    )

    res = {}
    for tag, fn in fns.items():
        with ck.plain_versions() if tag != "kernels" else ExitStack():
            res[tag] = value_and_grad(fn, q.double() if tag == "float64" else q)
    torch.cuda.synchronize()
    for i, name in enumerate(("value", "gradient")):
        err_k = rel_to_max(res["kernels"][i], res["float64"][i])[1]
        err_p = rel_to_max(res["plain"][i], res["float64"][i])[1]
        check(err_k <= 3 * err_p + 1e-4 and bool(torch.isfinite(res["kernels"][i]).all()),
              f"{what} {name} ({q.shape[0]} rows) vs float64, of max: kernels {err_k:.3e}, plain "
              f"{err_p:.3e}; tol 3x plain + 1e-4")


def whitening_checks(ck, calls, what):
    """The RBF and Cholesky kernels on the inputs the path's own whitening
    factors gave them (recorded in `calls`: the prior grams with their
    jitter), each held against a float64 run of its plain version on the
    same f32 input, as `witnessed`; the factor also by its backward error."""
    f64 = lambda args: tuple(a.double() if isinstance(a, torch.Tensor) else a for a in args)  # noqa: E731
    for args in calls["rbf"]:
        got = ck.rbf_cuda(*args)
        witnessed(f"rbf, {what} whitening grams", got, ck.rbf_plain(*args),
                  ck.rbf_plain(*f64(args)), 1e-6, tuple(got.shape))
    for (K,) in calls["cholesky"]:
        L = ck.cholesky_cuda(K)
        torch.cuda.synchronize()
        witnessed(f"cholesky, {what} whitening grams", L, ck.cholesky_plain(K),
                  ck.cholesky_plain(K.double()), 1e-6, tuple(K.shape))
        back = rel_to_max(L.double() @ L.double().mT, K.double())[1]
        check(back <= K.shape[-1] * EPS32,
              f"cholesky, {what} whitening grams {tuple(K.shape)}: |L L^T - K|/|K| {back:.3e}, "
              f"tol M eps")


def fb_svc_nuts(ck, dev, smi):
    """scripts/run_mcmc_sim.py's default study through the port on the card.
    Returns (launches of the path, metrics, the (4, 200, 200) covariance at
    the init for the kernel checks, and (the density, the draws, the MAP)
    for `prediction_phase`)."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import mcmc_sim
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.hmc import (
        value_and_grad,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.map import run_map
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.nuts import run_nuts
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
        logdensities as ld,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.sharded_mcmc import (
        effective_sample_size,
        potential_scale_reduction,
    )

    prob = mcmc_sim.svc_problem(FB_N)
    h = mcmc_sim.HYPERS
    gen = torch.Generator(device=dev).manual_seed(1)

    # ---- the main path: whitening factors, then NUTS (counts from 0)
    print(f"SVC NUTS: run_mcmc_sim.py's {FB_FULL[0]} warmup and {FB_FULL[1]} samples cut to "
          f"{FB_WARMUP} and {FB_SAMPLES}, the chains started at the MAP; N={FB_N}, {FB_CHAINS} "
          f"chains, max depth {FB_DEPTH} as there", flush=True)
    t0 = time.perf_counter()

    def progress(phase, i):
        if (i + 1) % 25 == 0:
            print(f"SVC NUTS {phase} {i + 1}: {time.perf_counter() - t0:.1f} s", flush=True)

    ck.reset_launches()
    whiten_calls = {}
    with recording(ck, ("rbf", "cholesky"), whiten_calls):
        dens = mcmc_sim.svc_density(prob, dev, torch.float32)
    lp, chol_l, chol_L, init = dens["lp"], dens["chol_l"], dens["chol_L"], dens["init"]
    xt = torch.as_tensor(prob["x"], dtype=torch.float32, device=dev)
    dim = init.shape[0]
    q_map, losses = run_map(lambda q: -lp(q), torch.as_tensor(init, dtype=torch.float32,
                                                              device=dev)[None],
                            num_steps=MAP_STEPS, learning_rate=MAP_LR)
    lp_init, lp_map = -float(losses[0, 0]), -float(losses[-1, 0])
    check(math.isfinite(lp_map) and lp_map > lp_init,
          f"SVC MAP by run_map (Adam, lr {MAP_LR}, {MAP_STEPS} steps, "
          f"{time.perf_counter() - t0:.1f} s): log-posterior {lp_init:.2f} at the empirical init, "
          f"{lp_map:.2f} at the MAP")
    q0 = q_map + 0.01 * torch.randn(FB_CHAINS, dim, device=dev, generator=gen)
    samples, info = run_nuts(lp, q0, gen, num_warmup=FB_WARMUP, num_samples=FB_SAMPLES,
                             max_depth=FB_DEPTH, progress=progress)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(ck.LAUNCHES)
    need = ("gibbs", "chol_inv", "rbf", "cholesky")  # rbf, cholesky: the whitening factors
    check(all(launched[k] > 0 for k in need),
          f"SVC NUTS (N={FB_N}, dim {dim}, {FB_CHAINS} chains) launched {launched}")
    draws = samples.double().cpu().numpy()
    check(bool(np.all(np.isfinite(draws))), f"SVC NUTS: all {draws.size} draw values finite")
    rhat = potential_scale_reduction(samples.double().cpu()).numpy()
    ess = effective_sample_size(samples.double().cpu()).numpy()
    rec = mcmc_sim.recovery(dens, draws)
    n_draws = FB_CHAINS * FB_SAMPLES
    steps = info["num_steps"].double()
    metrics = dict(
        wall_s=wall, samples_per_s=n_draws / wall, ess_median=float(np.median(ess)),
        ess_min=float(ess.min()), ess_per_s=float(np.median(ess)) / wall,
        rhat_max=float(rhat.max()), rhat_median=float(np.median(rhat)),
        mean_accept=float(info["accept_prob"].mean()),
        leapfrogs_per_transition=float(steps.mean()), lockstep_passes=info["leapfrogs"],
        ms_per_lockstep_pass=1e3 * wall / max(info["leapfrogs"], 1),
        host_reads=info["host_reads"], divergent=float(info["diverging"].double().mean()),
        step_size=[round(float(e), 5) for e in info["step_size"]],
        lp_mean_per_chain=[round(float(v), 2) for v in info["log_prob"].mean(1)],
        log_sigma2_err_mean_per_chain=[round(float(v), 3) for v in samples[:, :, -1].mean(1)],
        **rec)
    print("SVC NUTS " + json.dumps(metrics) + f" ({smi})")
    check(metrics["rhat_max"] <= 1.1, f"SVC NUTS R-hat max {metrics['rhat_max']:.4f} <= 1.1")
    check(rec["rmse_tilde_l"] <= 0.25 and rec["rmse_corr"] <= 0.15,
          f"SVC NUTS recovery: tilde_l RMSE {rec['rmse_tilde_l']:.4f} <= 0.25, corr RMSE "
          f"{rec['rmse_corr']:.4f} <= 0.15")

    # ---- the whitening factors' kernels on their own grams
    whitening_checks(ck, whiten_calls, "SVC")

    # ---- lp and grad at the empirical init (as run_mcmc_sim.py:167-169
    # spreads it over the chains) and at the MAP start: kernels, plain f32,
    # plain float64, on the whitening factors of the run
    q_emp = torch.as_tensor(init, dtype=torch.float32, device=dev)[None] + 0.01 * torch.randn(
        FB_CHAINS, dim, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    fns = {tag: mcmc_sim.svc_density(prob, dev, dt, chols=(chol_l, chol_L))["lp"]
           for tag, dt in (("kernels", torch.float32), ("plain", torch.float32),
                           ("float64", torch.float64))}
    for where, q in (("the empirical init", q_emp), ("the MAP start", q0)):
        value_grad_checks(ck, f"SVC whitened log-posterior at {where}", fns, q)

    # ---- where a leapfrog's time goes
    q = samples[:, -1].contiguous()
    print(f"time of one value_and_grad of the SVC density (4 chains): "
          f"{host_ms(lambda: value_and_grad(lp, q)):.3f} ms host clock, median of 20 ({smi})")
    ck.reset_launches()
    grad_calls = {}
    with recording(ck, ("chol_inv",), grad_calls):
        v_q, _ = value_and_grad(lp, q)
    torch.cuda.synchronize()
    print(f"launches of one value_and_grad of the SVC density (4 chains): {dict(ck.LAUNCHES)}; "
          f"log-posterior {[round(float(t), 3) for t in v_q]}")
    S_q = grad_calls["chol_inv"][0][0]
    print(f"chol_inv on this gradient's {tuple(S_q.shape)} covariance: "
          f"{device_ms(lambda: ck.chol_inv_cuda(S_q), inner=3):.4f} ms on the device, plain "
          f"{device_ms(lambda: ck.chol_inv_plain(S_q), inner=3):.4f} ms ({smi})")
    print("profile of one value_and_grad (a leapfrog's gradient), 4 chains:")
    profile_breakdown(lambda: value_and_grad(lp, q), watch=("chol_inv", "gibbs"))
    with ck.plain_versions():
        print(f"the same with the plain versions: {host_ms(lambda: value_and_grad(lp, q)):.3f} ms")
    p = ld.svc_unwhiten(q0, xt, h["mu_tilde_l"], h["mu_L"], chol_l, chol_L, 2)
    K, _ = ld.svc_covariance(p.tilde_l, p.uL_vecs, xt)
    svc_K = K + torch.exp(p.tilde_sigma2_err)[:, None, None] * torch.eye(2 * FB_N, device=dev)
    return launched, metrics, svc_K, (dens, samples, q_map)


# Prediction from the SVC NUTS draws: the 200-point grid of SURVEY.md §7.2
# over the study's x range; the other families at the same width (N = 100,
# M = 2) on PRED_DRAWS draws made with NumPy from PRED_SEED around the
# simulation's truth, as tests/test_prediction.py builds its draws, the
# hadamard families on the flat form of the same data with PRED_HELD_OUT of
# it held out by the port's `data_split_non`.
PRED_GRID = 200
PRED_DRAWS = 64
PRED_SEED = 12
PRED_HELD_OUT = 0.25
# the latent hyperparameters of the SNMGP families: the study's lengthscale
# prior, chip_smoke's SNMGP sigma prior
PRED_SNMGP_HYPERS = dict(mu_tilde_l=-3.0, alpha_tilde_l=3.0, beta_tilde_l=0.4, mu_tilde_sigma=0.0,
                         alpha_tilde_sigma=1.0, beta_tilde_sigma=0.4)


def three_way(ck, what, fn, got):
    """`got` = fn(torch.float32) run with the kernels; fn again in float32
    with every wrapper on its plain version and in float64 (the plain
    versions by the dispatch rule), on the same noise: the kernels' error
    against float64 at most 3x the plain float32 one + 1e-4, both of the
    output's largest magnitude (`value_grad_checks`' rule), and every
    output finite."""
    with ck.plain_versions():
        plain, ref = fn(torch.float32), fn(torch.float64)
    torch.cuda.synchronize()
    tup = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
    got, plain, ref = tup(got), tup(plain), tup(ref)
    err_k = max(rel_to_max(a, r)[1] for a, r in zip(got, ref))
    err_p = max(rel_to_max(a, r)[1] for a, r in zip(plain, ref))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    check(err_k <= 3 * err_p + 1e-4 and finite,
          f"{what} {[tuple(a.shape) for a in got]} vs float64, of max: kernels {err_k:.3e}, "
          f"plain {err_p:.3e}; tol 3x plain + 1e-4; finite {finite}")


def band_share(draws, y):
    """The share of y (G, ...) inside the 2.5-97.5% band of draws (G, S, ...)."""
    lo, hi = (torch.quantile(draws.double(), q, dim=1) for q in (0.025, 0.975))
    y = torch.as_tensor(y, dtype=torch.float64, device=draws.device)
    return float(((y >= lo) & (y <= hi)).double().mean())


def prediction_phase(ck, dev, smi, dens, samples, q_map):
    """`models/prediction.py` on the card.  The main path: the SVC NUTS
    draws of `fb_svc_nuts` (made centered by `mcmc_sim.centered_draws`)
    through `svc_predsample` on the grid and at the study's x,
    `svc_latent_predsample` on the grid, and `svc_predmap` and
    `svc_predmap_sampling` at the centered MAP; the launches of gibbs, rbf
    and cholesky, every output against float64 (`three_way`), and the
    in-sample coverage of the draws.  Then every other entry point on
    draws around the truth, the same gates, with the held-out RMSE and
    coverage of the indexed-point predictions; the kernels at the path's
    shapes against float64 and timed; svc_predsample and svc_predmap timed
    with the kernels and the plain versions in turns, with the device's
    busy share and the launches of a call.  Returns (the launches of the
    entry points' runs, {kernel: timing rows at the path's shapes})."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import mcmc_sim
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
        prediction as pred,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
        data as tdata,
    )

    t0 = time.perf_counter()
    N, M, T = dens["N"], dens["M"], dens["T"]
    x, Y = dens["x"], dens["Y"]
    hyp = {k: v for k, v in mcmc_sim.HYPERS.items() if k not in ("a", "b")}
    dim = samples.shape[-1]
    flat = mcmc_sim.centered_draws(dens, samples.double().cpu().numpy()).reshape(-1, dim)
    hists = (flat[:, :N], flat[:, N:N + N * T], flat[:, -1])
    c_map = mcmc_sim.centered_draws(dens, q_map.double().cpu().numpy()).reshape(-1)
    map_draw = (c_map[:N], c_map[N:N + N * T], c_map[-1])
    S, G = flat.shape[0], PRED_GRID
    grid = np.linspace(x.min(), x.max(), G)
    gen = torch.Generator(device=dev).manual_seed(PRED_SEED)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)  # noqa: E731
    z_grid = pred.SVCNoise(randn(S, G), randn(S, G, T), randn(S, G, M))
    z_x = pred.SVCNoise(randn(S, N), randn(S, N, T), randn(S, N, M))
    z_lat = pred.SVCNoise(randn(S, G), randn(S, G, T))
    main = {
        "svc_predsample on the grid": lambda dt: pred.svc_predsample(
            hists, Y, x, grid, noise=z_grid, dtype=dt, **hyp),
        "svc_predsample at the study's x": lambda dt: pred.svc_predsample(
            hists, Y, x, x, noise=z_x, dtype=dt, **hyp),
        "svc_latent_predsample on the grid": lambda dt: pred.svc_latent_predsample(
            hists, x, grid, noise=z_lat, dtype=dt, **hyp),
        "svc_predmap at the MAP": lambda dt: pred.svc_predmap(
            map_draw, Y, x, grid, dtype=dt, **hyp),
        "svc_predmap_sampling at the MAP": lambda dt: pred.svc_predmap_sampling(
            S, map_draw, Y, x, grid, noise=z_grid, dtype=dt, **hyp),
    }
    print(f"prediction: the SVC NUTS run's {S} draws (N={N}, M={M}), a {G}-point grid", flush=True)
    ck.reset_launches()
    calls = {}
    with recording(ck, ("gibbs", "rbf", "cholesky"), calls):
        outs = {name: fn(torch.float32) for name, fn in main.items()}
    torch.cuda.synchronize()
    launched = dict(ck.LAUNCHES)
    check(all(launched[k] > 0 for k in ("gibbs", "rbf", "cholesky")),
          f"prediction from the SVC NUTS draws launched {launched}")
    at_x = outs["svc_predsample at the study's x"]  # (N, S, M)
    cover = band_share(at_x, Y)
    rmse = float(torch.sqrt(torch.mean((at_x.double().mean(1).cpu() - torch.as_tensor(Y)) ** 2)))
    band = outs["svc_predmap at the MAP"]
    print(f"prediction at the study's x: RMSE of the draws' mean {rmse:.4f}; the MAP band's "
          f"half width {float((band[2] - band[1]).mean()):.4f} on the grid")
    check(cover >= 0.90, f"SVC NUTS predictive: {cover:.4f} of the study's {N * M} observations "
          f"inside the 2.5-97.5% band of the draws at their x (>= 0.90)")

    # ---- every other entry point, on draws around the truth
    rng = np.random.default_rng(PRED_SEED)
    K = PRED_DRAWS
    true_tl = np.log(dens["true_l"])
    L_true = np.zeros((N, M, M))
    L_true[:, [0, 1, 1], [0, 0, 1]] = dens["true_L_vecs"].reshape(N, T)
    L_avg = np.linalg.cholesky(np.mean(L_true @ L_true.transpose(0, 2, 1), axis=0))
    lvec = L_avg[[0, 1, 1], [0, 0, 1]]
    uvec = np.where([True, False, True], np.log(np.abs(lvec)), lvec)
    ts2e = np.log(dens["true_s2e"])
    noise_ = lambda *shape: 0.05 * rng.standard_normal(shape)  # noqa: E731
    snmgp = (true_tl + noise_(K, N), noise_(K, N), uvec + noise_(K, T), ts2e + noise_(K))
    lmc = (true_tl.mean() + noise_(K), noise_(K), uvec + noise_(K, T), ts2e + noise_(K))
    xf, i_f, yf = np.tile(x, M), np.repeat(np.arange(M), N), Y.T.reshape(-1)
    x_tr, x_te, i_tr, i_te, y_tr, y_te = tdata.data_split_non(
        xf, i_f, yf, test_size=PRED_HELD_OUT, random_state=PRED_SEED)
    pos, n_tr, n_te = np.searchsorted(x, x_tr), x_tr.size, x_te.size
    had = {
        "snmgp": ((true_tl[pos] + noise_(K, n_tr), noise_(K, n_tr), lvec + noise_(K, T),
                   ts2e + noise_(K)), PRED_SNMGP_HYPERS, pred.SNMGPNoise),
        "lmc": ((true_tl.mean() + noise_(K), noise_(K), lvec + noise_(K, T), ts2e + noise_(K)), {},
                pred.LMCNoise),
        "svc": ((true_tl[pos] + noise_(K, n_tr),
                 dens["true_L_vecs"].reshape(N, T)[pos].reshape(-1) + noise_(K, n_tr * T),
                 ts2e + noise_(K)), hyp, pred.SVCNoise),
    }

    def noise_for(cls, g):
        fields = {"tilde_l": (K, g), "tilde_sigma": (K, g), "L": (K, g, T), "y": (K, g, M)}
        return cls(**{f: randn(*fields[f]) for f in cls._fields})

    def mean(h):
        return tuple(np.mean(v, axis=0) for v in h)

    def hadamard_calls(fam, h, fh, cls):
        zg, zt = noise_for(cls, G), noise_for(cls, n_te)
        data = (x_tr, i_tr, y_tr, M)
        fn = lambda kind: getattr(pred, f"{fam}_hadamard_{kind}")  # noqa: E731
        return {
            f"{fam}_hadamard_predsample": lambda dt: fn("predsample")(
                h, *data, grid, noise=zg, dtype=dt, **fh),
            f"{fam}_hadamard_predmap": lambda dt: fn("predmap")(
                mean(h), *data, grid, dtype=dt, **fh),
            f"{fam}_hadamard_indexedpoint_predsample": lambda dt: fn("indexedpoint_predsample")(
                h, *data, x_te, i_te, noise=zt, dtype=dt, **fh),
            f"{fam}_hadamard_indexedpoint_predmap": lambda dt: fn("indexedpoint_predmap")(
                mean(h), *data, x_te, i_te, dtype=dt, **fh),
        }

    z_sn, z_lmc = noise_for(pred.SNMGPNoise, G), noise_for(pred.LMCNoise, G)
    z_sn_lat = noise_for(pred.SNMGPNoise, G)._replace(y=None)
    sh = PRED_SNMGP_HYPERS
    others = {
        "snmgp_predsample": lambda dt: pred.snmgp_predsample(
            snmgp, Y, x, grid, noise=z_sn, dtype=dt, **sh),
        "snmgp_predmap": lambda dt: pred.snmgp_predmap(mean(snmgp), Y, x, grid, dtype=dt, **sh),
        "snmgp_predmap_sampling": lambda dt: pred.snmgp_predmap_sampling(
            K, mean(snmgp), Y, x, grid, noise=z_sn, dtype=dt, **sh),
        "snmgp_latent_predsample": lambda dt: pred.snmgp_latent_predsample(
            snmgp, x, grid, noise=z_sn_lat, dtype=dt, **sh),
        "lmc_predsample": lambda dt: pred.lmc_predsample(lmc, Y, x, grid, noise=z_lmc, dtype=dt),
        "lmc_predmap": lambda dt: pred.lmc_predmap(mean(lmc), Y, x, grid, dtype=dt),
    }
    for fam, (h, fh, cls) in had.items():
        others.update(hadamard_calls(fam, h, fh, cls))
    ck.reset_launches()
    with recording(ck, ("gibbs", "rbf", "cholesky"), calls):
        other_outs = {name: fn(torch.float32) for name, fn in others.items()}
    torch.cuda.synchronize()
    for k, v in ck.LAUNCHES.items():
        launched[k] += v
    print(f"prediction: the other {len(others)} entry points ({K} draws around the truth; the "
          f"hadamard families on {n_tr} of the {N * M} flat points) launched {dict(ck.LAUNCHES)}")
    for fam in had:
        ip_s = other_outs[f"{fam}_hadamard_indexedpoint_predsample"]  # (n_te, K)
        ip_m = other_outs[f"{fam}_hadamard_indexedpoint_predmap"]  # (3, n_te)
        y_t = torch.as_tensor(y_te, dtype=torch.float64)
        rmse_m = float(torch.sqrt(torch.mean((ip_m[1].double().cpu() - y_t) ** 2)))
        lo, hi = ip_m[0].double().cpu(), ip_m[2].double().cpu()
        in_map = float(((y_t >= lo) & (y_t <= hi)).double().mean())
        print(f"prediction held out, {fam} hadamard indexed-point ({n_te} points): RMSE of the MAP "
              f"mean {rmse_m:.4f}; coverage of the MAP band {in_map:.4f}, of the draws' 2.5-97.5% "
              f"band {band_share(ip_s, y_te):.4f}")

    # ---- every output against float64; the plain and float64 runs launch nothing
    ck.reset_launches()
    for name, fn in main.items():
        three_way(ck, name, fn, outs[name])
    for name, fn in others.items():
        three_way(ck, name, fn, other_outs[name])
    check(sum(ck.LAUNCHES.values()) == 0,
          "prediction: the plain and float64 runs launched no kernel")

    # ---- the kernels at the main path's shapes: against float64, timed
    more = {}
    def f64(args):
        return tuple(a.double() if isinstance(a, torch.Tensor) else a for a in args)

    (Sig,) = next(a for a in calls["cholesky"] if a[0].shape == (S, M * N, M * N))
    L = ck.cholesky_cuda(Sig)
    torch.cuda.synchronize()
    shape = tuple(Sig.shape)
    witnessed("cholesky, SVC prediction train factors", L, ck.cholesky_plain(Sig),
              ck.cholesky_plain(Sig.double()), 1e-6, shape)
    m = Sig.shape[-1]
    more["cholesky"] = [timing_entry(
        f"cholesky {shape} SVC prediction train factors", lambda: ck.cholesky_cuda(Sig),
        lambda: ck.cholesky_plain(Sig), lambda: torch.linalg.cholesky_ex(Sig),
        bound_ms(4 * S * (m * (m + 1) // 2 + m * m), S * m**3 / 3))]
    g_args = next(a for a in calls["gibbs"] if a[2].shape == (S, N) and a[3].shape == (S, G))
    K_g = ck.gibbs_cuda(*g_args)
    witnessed("gibbs, SVC prediction cross-covariances", K_g, ck.gibbs_plain(*g_args),
              ck.gibbs_plain(*f64(g_args)), 1e-6, tuple(K_g.shape))
    n_el = K_g.numel()
    more["gibbs"] = [timing_entry(
        f"gibbs {tuple(K_g.shape)} SVC prediction cross-covariances",
        lambda: ck.gibbs_cuda(*g_args),
        lambda: ck.gibbs_plain(*g_args), None,
        bound_ms(4 * (N + G + S * (N + G) + n_el), n_el * 15), inner=5)]
    r_args = next(a for a in calls["rbf"] if a[1].shape == (N + G,))
    K_r = ck.rbf_cuda(*r_args)
    witnessed("rbf, SVC prediction latent priors", K_r, ck.rbf_plain(*r_args),
              ck.rbf_plain(*f64(r_args)), 1e-6, tuple(K_r.shape))
    n_el = K_r.numel()
    more["rbf"] = [timing_entry(
        f"rbf {tuple(K_r.shape)} SVC prediction latent priors", lambda: ck.rbf_cuda(*r_args),
        lambda: ck.rbf_plain(*r_args), None, bound_ms(4 * (2 * N + G + 4 + n_el), 5 * n_el),
        inner=10)]

    # ---- the entry points timed: inputs on the device, so a call copies nothing from the host
    td = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    hd, Yd, xd, gd = tuple(td(v) for v in hists), td(Y), td(x), td(grid)
    md = tuple(td(v) for v in map_draw)
    timed = {
        f"svc_predsample ({S} draws": lambda: pred.svc_predsample(
            hd, Yd, xd, gd, noise=z_grid, **hyp),
        "svc_predmap (the MAP": lambda: pred.svc_predmap(md, Yd, xd, gd, **hyp),
    }
    for name, fn in timed.items():
        ck.reset_launches()
        fn()
        torch.cuda.synchronize()
        per_call = {k: v for k, v in ck.LAUNCHES.items() if v}
        turns = {}
        for route in ("kernels", "plain", "plain", "kernels"):
            with ck.plain_versions() if route == "plain" else ExitStack():
                turns.setdefault(route, []).append(host_ms(fn, reps=10))
        on_device = device_ms(fn, reps=5)
        wall = float(np.mean(turns["kernels"]))
        k, p = turns["kernels"], turns["plain"]
        print(f"time {name}, N={N}, M={M}, G={G}): kernels {k[0]:.3f} / {k[1]:.3f} ms, "
              f"plain {p[0]:.3f} / {p[1]:.3f} ms a call (host clock to a sync, median of 10, turns "
              f"kernels, plain, plain, kernels); {on_device:.3f} ms of it on the device (CUDA "
              f"events, the host's enqueue hidden), busy {on_device / wall:.1%}; launches a call "
              f"{per_call} ({smi})", flush=True)
        print(f"profile of one {name.split(' (')[0]} call:")
        profile_breakdown(fn, watch=("chol", "gibbs", "rbf", "trsm"))
    print(f"prediction phase: {time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    return launched, more


def fb_snmgp(ck, dev, smi):
    """The whitened SNMGP at N=1024 (MN = 2048 > 1024: the eigen route
    through the Kronecker-matvec kernel), 4 chains: value and gradient
    against float64, a short HMC run, and `mvn_logpdf_kron` timed on both
    routes.  Returns the launches of the path."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.hmc import (
        run_hmc,
        value_and_grad,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
        logdensities as ld,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops.distributions import (
        mvn_logpdf_kron,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import sim_mnts

    N, M, C = SNMGP_N, 2, FB_CHAINS
    x, _, _, _, Y = sim_mnts(M=M, N=N, seed=0)
    gen = torch.Generator(device=dev).manual_seed(2)
    dim = 2 * N + 3 + 1
    q0 = 0.1 * torch.randn(C, dim, device=dev, generator=gen)
    q0[:, -1] = math.log(0.01)

    def problem(dtype, chols):
        xt = torch.as_tensor(x, dtype=dtype, device=dev)
        Yt = torch.as_tensor(Y, dtype=dtype, device=dev)
        chols = tuple(c.to(dtype) for c in chols)
        return lambda q: ld.snmgp_log_posterior_whitened(q, Yt, xt, *chols, mu_tilde_l=-3.0)

    ck.reset_launches()
    t0 = time.perf_counter()
    whiten_calls = {}
    with recording(ck, ("rbf", "cholesky"), whiten_calls):
        chols = ld.snmgp_whiten_chols(torch.as_tensor(x, dtype=torch.float32, device=dev),
                                      *SNMGP_HYPERS.values())
    lp = problem(torch.float32, chols)
    value_and_grad(lp, q0)
    pos, info = run_hmc(lp, q0, gen, num_warmup=SNMGP_HMC, num_samples=SNMGP_HMC, num_steps=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(ck.LAUNCHES)
    check(all(launched[k] > 0 for k in ("gibbs", "kron_mv", "rbf", "cholesky"))
          and bool(torch.isfinite(pos).all()),
          f"SNMGP eigen route (N={N}, MN={M * N}): value, gradient and HMC "
          f"{SNMGP_HMC}+{SNMGP_HMC} in {wall:.2f} s, "
          f"finite, launches {launched}; accept {float(info['accept_prob'].mean()):.3f}")
    whitening_checks(ck, whiten_calls, "SNMGP")
    value_grad_checks(ck, "SNMGP whitened log-posterior", {
        "kernels": lp, "plain": problem(torch.float32, chols), "float64": problem(torch.float64, chols)},
        q0)
    print(f"time of one value_and_grad of the SNMGP density (N={N}, 4 chains): "
          f"{host_ms(lambda: value_and_grad(lp, q0), reps=10):.3f} ms host clock ({smi})")

    # both routes of mvn_logpdf_kron at MN = 1024 and 2048, 4 chains
    for n in (N // 2, N):
        A = torch.randn(C, n, n, device=dev, generator=gen)
        K = A @ A.mT / n + 0.1 * torch.eye(n, device=dev)
        Bm = torch.randn(C, M, M, device=dev, generator=gen)
        B = Bm @ Bm.mT + 0.5 * torch.eye(M, device=dev)
        y = torch.randn(M * n, device=dev, generator=gen)
        s2 = torch.full((C,), 0.1, device=dev)
        dense = lambda: mvn_logpdf_kron(y, torch.zeros_like(y), B, K, s2, dense_max_dim=10**9)  # noqa: E731
        eigen = lambda: mvn_logpdf_kron(y, torch.zeros_like(y), B, K, s2, dense_max_dim=0)  # noqa: E731
        vd, ve = dense(), eigen()
        torch.cuda.synchronize()
        print(f"time mvn_logpdf_kron MN={M * n} (4 chains): dense route "
              f"{host_ms(dense, reps=10):.3f} ms, eigen route {host_ms(eigen, reps=10):.3f} ms, host "
              f"clock to a sync; values agree to {rel_to_max(vd, ve)[1]:.2e} of max ({smi})")
    return launched



# scripts/run_mcmc_sim.py --sampler chees at its defaults (N=100, 4 chains,
# the whitened SVC, dim 401; chees_warmup's max_num_steps 1024), through the
# port's driver (drivers/mcmc_sim.py); the width is not cut.  Its 400
# warmup and 400 samples took 267 s on the H100 (PERF.md, PR 10; 40
# leapfrogs an iteration, 52 once adapted, at ~7.3 ms of host time each),
# which on the slowest host seen (1.8x) would take this script past its
# time limit.  The warmup stays whole: cut to 200, the trajectory length
# did not grow (6 leapfrogs an iteration) and the chains did not mix
# (R-hat max 9.8).  The samples are cut to 120: the draws of a shorter
# run are the prefix of a longer one's (one draw an iteration, Halton by
# offset), and over the prefixes of 200 samples R-hat max was 1.0644 at
# 100, 1.0431 at 120, 1.0540 at 150 and 1.0370 at 200 (`prefix_main`,
# PERF.md); at 200 the script took 1209 s on the slowest host seen.
CHEES_WARMUP, CHEES_SAMPLES = 400, 120
# The gates of the ChEES study: R-hat max, tilde_l RMSE and corr RMSE.  The
# JAX package's own CPU run of the same settings with 100 samples (`python
# scripts/run_mcmc_sim.py --cpu --sampler chees --warmup 400 --samples 100`,
# float32, 5794 s) did not converge: R-hat max 31,529,456, tilde_l RMSE
# 2.053, corr RMSE 0.528, median ESS 5.2, mean accept 0.651.  Twice that
# bounds nothing, so the gates are the NUTS phase's (about twice the JAX
# package's recorded NUTS recovery, PERF.md section 2), on the same study.
CHEES_RHAT_MAX, CHEES_RMSE_TILDE_L, CHEES_RMSE_CORR = 1.1, 0.25, 0.15
# ChEES's draws thinned to at most this many for the DIC (one deviance call)
DIC_DRAWS = 200
# scripts/run_model_comparison.py at its defaults (N=48, 512 particles, 5
# mutations of 16 leapfrogs), uncut, through drivers/model_comparison.py.
# Each model's log Z must lie in its band: the range of the JAX package's
# own runs at these settings on the CPU (float32) over three key sets,
# `PYTHONPATH=. python tests/jax_model_comparison.py` (key sets 0, 100,
# 200: LMC -66.587, NaN, -65.938; SNMGP -34.370, -34.554, -35.133; SVC
# -26.192, -25.954, -25.992), widened by its own width on each side.  LMC's
# band is that of its two finite runs: at key set 100 the JAX package's LMC
# log Z came out NaN (PERF.md, PR 10).
SMC_LOG_Z_BANDS = {"lmc": (-67.24, -65.29), "snmgp": (-35.90, -33.61), "svc": (-26.43, -25.72)}
SMC_MAX_STAGES = 100  # run_smc's default
SMC_TEMPER = 0.5  # the inverse temperature of the density checks


def fb_chees(ck, dev, smi):
    """scripts/run_mcmc_sim.py --sampler chees through the port's driver on
    the card.  Returns the launches of the path."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import mcmc_sim
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
        logdensities as ld,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops.linalg import (
        uvec_to_lvec,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import metrics

    print(f"SVC ChEES: run_mcmc_sim.py --sampler chees, its {FB_FULL[0]} warmup and "
          f"{FB_FULL[1]} samples cut to {CHEES_WARMUP} and {CHEES_SAMPLES}; N={FB_N}, "
          f"{FB_CHAINS} chains, max_num_steps 1024 as there", flush=True)
    t0 = time.perf_counter()

    def progress(phase, i):
        if (i + 1) % 50 == 0:
            print(f"SVC ChEES {phase} {i + 1}: {time.perf_counter() - t0:.1f} s", flush=True)

    args = mcmc_sim.parse_args(["--sampler", "chees", "--N", str(FB_N), "--chains", str(FB_CHAINS),
                                "--warmup", str(CHEES_WARMUP), "--samples", str(CHEES_SAMPLES)])
    ck.reset_launches()
    out, study = mcmc_sim.run_study(args, progress=progress)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(ck.LAUNCHES)
    need = ("gibbs", "chol_inv", "rbf", "cholesky")
    check(all(launched[k] > 0 for k in need),
          f"SVC ChEES (N={FB_N}, dim {study.inits.shape[1]}, {FB_CHAINS} chains) launched {launched}")
    info = study.info
    draws = study.samples.double().cpu().numpy()
    check(bool(np.all(np.isfinite(draws))), f"SVC ChEES: all {draws.size} draw values finite")
    iters = CHEES_WARMUP + max(CHEES_WARMUP // 4, 1) + CHEES_SAMPLES
    eps, traj = float(info["step_size"]), float(info["trajectory_length"])
    metrics_ = dict(out, wall_s_with_setup=wall, step_size=eps, trajectory_length=traj,
                    leapfrogs=info["leapfrogs"], leapfrogs_per_iteration=info["leapfrogs"] / iters,
                    warmup_leapfrogs=info["warmup_leapfrogs"],
                    sampling_leapfrogs_per_iteration=float(info["num_steps"].double().mean()),
                    host_reads=info["host_reads"],
                    ms_per_leapfrog=1e3 * out["wall_s"] / max(info["leapfrogs"], 1),
                    warmup_accept_mean=float(info["warmup_accept_mean"]))
    print("SVC ChEES " + json.dumps(metrics_) + f" ({smi})")
    check(0.4 < out["mean_accept"] < 0.95, f"SVC ChEES mean accept {out['mean_accept']:.4f} in (0.4, 0.95)")
    check(traj > eps, f"SVC ChEES trajectory length {traj:.5f} > step size {eps:.5f}")
    check(out["rhat_max"] <= CHEES_RHAT_MAX, f"SVC ChEES R-hat max {out['rhat_max']:.4f} <= {CHEES_RHAT_MAX}")
    check(out["rmse_tilde_l"] <= CHEES_RMSE_TILDE_L and out["rmse_corr"] <= CHEES_RMSE_CORR,
          f"SVC ChEES recovery: tilde_l RMSE {out['rmse_tilde_l']:.4f} <= {CHEES_RMSE_TILDE_L}, "
          f"corr RMSE {out['rmse_corr']:.4f} <= {CHEES_RMSE_CORR}")

    # ---- the log-posterior and its gradient at the ChEES start
    prob = study.problem
    chols = (prob["chol_l"], prob["chol_L"])
    fns = {"kernels": prob["lp"],
           "plain": mcmc_sim.svc_density(prob, dev, torch.float32, chols=chols)["lp"],
           "float64": mcmc_sim.svc_density(prob, dev, torch.float64, chols=chols)["lp"]}
    value_grad_checks(ck, "SVC whitened log-posterior at the ChEES start", fns, study.inits)

    # ---- DIC of the draws (centered, the deviance's constrained layout)
    N, M, T = prob["N"], prob["M"], prob["T"]
    flat = draws.reshape(-1, draws.shape[-1])
    flat = flat[np.linspace(0, flat.shape[0] - 1, min(DIC_DRAWS, flat.shape[0])).astype(int)]
    cen = torch.as_tensor(mcmc_sim.centered_draws(prob, flat))
    lvecs = uvec_to_lvec(cen[:, N:N + N * T].reshape(-1, N, T), M).reshape(-1, N * T)
    pars = torch.cat([cen[:, :N], lvecs, cen[:, -1:]], dim=1)
    dics = {}
    for tag, dt in (("kernels", torch.float32), ("float64", torch.float64)):
        with ck.plain_versions() if tag != "kernels" else ExitStack():
            t1 = time.perf_counter()
            dics[tag] = metrics.dic(pars.to(dev, dt), ld.svc_deviance,
                                    torch.as_tensor(prob["Y"], dtype=dt, device=dev),
                                    torch.as_tensor(prob["x"], dtype=dt, device=dev))
            dics[tag + "_s"] = time.perf_counter() - t1
    check(math.isfinite(dics["kernels"]),
          f"SVC DIC of {pars.shape[0]} ChEES draws (metrics.dic, one deviance call): "
          f"{dics['kernels']:.4f} f32 with the kernels in {dics['kernels_s']:.3f} s, "
          f"{dics['float64']:.4f} float64 plain ({smi})")
    print(f"SVC ChEES phase: {time.perf_counter() - t0:.1f} s, sampling {out['wall_s']:.1f} s; "
          f"{out['samples_per_s']:.3f} samples/s, ESS/s {out['ess_per_s']:.4f}, "
          f"{metrics_['leapfrogs_per_iteration']:.1f} leapfrogs an iteration, "
          f"{info['host_reads']} host reads ({smi})", flush=True)
    return launched


def fb_smc(ck, dev, smi):
    """scripts/run_model_comparison.py at its defaults through the port's
    driver on the card, then its densities and kernels at its shapes.
    Returns (launches of the path, {kernel: timing entries})."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
        model_comparison as mc,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.hmc import (
        value_and_grad,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops.distributions import (
        KRON_DENSE_MAX_DIM,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.sim import sim_mnts

    args = mc.parse_args([])
    print(f"SMC model comparison: run_model_comparison.py at its defaults, N={args.N}, "
          f"{args.particles} particles, {args.mutations} mutations of {mc.NUM_LEAPFROG} "
          f"leapfrogs", flush=True)
    t0 = time.perf_counter()
    ck.reset_launches()
    out = mc.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(ck.LAUNCHES)
    check(all(launched[k] > 0 for k in ("gibbs", "chol_inv", "rbf", "cholesky"))
          and launched["kron_mv"] == 0,
          f"SMC (MN = {2 * args.N} <= {KRON_DENSE_MAX_DIM}: the dense route) launched {launched}")
    print("SMC " + json.dumps(out) + f" in {wall:.1f} s ({smi})", flush=True)
    for name in mc.MODELS:
        r, betas = out[name], out["betas"][name]
        lo, hi = SMC_LOG_Z_BANDS[name]
        check(math.isfinite(r["log_z"]) and lo <= r["log_z"] <= hi,
              f"SMC {name}: log Z {r['log_z']:.4f} finite, in the JAX band [{lo}, {hi}]")
        check(r["stages"] < SMC_MAX_STAGES and betas[-1] == 1.0,
              f"SMC {name}: beta = 1 after {r['stages']} stages < {SMC_MAX_STAGES}, "
              f"{r['wall_s']:.1f} s")
    check(out["best_model"] != "lmc", f"SMC best model {out['best_model']} (not the stationary LMC)")

    # ---- each tempered density at 512 prior draws against float64
    x, _, _, _, Y = sim_mnts(M=2, N=args.N, seed=0)
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    m32 = mc.make_models(as_t(x, torch.float32), as_t(Y, torch.float32))
    m64 = mc.make_models(as_t(x, torch.float64), as_t(Y, torch.float64),
                         {n: m32[n].chols for n in ("snmgp", "svc")})
    tempered = lambda m: lambda q: m.log_prior(q) + SMC_TEMPER * m.log_like(q)  # noqa: E731
    calls = {}
    for name in mc.MODELS:
        q = m32[name].prior_sampler(torch.Generator(device=dev).manual_seed(11), args.particles)
        with recording(ck, ("chol_inv", "gibbs"), calls) if name == "svc" else ExitStack():
            fns = {"kernels": tempered(m32[name]), "plain": tempered(m32[name]),
                   "float64": tempered(m64[name])}
            value_grad_checks(ck, f"SMC {name} density at beta {SMC_TEMPER}", fns, q)
    lp = tempered(m32["svc"])
    print(f"time of one value_and_grad of the SMC SVC density ({args.particles} particles): "
          f"{host_ms(lambda: value_and_grad(lp, q)):.3f} ms host clock, median of 20 ({smi})")
    print(f"profile of one value_and_grad of the SMC SVC density ({args.particles} particles):")
    profile_breakdown(lambda: value_and_grad(lp, q), watch=("chol_inv", "gibbs"))

    # ---- chol_inv and gibbs at this path's shapes, on the SVC's own inputs
    more = {}
    (K,) = calls["chol_inv"][0]
    b, m = K.shape[0], K.shape[-1]
    (L, Li), (Lp, Lip), (L64, Li64) = ck.chol_inv_cuda(K), ck.chol_inv_plain(K), ck.chol_inv_plain(K.double())
    torch.cuda.synchronize()
    shape = f"({b}, {m}, {m}) SMC SVC covariances, {ck.chol_inv_route(m)}"
    witnessed("chol_inv L", L, Lp, L64, 1e-6, shape)
    witnessed("chol_inv L^-1", Li, Lip, Li64, 1e-6, shape)
    del L, Li, Lp, Lip, L64, Li64
    more["chol_inv"] = [timing_entry(
        f"chol_inv ({b},{m},{m}) SMC", lambda: ck.chol_inv_cuda(K), lambda: ck.chol_inv_plain(K),
        None, bound_ms(4 * b * (m * (m + 1) // 2 + 2 * m * m), b * 2 * m**3 / 3))]
    x1, x2, l1, l2, s2 = calls["gibbs"][0]
    S, n1, n2 = l1.shape[0], x1.shape[0], x2.shape[0]
    G, Gp = ck.gibbs_cuda(x1, x2, l1, l2, s2), ck.gibbs_plain(x1, x2, l1, l2, s2)
    G64 = ck.gibbs_plain(x1.double(), x2.double(), l1.double(), l2.double(), s2)
    torch.cuda.synchronize()
    witnessed("gibbs", G, Gp, G64, 1e-6, f"({S}, {n1}, {n2}) SMC SVC lengthscales")
    el = S * n1 * n2
    more["gibbs"] = [timing_entry(
        f"gibbs ({S},{n1},{n2}) SMC", lambda: ck.gibbs_cuda(x1, x2, l1, l2, s2),
        lambda: ck.gibbs_plain(x1, x2, l1, l2, s2), None,
        bound_ms(4 * (n1 + n2 + S * (n1 + n2) + el), el * 15), inner=10)]
    print(f"SMC phase: {time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    return launched, more


def samplers_main() -> int:
    """The ChEES and SMC phases alone:
    python3 -u -c 'import sys, chip_smoke; sys.exit(chip_smoke.samplers_main())'"""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    ck.build()
    dev = torch.device("cuda")
    for phase in (fb_chees, fb_smc):
        t0 = time.perf_counter()
        phase(ck, dev, smi)
        print(f"{phase.__name__} {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if FAILURES else 0


def prefix_main(chees_samples: int = 200) -> int:
    """R-hat max and recovery of each prefix of the SVC NUTS run (FB_WARMUP
    + FB_SAMPLES, as `fb_svc_nuts` runs it) and of the ChEES study with
    `chees_samples` samples: the draws of a shorter run are the prefix of a
    longer one's, so this is where FB_SAMPLES and CHEES_SAMPLES may be cut:
    python3 -u -c 'import sys, chip_smoke; sys.exit(chip_smoke.prefix_main())'"""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import mcmc_sim
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.sharded_mcmc import (
        potential_scale_reduction,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    ck.build()
    _, _, _, (dens, nuts_draws, _) = fb_svc_nuts(ck, torch.device("cuda"), smi)
    args = mcmc_sim.parse_args(["--sampler", "chees", "--N", str(FB_N), "--chains",
                                str(FB_CHAINS), "--warmup", str(CHEES_WARMUP), "--samples",
                                str(chees_samples)])
    _, study = mcmc_sim.run_study(args)
    runs = (("NUTS", nuts_draws, dens), ("ChEES", study.samples, study.problem))
    for name, draws, problem in runs:
        for k in range(10, draws.shape[1] + 1, 10):
            d = draws[:, :k].double().cpu()
            rec = mcmc_sim.recovery(problem, d.numpy())
            print(f"{name} prefix {k}: R-hat max {float(potential_scale_reduction(d).max()):.4f}, "
                  f"tilde_l RMSE {rec['rmse_tilde_l']:.4f}, corr RMSE {rec['rmse_corr']:.4f} "
                  f"({smi})", flush=True)
    return 0


def prediction_main(warmup: int = 20) -> int:
    """The SVC NUTS phase with its warmup cut to `warmup` transitions (its
    gates are printed but not counted), then the prediction phase on its
    draws: python3 -u -c 'import sys, chip_smoke; sys.exit(chip_smoke.prediction_main())'"""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    ck.build()
    dev = torch.device("cuda")
    with mock.patch.dict(globals(), FB_WARMUP=warmup):
        _, _, _, nuts_run = fb_svc_nuts(ck, dev, smi)
    print(f"(the cut NUTS run's gates not counted: {len(FAILURES)} failed)")
    FAILURES.clear()
    prediction_phase(ck, dev, smi, *nuts_run)
    return 1 if FAILURES else 0


# ------------------------------------------------------------------------
# The real-data workloads, the GP baselines and the simulation protocol
# ------------------------------------------------------------------------

# scripts/run_workload.py's key set (:194-301), and each configuration's
# test RMSE and CI length as the JAX package recorded them on the same
# surrogate (results/workload_ecog_spatial_r5.json, workload_hcp_tpu.json,
# workload_pm25_full_tpu_r4.json: quality numbers, not times), which the
# port's may exceed by at most WORKLOAD_SLACK.  Full width each; only
# PM2.5-full's 100 epochs are cut, to the 12 of the JAX run.  Every step's
# loss must be finite, as in those runs.
WORKLOAD_KEYS = {"workload", "source", "kl_mode", "D", "N", "M", "batch_size", "itnum",
                 "grad_clip", "ckpt_bf16_moments", "lr_decay", "rollbacks", "final_loss",
                 "steps_per_s", "train_s", "loss_min", "loss_argmin", "first_nonfinite_step",
                 "first_blowup_step", "rmse_test", "ci_length", "coverage"}
WORKLOAD_RUNS = (
    ("ECoG D=78 M=100 B=512, 50 epochs, spatial analysis", ("ecog", "--spatial-analysis"), 0.2934,
     1.4294),
    ("HCP D=15 M=100 B=1000, 50 epochs", ("hcp",), 0.6476, 3.5516),
    ("PM2.5-full D=6 M=100 B=1000, 12 of 100 epochs", ("pm25", "--full", "--itnum", "12"), 0.8301,
     4.2694),
)
WORKLOAD_SLACK = 1.25
# the quadform's new shapes (G, N) on these paths: HCP's 105 offdiagonal
# groups and PM2.5's 15 at B = 1000 (M = 100)
WORKLOAD_QF_SHAPES = ((105, 1000), (15, 1000))


def selbo_check(ck, td, tc, name, lists, D, B, hyperpars, dev):
    """One `negative_selbo` value and every parameter's gradient on a batch
    of B rows of a workload's data (its init: `init_params`, mu_v = 1, its
    length scales), the kernels and the plain versions in f32 against
    float64.  A scalar hyperparameter's gradient sums large terms that
    cancel, so its f32 error moves with the order of the batch rows: both
    routes take the rows (and their noise) in the same three orders, and
    the kernels' worst error of the three may be at most 3x the plain
    versions' worst + 1e-4 of max.  Prints each order's readings."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.data import (
        flatten_output_lists,
    )

    flat = flatten_output_lists(*lists)
    x = torch.as_tensor(flat.x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(flat.y, dtype=torch.float32, device=dev)
    idx = torch.as_tensor(flat.idx, dtype=torch.int64, device=dev)
    Z = torch.as_tensor(np.linspace(0.0, float(flat.x.max()), M_PM), dtype=torch.float32,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    params = td.apply_hyperpars(tc.init_params(gen, D, M_PM, device=dev, mu_v=np.ones(M_PM)),
                                hyperpars)
    sel = torch.randperm(x.shape[0], device=dev, generator=gen)[:B]
    noise = tc.draw_train_noise(gen, 1, M_PM, B, D)
    w = torch.ones(B, device=dev)
    orders = [torch.arange(B, device=dev)] + [
        torch.randperm(B, device=dev, generator=gen) for _ in range(2)]

    def grads(dtype, order):
        p = tc.CNMGPParams(*(t.detach().to(dtype).requires_grad_(True) for t in params))
        nz = noise._replace(**{f: getattr(noise, f)[..., order] for f in ("z_te", "z_diag", "z_off")})
        nz = tc.CNMGPNoise(*(None if z is None else z.to(dtype) for z in nz))
        b = sel[order]
        loss = tc.negative_selbo(p, Z.to(dtype), x[b].to(dtype), y[b].to(dtype), idx[b],
                                 w.to(dtype), float(x.shape[0]), nz)
        loss.backward()
        return [loss.detach()] + [t.grad for t in p]

    ck.reset_launches()
    kernels = [grads(torch.float32, o) for o in orders]
    torch.cuda.synchronize()
    launched = dict(ck.LAUNCHES)
    with ck.plain_versions():
        plains = [grads(torch.float32, o) for o in orders]
    ck.reset_launches()
    ref = grads(torch.float64, orders[0])
    torch.cuda.synchronize()
    check(all(launched[k] >= len(orders) for k in TRAIN_KERNELS)
          and sum(ck.LAUNCHES.values()) == 0,
          f"{name} negative_selbo batch: float32 launched {launched}, float64 {dict(ck.LAUNCHES)}")
    worst = 0.0
    for i, what in enumerate(("value",) + tc.CNMGPParams._fields):
        errs_k = [rel_to_max(g[i], ref[i])[1] for g in kernels]
        errs_p = [rel_to_max(pl[i], ref[i])[1] for pl in plains]
        tol = 3 * max(errs_p) + 1e-4
        worst = max(worst, max(errs_k) / tol)
        check(max(errs_k) <= tol and all(bool(torch.isfinite(g[i]).all()) for g in kernels),
              f"{name} {what} vs float64, of max, at three row orders: kernels "
              + ", ".join(f"{e:.3e}" for e in errs_k) + "; plain "
              + ", ".join(f"{e:.3e}" for e in errs_p) + "; tol 3x the worst plain + 1e-4")
    print(f"{name}: worst kernel error / tolerance {worst:.3f}", flush=True)


# Log variances of the tilde_ell prior gram at HCP width (Z on
# linspace(0, 4799, 100), length scale e^5, + 1e-4): float32 factorizations
# fail on some of e^5.8-e^6.5, which the float32 rounding of the gram keeps
# positive-definite up to about e^6.3-6.5, and e^8 is indefinite.
REFACTOR_S2_LOGS = (5.0, 5.8, 6.0, 6.2, 6.4, 6.5, 8.0)


def chol_inv_refactor_check(ck, dev, smi):
    """chol_inv's float64 refactor of a float32 failure (the resident route)
    on the HCP tilde_ell prior at trained variances: every member that
    float64 factors is finite and held against float64 as any other (3x the
    plain version's error + 1e-6 of max), the members cuSOLVER's float32
    fails counted; the indefinite member NaN as the plain version has it.
    Times the call against a batch of healthy members of the same shape."""
    z = torch.linspace(0.0, 4799.0, M_PM, device=dev)
    d2 = (z[:, None] - z[None, :]) ** 2
    ls = torch.exp(torch.tensor(5.0, device=dev))
    eye = torch.eye(M_PM, device=dev)
    K = torch.stack([torch.exp(torch.tensor(s, device=dev)) * torch.exp(-d2 * (0.5 / (ls * ls)))
                     + 1e-4 * eye for s in REFACTOR_S2_LOGS])
    L, Linv = ck.chol_inv_cuda(K)
    Lp, Lip = ck.chol_inv_plain(K)
    f32_failed = torch.linalg.cholesky_ex(K)[1] != 0
    pd = torch.linalg.cholesky_ex(K.double())[1] == 0
    torch.cuda.synchronize()
    n_res = int((f32_failed & pd).sum())
    check(n_res > 0 and bool(pd[0]) and not bool(pd[-1])
          and bool(torch.isfinite(L[pd]).all() and torch.isfinite(Linv[pd]).all())
          and torch.equal(torch.isnan(L), torch.isnan(Lp))
          and torch.equal(torch.isnan(Linv), torch.isnan(Lip)),
          f"chol_inv refactor: {n_res} of {len(REFACTOR_S2_LOGS)} HCP tilde_ell priors fail "
          f"cuSOLVER's float32 and factor in float64, all finite; float64 takes "
          f"{int(pd.sum())}; NaN where the plain version has it")
    L64, Li64 = ck.chol_inv_plain(K[pd].double())
    shape = f"({int(pd.sum())}, {M_PM}, {M_PM}) trained priors"
    witnessed("chol_inv L", L[pd], Lp[pd], L64, 1e-6, shape)
    witnessed("chol_inv L^-1", Linv[pd], Lip[pd], Li64, 1e-6, shape)
    healthy = K[:1].expand(len(REFACTOR_S2_LOGS), -1, -1).contiguous()
    ms, ms_h = device_ms(lambda: ck.chol_inv_cuda(K)), device_ms(lambda: ck.chol_inv_cuda(healthy))
    print(f"chol_inv refactor: ({len(REFACTOR_S2_LOGS)}, {M_PM}, {M_PM}) with {n_res} float32 "
          f"failures {ms:.4f} ms on the device, all healthy {ms_h:.4f} ms ({smi})", flush=True)


def workload_phase(ck, td, tc, dev, smi):
    """`drivers/run_workload.py` at ECoG (with the spatial analysis), HCP and
    PM2.5-full width, each held to the gates of WORKLOAD_RUNS;
    `chol_inv_refactor_check`; one `negative_selbo` value and gradient at an
    HCP and a PM2.5-full batch against float64; 6a/6b/6c and the fused
    backward at WORKLOAD_QF_SHAPES and gibbs at B = 1000 timed.  Returns (the launches of the three runs, timing entries by
    kernel)."""
    import importlib.util

    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
        run_workload,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import etl

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    if not has_mpl:
        print("workload: matplotlib is not installed: the spatial curves are computed by "
              "run_workload.spatial_curves and no figure is written")
    launches = {k: 0 for k in ck.KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv, jax_rmse, jax_ci in WORKLOAD_RUNS:
            argv = list(argv)
            if "--spatial-analysis" in argv and has_mpl:
                argv += ["--out", os.path.join(tmp, "ecog.json")]
            torch.cuda.reset_peak_memory_stats()
            ck.reset_launches()
            t0 = time.perf_counter()
            out, res = run_workload.run_fit(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(ck.LAUNCHES)
            for k in ck.KERNELS:
                launches[k] += counts[k]
            shown = {k: v for k, v in out.items() if k != "spatial_analysis"}
            sa = out.get("spatial_analysis")
            if sa is not None:
                shown["spatial_analysis"] = {k: v for k, v in sa.items() if not k.endswith("curves")}
            print(f"workload {name}: {json.dumps(shown)}", flush=True)
            print(f"workload {name}: trained tilde_ell prior variance "
                  f"e^{float(res.params.sigma2_tildeell_log):.4f}", flush=True)
            print(f"workload {name}: {wall:.1f} s wall, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {counts} ({smi})")
            losses = np.asarray(res.loss_list)
            n_bad = int(np.sum(~np.isfinite(losses)))
            check(WORKLOAD_KEYS <= set(out) and all(counts[k] > 0 for k in TRAIN_KERNELS),
                  f"workload {name}: the JAX script's keys, every training kernel launched")
            check(out["rollbacks"] == 0 and out["first_nonfinite_step"] == -1 and n_bad == 0
                  and out["final_loss"] < losses[0],
                  f"workload {name}: no rollback, {n_bad} of {losses.size} steps non-finite (first "
                  f"{out['first_nonfinite_step']}), final loss {out['final_loss']:.6e} below the "
                  f"first {losses[0]:.6e}")
            check(out["coverage"] >= 0.9 and out["rmse_test"] <= WORKLOAD_SLACK * jax_rmse
                  and out["ci_length"] <= WORKLOAD_SLACK * jax_ci,
                  f"workload {name}: coverage {out['coverage']:.4f} >= 0.9, test RMSE "
                  f"{out['rmse_test']:.4f} and CI length {out['ci_length']:.4f} at most "
                  f"{WORKLOAD_SLACK} x the JAX run's {jax_rmse} and {jax_ci}")
            if sa is not None:
                G = sa["grid_points"]
                curves = list(sa["direction_curves"].values()) + list(sa["distance_curves"].values())
                check(len(sa["direction_curves"]) == 4 and len(sa["distance_curves"]) == 3
                      and all(len(c) == G and np.all(np.isfinite(c)) for c in curves),
                      f"workload {name}: 4 direction and 3 distance curves, {G} finite points each")
                check(len(sa["figures"]) == (2 if has_mpl else 0)
                      and all(os.path.getsize(f) > 0 for f in sa["figures"]),
                      f"workload {name}: figures {[os.path.basename(f) for f in sa['figures']]}")
    chol_inv_refactor_check(ck, dev, smi)
    hyper = run_workload.WORKLOADS
    selbo_check(ck, td, tc, "HCP D=15 B=1000", etl.synthetic_hcp()[:2], 15, 1000,
                hyper["hcp"]["hyperpars"], dev)
    selbo_check(ck, td, tc, "PM2.5-full D=6 B=1000", etl.synthetic_pm25(full=True)[:2], D_PM, 1000,
                hyper["pm25"]["hyperpars"], dev)

    gen = torch.Generator(device=dev).manual_seed(13)
    more = {"quadform_diag": [], "quadform_diag_dw": [], "quadform_diag_da": [],
            "quadform_diag_bwd": [], "gibbs": []}
    for G, N in WORKLOAD_QF_SHAPES:
        A = torch.randn(1, M_PM, N, device=dev, generator=gen)
        W = 0.1 * torch.randn(1, G, M_PM, M_PM, device=dev, generator=gen).tril()
        more["quadform_diag"].append(timing_entry(
            f"quadform_diag (1,{G},{M_PM},{M_PM})x(1,{M_PM},{N})",
            lambda: ck.quadform_diag_cuda(A, W), lambda: ck.quadform_diag_plain(A, W),
            lambda: torch.einsum("smn,sgmk->sgnk", A, W).square().sum(-1),
            qf_bound(1, G, M_PM, N), inner=1))
        del A, W
        for n, (row, _, tc_b) in backward_kernels(ck, gen, dev, M_PM, G=G, N=N).items():
            k_ms, p_ms, l_ms, (b_ms, b_by) = row
            more[n].append({"at": f"G={G} M={M_PM} N={N}", "ms": k_ms, "plain_ms": p_ms,
                            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by, **tc_b})
        if G == 105:
            ms = {k: more[k][-1]["ms"] for k in ("quadform_diag_dw", "quadform_diag_da")}
            print(f"6b at HCP's G = 105: kernel {ms['quadform_diag_dw']:.4f} ms against its einsums "
                  f"{more['quadform_diag_dw'][-1]['library_ms']:.4f} ms ({smi})")
    n, m = 1000, M_PM
    x1 = 4800.0 * torch.rand(n, device=dev, generator=gen)  # the HCP time axis
    x2 = torch.linspace(0.0, 4800.0, m, device=dev)
    l1 = torch.exp(5.0 + 0.3 * torch.randn(1, n, device=dev, generator=gen))
    l2 = torch.exp(5.0 + 0.3 * torch.randn(1, m, device=dev, generator=gen))
    K, K_ref = ck.gibbs_cuda(x1, x2, l1, l2, 1.0), ck.gibbs_plain(x1, x2, l1, l2, 1.0)
    torch.cuda.synchronize()
    check(float(((K - K_ref).abs() - 1e-5 * K_ref.abs() - 1e-30).max()) <= 0.0,
          f"gibbs (1,{n},{m}) on the HCP axis: rtol 1e-5 against the plain version")
    more["gibbs"].append(timing_entry(
        f"gibbs (1,{n},{m})", lambda: ck.gibbs_cuda(x1, x2, l1, l2, 1.0),
        lambda: ck.gibbs_plain(x1, x2, l1, l2, 1.0), None,
        bound_ms(4 * (n + m + n + m + n * m), n * m * 15), inner=10))
    return launches, more


# scripts/baseline_parity.py's rows in float32 (the kernels) against its
# float64 run: the f32 RMSE within BASELINE_RMSE_REL of it, coverage within
# BASELINE_COVERAGE_ABS (on 100 test points a 0.01 step)
BASELINE_RMSE_REL = 0.05
BASELINE_COVERAGE_ABS = 0.03
# baseline_parity.py's Adam steps (IGPR 2000, ICM 3000) cut by this factor
# in both rows, float32 and float64 alike, to give the multidevice phase
# its time: the gate compares the two at equal depth
BASELINE_STEP_CUT = 10
SICM_INDUCING, SICM_STEPS = 100, 500


def baselines_phase(ck, dev, smi):
    """`drivers/baseline_parity.py` in float32 with the kernels and in
    float64, row against row; the exact marginal likelihood and the Titsias
    bound with their gradients at the float64 ICM fit, kernels against
    float64 on both kernels; `fit_sicm` on the PM2.5-sub surrogate at the
    reference's width; cholesky at batch 1 timed.  Returns (the launches of
    the parity and SICM runs, timing entries by kernel)."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
        baseline_parity,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
        baselines as tb,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import etl, sim

    launches = {k: 0 for k in ck.KERNELS}
    runs = {}
    cut = {"IGPR_STEPS": baseline_parity.IGPR_STEPS // BASELINE_STEP_CUT,
           "ICM_STEPS": baseline_parity.ICM_STEPS // BASELINE_STEP_CUT}
    print(f"baseline_parity: its IGPR and ICM Adam steps cut {BASELINE_STEP_CUT}x to {cut}")
    for tag, argv in (("float32", []), ("float64", ["--x64"])):
        ck.reset_launches()
        t0 = time.perf_counter()
        with ExitStack() as stack:
            for name, steps in cut.items():
                stack.enter_context(mock.patch.object(baseline_parity, name, steps))
            runs[tag] = baseline_parity.run_fits(argv)
        torch.cuda.synchronize()
        counts = dict(ck.LAUNCHES)
        print(f"baseline_parity {tag}: {time.perf_counter() - t0:.1f} s, launches {counts} ({smi})",
              flush=True)
        if tag == "float32":
            for k in ck.KERNELS:
                launches[k] += counts[k]
            check(counts["cholesky"] > 0, f"baseline_parity float32 launched cholesky {counts['cholesky']}")
        else:
            check(sum(counts.values()) == 0, f"baseline_parity float64 launched {counts}")
    for r32, r64 in zip(runs["float32"][0], runs["float64"][0]):
        what = f"baseline {r32['dataset']} {r32['model']}"
        print(f"{what}: float32 rmse {r32['rmse']:.4f} ci {r32['ci_length']:.4f} coverage "
              f"{r32['coverage']:.3f}; float64 {r64['rmse']:.4f} / {r64['ci_length']:.4f} / "
              f"{r64['coverage']:.3f}; GPy (the reference's pickle) {r32['ref_rmse']} / "
              f"{r32['ref_ci_length']} / {r32['ref_coverage']}")
        check(abs(r32["rmse"] - r64["rmse"]) <= BASELINE_RMSE_REL * r64["rmse"]
              and abs(r32["coverage"] - r64["coverage"]) <= BASELINE_COVERAGE_ABS,
              f"{what}: float32 RMSE within {BASELINE_RMSE_REL:.0%} of float64's, coverage within "
              f"{BASELINE_COVERAGE_ABS}")

    theta = runs["float64"][1][("low_freq", "ICM")].theta.detach()
    X_list, Y_list, _, _ = sim.sim_illustration_low_freq(seed=22)
    xs = np.concatenate([np.ravel(v) for v in X_list])
    ys = np.concatenate([np.ravel(v) for v in Y_list])
    ids = np.concatenate([np.full(np.size(v), d) for d, v in enumerate(X_list)])
    Zs = tb._inducing_init(xs, 20)
    for kernel in ("exponential", "rbf"):
        kf = tb._KERNELS[kernel]

        def losses(dtype):
            t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
            th = theta.to(dtype).clone().requires_grad_(True)
            idx = torch.as_tensor(ids, device=dev)
            exact = tb._icm_train_parts(th, t(xs), t(ys), idx, 2, 1, kf)[2]
            (bound, *_), _ = tb._sicm_parts(th, t(Zs), torch.arange(20, device=dev) % 2, t(xs),
                                            t(ys), idx, 2, 1, kf)
            return [exact.detach(), torch.autograd.grad(exact, th)[0], bound.detach(),
                    torch.autograd.grad(bound, th)[0]]

        ck.reset_launches()
        got = losses(torch.float32)
        torch.cuda.synchronize()
        launched = dict(ck.LAUNCHES)
        with ck.plain_versions():
            plain = losses(torch.float32)
        ref = losses(torch.float64)
        check(launched["cholesky"] >= 3 and (kernel != "rbf" or launched["rbf"] >= 3),
              f"baselines ({kernel}) value and gradient launched {launched}")
        for what, g, p, r in zip(("ICM nlml", "its gradient", "Titsias bound", "its gradient"),
                                 got, plain, ref):
            err_k, err_p = rel_to_max(g, r)[1], rel_to_max(p, r)[1]
            check(err_k <= 3 * err_p + 1e-4 and bool(torch.isfinite(g).all()),
                  f"baselines ({kernel}) {what} at the float64 ICM fit vs float64, of max: kernels "
                  f"{err_k:.3e}, plain {err_p:.3e}; tol 3x plain + 1e-4")

    X, Y, Xt, Yt = etl.synthetic_pm25()
    ck.reset_launches()
    t0 = time.perf_counter()
    model = tb.fit_sicm(X, Y, num_inducing=SICM_INDUCING, rank=1, steps=SICM_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = dict(ck.LAUNCHES)
    for k in ck.KERNELS:
        launches[k] += counts[k]
    means, stds = tb.predict_sicm(model, Xt)
    yt = np.concatenate([np.ravel(v) for v in Yt])
    mu = np.concatenate(means)
    rmse = float(np.sqrt(np.mean((mu - yt) ** 2)))
    base = float(np.sqrt(np.mean((yt - np.concatenate([np.ravel(v) for v in Y]).mean()) ** 2)))
    print(f"fit_sicm PM2.5-sub (N=28,768, {SICM_INDUCING} inducing, rank 1, {SICM_STEPS} steps): "
          f"{fit_s:.2f} s, {1e3 * fit_s / SICM_STEPS:.3f} ms a step, launches {counts} ({smi})")
    check(bool(np.all(np.isfinite(mu)) and np.all(np.isfinite(np.concatenate(stds))))
          and rmse < base,
          f"fit_sicm PM2.5-sub: test RMSE {rmse:.4f} on {yt.size} points below the training "
          f"mean's {base:.4f}")

    gen = torch.Generator(device=dev).manual_seed(14)
    entries = []
    for m in (100, 200):
        K = _spd(gen, dev, 1, m)
        L = ck.cholesky_cuda(K)
        witnessed("cholesky", L, ck.cholesky_plain(K), ck.cholesky_plain(K.double()), 1e-6,
                  f"(1, {m}, {m})")
        entries.append(timing_entry(
            f"cholesky (1,{m},{m})", lambda: ck.cholesky_cuda(K), lambda: ck.cholesky_plain(K),
            lambda: torch.linalg.cholesky_ex(K), bound_ms(4 * (m * (m + 1) // 2 + m * m), m**3 / 3)))
    return launches, {"cholesky": entries}


def sim_parity_phase(ck, dev, smi):
    """`drivers/sim_parity.py` once at its protocol (M = 20, full batch, lr
    0.005, 2000 epochs, 1000 draws) on sim_illustration_low_freq(seed=22),
    held to the assertions of tests/test_dsvi_e2e.py:65-117.  Returns (its
    launches, no timing entries)."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
        sim_parity,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
        predict as tp,
    )

    data = sim_parity.load_data("sim_illustration_low_freq")
    ck.reset_launches()
    t0 = time.perf_counter()
    rec, res = sim_parity.run_seed(data, 20, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ck.LAUNCHES)
    replayed = sum(ck.REPLAYED.values())
    print("sim_parity " + json.dumps({k: v for k, v in rec.items() if k != "elbo_trace"})
          + f"; {wall:.1f} s, launches {counts} ({replayed} replayed) ({smi})", flush=True)
    losses = np.asarray(res.loss_list)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(bool(np.all(np.isfinite(losses))) and last < 0.5 * first and replayed > 0
          and all(counts[k] > 0 for k in TRAIN_KERNELS),
          f"sim_parity: {len(losses)} finite losses through the graphs, mean of the first 10 "
          f"{first:.4f}, of the last 10 {last:.4f} (must halve)")
    check(res.elbo_trace[-1] > res.elbo_trace[0],
          f"sim_parity ELBO rises: {res.elbo_trace[0]:.2f} -> {res.elbo_trace[-1]:.2f}")
    p = res.params
    check(float(p.length_scales_L0_log) == 2.0 and float(p.length_scales_L1_log) == 2.0
          and float(p.length_scales_tildeell_log) == 0.0 and float(p.sigma2_err_log) != -2.0,
          f"sim_parity: frozen length scales exact, sigma2_err_log moved ({float(p.sigma2_err_log):.4f})")
    Xt_list, Yt_list = data[2], data[3]
    y_test = np.concatenate([np.ravel(yt) for yt in Yt_list])
    ys = tp.sample_Y(p, res.Z, Xt_list, n_sample=50, seed=0)[0].cpu().numpy()
    rmse = float(np.sqrt(np.mean((ys.mean(0) - y_test) ** 2)))
    check(rmse < float(np.std(y_test)) and rec["rmse"] < float(np.std(y_test)),
          f"sim_parity: sample_Y x50 rmse {rmse:.4f}, the protocol's x1000 {rec['rmse']:.4f} < "
          f"std(y_test) {np.std(y_test):.4f}")
    est = tp.predict_Y(p, res.Z, Xt_list).cpu().numpy()
    ys400 = tp.sample_Y(p, res.Z, Xt_list, n_sample=400, seed=1)[0].cpu().numpy()
    corr = float(np.corrcoef(est, ys400.mean(0))[0, 1])
    check(corr > 0.9, f"sim_parity: predict_Y vs mean of 400 draws: corr {corr:.4f} > 0.9")
    return counts, {}


def realdata_phases(ck, td, tc, dev, smi):
    """The three phases above in order, each timed.  Returns (their
    launches, timing entries by kernel)."""
    launches = {k: 0 for k in ck.KERNELS}
    more = {}
    for name, phase in (("workload_phase", lambda: workload_phase(ck, td, tc, dev, smi)),
                        ("baselines_phase", lambda: baselines_phase(ck, dev, smi)),
                        ("sim_parity_phase", lambda: sim_parity_phase(ck, dev, smi))):
        t0 = time.perf_counter()
        counts, entries = phase()
        print(f"{name} {time.perf_counter() - t0:.1f} s; launches {counts}", flush=True)
        for k in ck.KERNELS:
            launches[k] += counts[k]
        for k, rows in entries.items():
            more[k] = more.get(k, []) + rows
    return launches, more


def realdata_main() -> int:
    """The workload, baselines and sim_parity phases alone (with the build):
    python3 -u -c 'import sys, chip_smoke; sys.exit(chip_smoke.realdata_main())'"""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    ck.build()
    launches, more = realdata_phases(ck, dsvi, cnmgp, torch.device("cuda"), smi)
    print(json.dumps({"launches": launches, "more": more}))
    return 1 if FAILURES else 0


# The multi-device phase (multidevice_phase): the sizes of its rank parts.
# ChEES on the SVC study cut to 40 + 10 + 20 iterations (R-hat not gated:
# ChEES does not converge at a cut depth), NUTS to 6 + 1 + 4 transitions
# at depth 4; the spawns' time limit.
MD_RANKS = 2
MD_CHEES = dict(chees_warmup=40, chees_samples=20)
MD_NUTS = dict(nuts_warmup=6, nuts_samples=4, nuts_depth=4)
MD_TIMEOUT_S = 420
# the predicted band of the NCCL world-1 mesh graph's steps/s below the
# no-mesh graph's: the all-reduce of one rank is a copy of the gradients
MD_RATE_BAND = 0.03
# the training kernels' names in a profiler trace
TRACE_NAMES = {"gibbs": "gibbs_kernel", "chol_inv": "chol_inv", "quadform_diag": "quadform_diag_kernel",
               "quadform_diag_dw": "quadform_diag_dw", "quadform_diag_da": "quadform_diag_da",
               "quadform_diag_bwd": "quadform_diag_bwd_kernel",
               "whitened_factors": "whitened_factors_kernel",
               "whitened_factors_bwd": "whitened_factors_bwd_kernel"}


def native_check(smi):
    """`utils/native.py` built with g++ on this host, each function against
    its NumPy version (bit for bit, the windowed covariances at rtol
    1e-12)."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import native

    t0 = time.perf_counter()
    ok = native.available()
    built_s = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    x, Y, z = np.sort(rng.random(300)), rng.standard_normal((300, 3)), rng.random(9)
    got = [native.semivariogram(x, Y[:, 0]), native.semivariogram_multi(x, Y),
           native.windowed_scatter_cov(Y, 30), native.knn_1d(x, z, 10)]
    lib, tried = native._lib, native._tried
    native._lib, native._tried = None, True  # the NumPy versions
    try:
        want = [native.semivariogram(x, Y[:, 0]), native.semivariogram_multi(x, Y),
                native.windowed_scatter_cov(Y, 30), native.knn_1d(x, z, 10)]
    finally:
        native._lib, native._tried = lib, tried
    same = all(np.array_equal(g, w) for i in (0, 1) for g, w in zip(got[i], want[i]))
    same = same and np.array_equal(got[3], want[3])
    close = bool(np.allclose(got[2], want[2], rtol=1e-12, atol=1e-15))
    check(ok and same and close,
          f"native host library built with g++ here ({built_s:.2f} s, {native._library_path().name}): "
          f"semivariograms and knn bit for bit against NumPy, windowed covariances at rtol 1e-12 "
          f"({smi})")


def nccl_world1(ck, td, tc, dev, smi):
    """(a) `inference(mesh=make_mesh())` on an NCCL group of one rank at
    ECoG width, the all-reduce in the step's CUDA graph, against the run
    without a mesh; steps/s of the two graphs in turns; the device kernels
    of a replayed mesh epoch.  Returns (launches, the no-mesh graph's
    steps/s)."""
    import torch.distributed as dist

    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.launch import (
        free_port,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launched = {k: 0 for k in ck.KERNELS}

    def add(counts):
        for k in ck.KERNELS:
            launched[k] += counts[k]

    torch.cuda.set_device(dev.index or 0)
    # the watchdog's checks of captured work: off, as PyTorch's CUDA-graph
    # notes ask for NCCL collectives in a capture
    os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh()
        X_list, Y_list = ecog_lists()
        Zn = np.linspace(0.0, 800.0, M_ECOG)
        kw = dict(batch_size=B_ECOG, dim_outputs=D_ECOG, lr=0.005, itnum=2, seed=0, show_ELBO=False)
        ck.reset_launches()
        with_mesh = td.inference(X_list, Y_list, Zn, mesh=mesh, **kw)
        torch.cuda.synchronize()
        counts, replayed = dict(ck.LAUNCHES), sum(ck.REPLAYED.values())
        add(counts)
        ck.reset_launches()
        base = td.inference(X_list, Y_list, Zn, **kw)
        add(ck.LAUNCHES)
        same = with_mesh.loss_list == base.loss_list and all(
            torch.equal(a, b) for a, b in zip(with_mesh.params, base.params))
        check(same and replayed > 0 and all(counts[k] > 0 for k in TRAIN_KERNELS),
              f"NCCL world 1: inference(mesh=make_mesh()) at ECoG width on the graph ({replayed} "
              f"replayed launches, the all-reduce in the step graph) gives the no-mesh run's "
              f"{len(base.loss_list)} losses and every parameter bit for bit ({smi})")
        del with_mesh, base

        ecog = ecog_data(dev, M_ECOG)
        runs = {}
        for tag, m in (("mesh", mesh), ("no mesh", None)):
            run, params, mask, (Z, x, y, idx), nb = scan_trainer(td, tc, ecog, D_ECOG, B_ECOG,
                                                                 mesh=m)
            draws = td.EpochDraws(torch.Generator(device=dev).manual_seed(2), M_ECOG, B_ECOG,
                                  D_ECOG, torch.float32)
            ck.reset_launches()
            run(params, mask, Z, x, y, idx, draws, 1)  # the capture, then one epoch
            torch.cuda.synchronize()
            add(ck.LAUNCHES)
            runs[tag] = lambda run=run, a=(params, mask, Z, x, y, idx, draws): run(*a, 1)
        rates = {}
        ck.reset_launches()
        for tag in ("mesh", "no mesh", "no mesh", "mesh"):
            t0 = time.perf_counter()
            losses = runs[tag]()
            torch.cuda.synchronize()
            rates.setdefault(tag, []).append(nb / (time.perf_counter() - t0))
            check(bool(torch.isfinite(losses).all()), f"NCCL world 1 rates ({tag}): finite losses")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            runs["mesh"]()
            torch.cuda.synchronize()
        add(ck.LAUNCHES)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        comm = [f"{e.key[:48]} x{e.count}" for e in kernels
                if "nccl" in e.key.lower() or "memcpy" in e.key.lower()]
        m_rate, n_rate = max(rates["mesh"]), max(rates["no mesh"])
        print(f"NCCL world 1: a replayed mesh epoch ({nb} steps) ran {sum(e.count for e in kernels)} "
              f"device kernels; communication and copies: {'; '.join(comm) or 'none'} ({smi})")
        print(f"NCCL world 1 steps/s at ECoG width, graphs in turns mesh, no mesh, no mesh, mesh: "
              f"{rates['mesh'][0]:.2f}, {rates['no mesh'][0]:.2f}, {rates['no mesh'][1]:.2f}, "
              f"{rates['mesh'][1]:.2f}; predicted within {MD_RATE_BAND:.0%} ({smi})")
        check(m_rate >= (1 - MD_RATE_BAND) * n_rate,
              f"NCCL world 1: the mesh graph's best {m_rate:.2f} steps/s within {MD_RATE_BAND:.0%} "
              f"of the no-mesh graph's {n_rate:.2f}")
        del runs, run, params, prof
    finally:
        dist.destroy_process_group()
    return launched, n_rate


def rank_checks(results, smi):
    """The gates of (b)-(e) on the ranks' results (`drivers/
    multidevice_check.card_ranks`)."""
    r0, r1 = results
    dp = r0["dp"]
    worst = 0.0
    for name, e in dp["grad_errors"].items():
        tol = ecog_grad_tol(e["plain"])
        worst = max(worst, e["dp_kernels"] / tol)
        check(e["dp_kernels"] <= tol,
              f"gloo DP grad {name} vs float64, of max: 2 ranks with the kernels "
              f"{e['dp_kernels']:.3e}, plain one process " + ", ".join(f"{v:.3e}" for v in e["plain"])
              + "; tol 3x the worst plain + 1e-5")
    need = all(r["dp"]["grad_launches"][k] > 0 for r in results for k in TRAIN_KERNELS)
    check(need and r0["dp"]["loss"] == r1["dp"]["loss"]
          and r0["dp"]["params_checksum"] == r1["dp"]["params_checksum"],
          f"gloo DP at ECoG width, {B_ECOG // MD_RANKS} rows a rank: both ranks launched the five "
          f"training kernels ({r0['dp']['grad_launches']}), the same loss {dp['loss']:.6e} "
          f"(float64 {dp['loss64']:.6e}) and the same parameters after {len(results)} ranks' steps; "
          f"worst error / tolerance {worst:.3f}")
    for r, res in enumerate(results):
        d = res["dp"]
        print(f"gloo DP rank {r}: {d['step_s']:.4f} s a step, the all-reduce of {d['allreduce_mb']:.1f} "
              f"MiB staged through the host {d['allreduce_s']:.4f} s ({d['allreduce_s'] / d['step_s']:.1%} "
              f"of the step) ({smi})")
    c0, c1 = r0["chees"], r1["chees"]
    check(c0["finite"] and c1["finite"] and c0["step_size"] == c1["step_size"]
          and c0["trajectory_length"] == c1["trajectory_length"],
          f"run_chees_sharded SVC (dim {c0['shape'][2]}, {c0['shape'][0]} chains, 2 a rank): finite "
          f"draws, step size {c0['step_size']:.6g} and trajectory length "
          f"{c0['trajectory_length']:.6g} equal on both ranks")
    print(f"run_chees_sharded SVC: {c0['s']:.1f} s, mean accept {c0['mean_accept']:.4f}, R-hat max "
          f"{c0['rhat_max']:.4f} (not gated: a cut depth), {c0['leapfrogs']} leapfrogs, "
          f"{c0['host_reads']} host reads on rank 0 ({smi})")
    for name, m in r0["smc"]["models"].items():
        lo, hi = SMC_LOG_Z_BANDS[name]
        check(math.isfinite(m["log_z"]) and lo <= m["log_z"] <= hi and m["last_beta"] == 1.0
              and m["log_z"] == r1["smc"]["models"][name]["log_z"],
              f"run_smc_sharded {name}: log Z {m['log_z']:.4f} in the JAX band [{lo}, {hi}], beta 1 "
              f"after {m['stages']} stages, the same on both ranks ({m['s']:.1f} s)")
    n0 = r0["nuts"]
    check(n0["finite"] and r1["nuts"]["finite"],
          f"run_nuts_sharded SVC {tuple(n0['shape'])}: finite draws in {n0['s']:.1f} s "
          f"(host reads {n0['host_reads']})")
    print(f"rank parts: DP {r0['dp']['s']:.1f} s, ChEES {c0['s']:.1f} s, SMC {r0['smc']['s']:.1f} s, "
          f"NUTS {n0['s']:.1f} s on rank 0 ({smi})")


def per_rank_shapes(ck, dev, smi):
    """The kernels at the shapes one of two ranks gives them: 6a/6b/6c at
    ECoG's N = 256 rows, chol_inv and gibbs at SMC's 256 particles of the
    SVC model.  Each f32 result is held against float64 on the same inputs
    (at most 3x the plain f32 version's error + 1e-6 of max; 6b, 6c and the
    fused backward in `backward_kernels`), then timed.  Returns timing entries by kernel."""
    gen = torch.Generator(device=dev).manual_seed(15)
    N, G = B_ECOG // MD_RANKS, D_ECOG * (D_ECOG - 1) // 2
    more = {"quadform_diag": []}
    for S, g in ((1, G), (1, D_ECOG)):
        A = torch.randn(S, M_ECOG, N, device=dev, generator=gen)
        W = 0.1 * torch.randn(S, g, M_ECOG, M_ECOG, device=dev, generator=gen).tril()
        shape = f"({S},{g},{M_ECOG},{M_ECOG})x({S},{M_ECOG},{N})"
        witnessed("quadform_diag a rank", ck.quadform_diag_cuda(A, W),
                  ck.quadform_diag_plain(A, W), ck.quadform_diag_plain(A.double(), W.double()),
                  1e-6, shape)
        more["quadform_diag"].append(timing_entry(
            f"quadform_diag {shape} a rank",
            lambda: ck.quadform_diag_cuda(A, W), lambda: ck.quadform_diag_plain(A, W),
            lambda: torch.einsum("smn,sgmk->sgnk", A, W).square().sum(-1),
            qf_bound(S, g, M_ECOG, N), inner=1))
        del A, W
    for name, (row, _, tc_b) in backward_kernels(ck, gen, dev, M_ECOG, G, N).items():
        k_ms, p_ms, l_ms, (b_ms, b_by) = row
        more[name] = [{"at": f"({G},{M_ECOG},{M_ECOG})x({M_ECOG},{N}) a rank", "ms": k_ms,
                       "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                       **tc_b}]
    b, m = 256, 96
    K = _spd(gen, dev, b, m)
    (L, Li), (Lp, Lip), (L64, Li64) = (ck.chol_inv_cuda(K), ck.chol_inv_plain(K),
                                       ck.chol_inv_plain(K.double()))
    shape = f"({b}, {m}, {m}) {ck.chol_inv_route(m)} SMC a rank"
    witnessed("chol_inv L", L, Lp, L64, 1e-6, shape)
    witnessed("chol_inv L^-1", Li, Lip, Li64, 1e-6, shape)
    del L, Li, Lp, Lip, L64, Li64
    more["chol_inv"] = [timing_entry(
        f"chol_inv ({b},{m},{m}) SMC a rank", lambda: ck.chol_inv_cuda(K),
        lambda: ck.chol_inv_plain(K), None,
        bound_ms(4 * b * (m * (m + 1) // 2 + 2 * m * m), b * 2 * m**3 / 3))]
    S, n = 256, 48
    x1 = torch.linspace(0.0, 1.0, n, device=dev)
    l1 = torch.exp(-1.0 + 0.3 * torch.randn(S, n, device=dev, generator=gen))
    witnessed("gibbs", ck.gibbs_cuda(x1, x1, l1, l1, 1.0), ck.gibbs_plain(x1, x1, l1, l1, 1.0),
              ck.gibbs_plain(x1.double(), x1.double(), l1.double(), l1.double(), 1.0), 1e-6,
              f"({S}, {n}, {n}) SMC a rank")
    el = S * n * n
    more["gibbs"] = [timing_entry(
        f"gibbs ({S},{n},{n}) SMC a rank", lambda: ck.gibbs_cuda(x1, x1, l1, l1, 1.0),
        lambda: ck.gibbs_plain(x1, x1, l1, l1, 1.0), None,
        bound_ms(4 * (2 * n + 2 * S * n + el), el * 15), inner=10)]
    return more


def profiling_checks(ck, td, tc, dev, smi, steps_per_s):
    """(g) `utils/profiling`: a trace of three eager ECoG steps (its file's
    size, its kernel events, the port's kernels among them), `print_mem`,
    the allocator's counters, and the FLOPs of one ECoG step counted on the
    plain versions with that step's MFU at the graph's steps/s."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import profiling

    x, y, idx, Z = ecog_data(dev, M_ECOG)
    one = step_closure(td, tc, x, y, idx, Z, D_ECOG, B_ECOG)
    one()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            for _ in range(3):
                one()
            torch.cuda.synchronize()
        (path,) = Path(tmp).iterdir()
        size = path.stat().st_size
        events = json.loads(path.read_text())["traceEvents"]
    spins = [e for e in events if e.get("cat") == "kernel" and "spin_kernel" in e["name"]]
    kernels = [e["name"] for e in events
               if e.get("cat") == "kernel" and "spin_kernel" not in e["name"]]
    seen = {k: sum(TRACE_NAMES[k] in n for n in kernels) for k in TRAIN_KERNELS}
    # the lead's probes the trace kept, and where the region's kernels start
    # after its host range opened
    opened = [e["ts"] for e in events if str(e.get("name", "")).startswith("ProfilerStep#")]
    region = [e["ts"] for e in events if e.get("name") == profiling.REGION_NAME]
    first = min((e["ts"] for e in events if e.get("cat") == "kernel"
                 and "spin_kernel" not in e["name"]), default=None)
    probe = min((e["ts"] for e in spins), default=None)
    lead = ("n/a" if not opened or probe is None
            else f"{(probe - min(opened)) / 1e3:.3f} ms into the window")
    start = "n/a" if not region or first is None else f"{(first - min(region)) / 1e3:.3f} ms"
    check(bool(kernels) and all(seen[k] >= 3 for k in TRAIN_KERNELS),
          f"profiling.trace of 3 eager ECoG steps: {path.name} {size / 2**20:.1f} MiB, "
          f"{len(kernels)} kernel events besides the lead's probes, the port's kernels among "
          f"them {seen}; {len(spins)} of the {profiling.CUDA_LEAD_PROBES + 1} lead probes "
          f"recorded, the first {lead}; the region's first kernel {start} after it opened ({smi})")
    mb = profiling.print_mem(0)
    stats = profiling.device_memory_stats()
    check(mb > 0 and all(s["bytes_in_use"] <= s["peak_bytes_in_use"] <= s["bytes_limit"]
                         for s in stats.values()) and stats,
          f"print_mem {mb:.1f} MiB RSS; device_memory_stats {stats}")
    with ck.plain_versions():
        flops = profiling.flops_of(one)
    peak = profiling.peak_flops_per_s()
    mfu = None if peak is None else flops * steps_per_s / peak
    check(flops > 0 and peak is not None,
          f"flops_of one ECoG DSVI step (plain versions, matmul-like operators only): "
          f"{flops / 1e9:.3f} GFLOP; at the graph's {steps_per_s:.2f} steps/s "
          f"{flops * steps_per_s / 1e12:.3f} TFLOP/s, MFU {mfu if mfu is None else f'{mfu:.4%}'} "
          f"of the {peak if peak is None else f'{peak / 1e12:.1f}'} TFLOP/s dense bf16 peak ({smi})")


def multidevice_phase(ck, td, tc, dev, smi):
    """The multi-device layer on the card: the native library (h); an NCCL
    group of one rank, `inference(mesh=...)` with the all-reduce in the
    step graph (a); two gloo ranks on this card (b)-(e) in one spawn
    (`drivers/multidevice_check.card_ranks`: the DP step's gradient against
    float64, sharded ChEES, SMC and NUTS); `graft_entry.dryrun_multichip(2)`
    and `entry()` (f); the kernels at one rank's shapes; profiling (g).
    Returns (launches, the ranks' included; timing entries by kernel)."""
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.drivers import (
        graft_entry,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.launch import (
        spawn,
    )

    launched = {k: 0 for k in ck.KERNELS}

    def add(counts):
        for k in ck.KERNELS:
            launched[k] += counts[k]

    t0 = time.perf_counter()
    native_check(smi)
    counts, steps_per_s = nccl_world1(ck, td, tc, dev, smi)
    add(counts)
    print(f"multidevice (a) {time.perf_counter() - t0:.1f} s", flush=True)

    t1 = time.perf_counter()
    results = spawn(f"{PORT}.drivers.multidevice_check:card_ranks", MD_RANKS,
                    {"device": "cuda", **MD_CHEES, **MD_NUTS},
                    timeout=MD_TIMEOUT_S)
    for r in results:
        add(r["launches"])
    rank_checks(results, smi)
    print(f"multidevice (b)-(e) {time.perf_counter() - t1:.1f} s with the ranks' start; launches "
          f"{[r['launches'] for r in results]}", flush=True)

    t1 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(MD_RANKS, timeout=MD_TIMEOUT_S)
    for r in dry:
        add(r["launches"])
    fn, args = graft_entry.entry()
    ck.reset_launches()
    value = float(fn(*args))
    add(ck.LAUNCHES)
    check(math.isfinite(value) and all(sum(r["launches"].values()) > 0 for r in dry),
          f"graft_entry: dryrun_multichip({MD_RANKS}) on the card launched "
          f"{[r['launches'] for r in dry]}; entry() negative SELBO {value:.4f} "
          f"({time.perf_counter() - t1:.1f} s)")

    more = per_rank_shapes(ck, dev, smi)
    profiling_checks(ck, td, tc, dev, smi, steps_per_s)
    print(f"multidevice phase {time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    return launched, more


def multidevice_main() -> int:
    """The multidevice phase alone (with the build):
    python3 -u -c 'import sys, chip_smoke; sys.exit(chip_smoke.multidevice_main())'"""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    ck.build()
    launches, more = multidevice_phase(ck, dsvi, cnmgp, torch.device("cuda"), smi)
    print(json.dumps({"launches": launches, "more": more}))
    for f in FAILURES:
        print("FAILED: " + f)
    return 1 if FAILURES else 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (Path(__file__).resolve().parent / PORT).is_dir():
        print(f"chip_smoke: the package {PORT} is not beside this script", file=sys.stderr)
        return 2
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import (
        dsvi,
        optimizers,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import (
        cnmgp,
        predict,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import linalg
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops.kernels import (
        rbf,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
        checkpoint,
        sim,
    )
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils.metrics import (
        predictive_summary,
    )

    # ---------------------------------------------------------------- set-up
    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = ck.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(0)

    # ------------------------------------------- kernels against plain versions
    Z = torch.linspace(0.0, 800.0, M_ECOG, device=dev)
    x = torch.as_tensor(np.concatenate(ecog_request(1)), dtype=torch.float32, device=dev)
    ell_x = torch.exp(2.5 + 0.3 * torch.randn(S_CHUNK, B_ECOG, device=dev, generator=gen))
    ell_z = torch.exp(2.5 + 0.3 * torch.randn(S_CHUNK, M_ECOG, device=dev, generator=gen))
    gibbs_errs = []
    for a, b, l1, l2 in ((x, Z, ell_x, ell_z), (Z, Z, ell_z, ell_z)):
        K = ck.gibbs_cuda(a, b, l1, l2, 1.0)
        K_ref = ck.gibbs_plain(a, b, l1, l2, 1.0)
        torch.cuda.synchronize()
        err = float(((K - K_ref).abs() - 1e-5 * K_ref.abs() - 1e-30).max())
        gibbs_errs.append(float((K - K_ref).abs().max()))
        check(err <= 0.0 and bool(torch.isfinite(K).all()),
              f"gibbs {tuple(K.shape)}: max|K-plain| {gibbs_errs[-1]:.3e}, rtol 1e-5")

    # the (4 S, M, M) prior stack of one chunk: three dense RBF grams and the
    # Gibbs gram of each draw, + jitter; member 5 made indefinite
    eyeM = torch.eye(M_ECOG, device=dev)
    K_stat = torch.stack([rbf(Z, Z, 1.0, ls) for ls in (12.0, 16.0, 24.0)])
    K_G = ck.gibbs_plain(Z, Z, ell_z, ell_z, 1.0)
    K_stack = torch.cat([K_stat.expand(S_CHUNK, 3, M_ECOG, M_ECOG), K_G[:, None]], 1)
    K_stack = (K_stack + JITTER * eyeM).reshape(4 * S_CHUNK, M_ECOG, M_ECOG).contiguous()
    bad = 5
    K_stack[bad] -= 0.005 * eyeM  # indefinite; the 100x jitter boost restores it
    L, Linv = ck.chol_inv_cuda(K_stack)
    L_ref, Linv_ref = ck.chol_inv_plain(K_stack)
    L64, Linv64 = ck.chol_inv_plain(K_stack.double())
    torch.cuda.synchronize()
    good = torch.ones(4 * S_CHUNK, dtype=torch.bool, device=dev)
    good[bad] = False
    chol_err = max(rel_to_max(L[good], L_ref[good])[0], rel_to_max(Linv[good], Linv_ref[good])[0])
    # f32 factors of grams with condition ~1e5: the kernel's and the
    # library's blocked factorizations round differently, so both are
    # held against the float64 factors of the same f32 input, and the
    # kernel may be at most 3x as far off as the library (+ a floor)
    fwd = {}
    for tag, (l, li) in {"kernel": (L, Linv), "plain": (L_ref, Linv_ref)}.items():
        K64 = K_stack[good].double()
        l64 = l[good].double()
        fwd[tag] = (
            rel_to_max(l[good], L64[good])[1],
            rel_to_max(li[good], Linv64[good])[1],
            rel_to_max(l64 @ l64.transpose(-1, -2), K64)[1],
            float((li[good].double() @ l64 - eyeM.double()).abs().max()),
        )
    fk, fp = fwd["kernel"], fwd["plain"]
    check(fk[0] <= 3 * fp[0] + 1e-6 and fk[1] <= 3 * fp[1] + 1e-6,
          f"chol_inv (32,100,100) error vs float64, of max: L {fk[0]:.3e} (plain {fp[0]:.3e}), "
          f"L^-1 {fk[1]:.3e} (plain {fp[1]:.3e}); tol 3x plain + 1e-6")
    check(fk[2] <= M_ECOG * EPS32,
          f"chol_inv backward error |L L^T - K|/|K| {fk[2]:.3e} (plain {fp[2]:.3e}), tol M eps = "
          f"{M_ECOG * EPS32:.3e}")
    check(fk[3] <= 3 * fp[3] + 1e-6,
          f"chol_inv |L^-1 L - I|_max {fk[3]:.3e} (plain {fp[3]:.3e}), tol 3x plain + 1e-6")
    same_nan = torch.equal(torch.isnan(L), torch.isnan(L_ref)) and torch.equal(
        torch.isnan(Linv), torch.isnan(Linv_ref))
    check(same_nan and bool(torch.isnan(L[bad]).any()) and bool(torch.isfinite(L[good]).all()),
          "chol_inv flags the indefinite member with NaN, as the plain version does")
    Lr, Lir = linalg.chol_tri_inv_robust(K_stack, JITTER)
    Lr_ref, _ = ck.chol_inv_plain(K_stack + 100 * JITTER * eyeM * (~good)[:, None, None])
    torch.cuda.synchronize()
    rec = rel_to_max(Lr[bad], Lr_ref[bad])[1]
    check(bool(torch.isfinite(Lr).all() and torch.isfinite(Lir).all()) and rec <= 1e-4,
          f"chol_tri_inv_robust recovers the indefinite member (rel err {rec:.3e}, tol 1e-4)")

    G_OFF = D_ECOG * (D_ECOG - 1) // 2
    A = torch.randn(S_CHUNK, M_ECOG, B_ECOG, device=dev, generator=gen)
    W = 0.1 * torch.randn(S_CHUNK, G_OFF, M_ECOG, M_ECOG, device=dev, generator=gen).tril()
    V = ck.quadform_diag_cuda(A, W)
    V_ref = ck.quadform_diag_plain(A, W)
    torch.cuda.synchronize()
    qf_err, qf_rel = rel_to_max(V, V_ref)
    # sums of 100 products, then of 100 squares, in another order
    check(qf_rel <= 1e-4, f"quadform_diag (8,3003,512): max err {qf_err:.3e} ({qf_rel:.3e} of max|V|), tol 1e-4")
    # the checks added for 6a and Gibbs draw from generators of their own, so
    # that every other check of the script keeps its inputs
    qf64_err, qf_rows = forward_kernel(ck, torch.Generator(device=dev).manual_seed(7), dev)
    backward = backward_kernels(ck, gen, dev)
    for name in ("quadform_diag", "quadform_diag_dw", "quadform_diag_da"):
        check(ck.max_m(name) >= 512, f"max_m({name!r}) = {ck.max_m(name)} >= 512")
    gibbs_err, gibbs_rows = gibbs_shapes(ck, torch.Generator(device=dev).manual_seed(8), dev)
    rbf_err, rbf_rows = rbf_shapes(ck, torch.Generator(device=dev).manual_seed(10), dev)
    backward200 = backward_kernels(ck, gen, dev, M_ECOG200)
    # ECoG's diagonal groups and latent functions, G = 78
    backward78 = backward_kernels(ck, torch.Generator(device=dev).manual_seed(16), dev, G=D_ECOG)
    # PM2.5-sub's offdiagonal groups, where 6b has lost to its einsums
    backward_pm = backward_kernels(ck, torch.Generator(device=dev).manual_seed(12), dev, M_PM,
                                   G=D_PM * (D_PM - 1) // 2, N=B_PM)

    # ----------------------------------------- serving at full ECoG width
    params = cnmgp.init_params(torch.Generator(device=dev).manual_seed(0), D_ECOG, M_ECOG,
                               device=dev)
    # lengthscales on the scale of the inputs, so every prior gram is dense
    # as in a fitted model (init_params' exp(-4) makes them diagonal here)
    log40 = math.log(40.0)
    params = params._replace(
        mu_v=torch.full((M_ECOG,), log40, device=dev),
        length_scales_tildeell_log=torch.tensor(log40, device=dev),
        length_scales_L0_log=torch.tensor(log40, device=dev),
        length_scales_L1_log=torch.tensor(log40, device=dev),
    )
    Zn = Z.cpu().numpy()
    X_list = ecog_request(2)
    x_fy = np.linspace(0.0, 800.0, 64)
    ngen = torch.Generator(device=dev).manual_seed(1)
    noise_y = cnmgp.draw_noise(ngen, N_DRAWS, M_ECOG, B_ECOG, D_ECOG)
    noise_fy = cnmgp.draw_noise(ngen, S_CHUNK, M_ECOG, 64, D_ECOG, all_outputs=True)

    forwards = {"gibbs", "chol_inv", "quadform_diag"}

    def serving_calls(p, ny, nfy):
        return {
            "predict_Y": (lambda: (predict.predict_Y(p, Zn, X_list),), {"gibbs", "rbf"}),
            "sample_Y": (lambda: predict.sample_Y(p, Zn, X_list, n_sample=N_DRAWS, noise=ny),
                         forwards),
            "sample_FY": (lambda: predict.sample_FY(p, Zn, x_fy, n_sample=S_CHUNK, noise=nfy),
                          forwards),
        }

    calls = serving_calls(params, noise_y, noise_fy)
    launches = {k: 0 for k in ck.KERNELS}
    served = {}
    for name, (fn, needs) in calls.items():
        ck.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(ck.LAUNCHES)
        for k in ck.KERNELS:
            launches[k] += counts[k]
        served[name] = out
        missing = [k for k in needs if counts[k] == 0]
        check(not missing and all(bool(torch.isfinite(o).all()) for o in out),
              f"{name} at D=78, M=100: finite, launches {counts}")
    double = lambda nz: cnmgp.CNMGPNoise(*(z.double() for z in nz))  # noqa: E731
    calls64 = serving_calls(cnmgp.params_to(params, dev, torch.float64),
                            double(noise_y), double(noise_fy))
    with ck.plain_versions():
        ck.reset_launches()
        for name, (fn, _) in calls.items():
            plain = fn()
            ref = calls64[name][0]()
            torch.cuda.synchronize()
            err_k = max(rel_to_max(a, b)[1] for a, b in zip(served[name], ref))
            err_p = max(rel_to_max(a, b)[1] for a, b in zip(plain, ref))
            # f32 end to end through dense priors (condition ~1e5): both f32
            # runs are held against the float64 run on the same noise
            check(err_k <= 3 * err_p + 1e-5,
                  f"{name} vs float64, of max: kernels {err_k:.3e}, plain versions {err_p:.3e}; "
                  f"tol 3x plain + 1e-5")
        check(sum(ck.LAUNCHES.values()) == 0, "plain and float64 runs launched no kernel")

    # ------------------------------------------------ fitted-model check
    fx_path = (Path(cnmgp.__file__).resolve().parents[1] / "fixtures"
               / "illustration_low_freq_jax.npz")
    with np.load(fx_path) as f:
        fx = {k: f[k] for k in f.files}
    fparams = cnmgp.params_from_numpy(fx, device=dev)
    Xt = [fx["x_test"][fx["idx_test"] == d] for d in range(2)]
    pred = predict.predict_Y(fparams, fx["Z"], Xt).cpu().numpy()
    p_err = float(np.max(np.abs(pred - fx["predict_y"])))
    p_rel = p_err / float(np.max(np.abs(fx["predict_y"])))
    check(p_rel <= 1e-4, f"fixture predict_Y vs JAX f64: max err {p_err:.3e} ({p_rel:.3e} of max), tol 1e-4")
    ys, _, _, _ = predict.sample_Y(fparams, fx["Z"], Xt, n_sample=int(fx["n_sample"]), seed=0)
    rmse, ci, cov = predictive_summary(ys.cpu().numpy(), fx["y_test"],
                                       test_index=fx["idx_test"], dim_outputs=2)
    cov = float(np.mean(cov))
    j_rmse, j_ci, j_cov = (float(fx[k]) for k in ("sample_rmse", "sample_ci_length", "sample_coverage"))
    # other draws than JAX's: Monte-Carlo bands for 1000 draws at 200 points
    check(abs(rmse - j_rmse) <= 0.05 * j_rmse and abs(ci - j_ci) <= 0.05 * j_ci
          and abs(cov - j_cov) <= 0.05,
          f"fixture sample_Y x1000: rmse {rmse:.4f} (JAX {j_rmse:.4f}, band 5%), "
          f"ci {ci:.4f} (JAX {j_ci:.4f}, band 5%), coverage {cov:.4f} (JAX {j_cov:.4f}, band 0.05)")

    # ---------------------------------------------------------------- times
    d = 1
    n_el = S_CHUNK * B_ECOG * M_ECOG
    nb = 4 * S_CHUNK
    q_ops = S_CHUNK * G_OFF * B_ECOG * (M_ECOG**2 + 3 * M_ECOG)  # as qf_bound counts them
    timed = {
        "gibbs (8,512,100)": (
            lambda: ck.gibbs_cuda(x, Z, ell_x, ell_z, 1.0),
            lambda: ck.gibbs_plain(x, Z, ell_x, ell_z, 1.0), None, 10,
            bound_ms(4 * (B_ECOG * d + M_ECOG * d + S_CHUNK * (B_ECOG + M_ECOG) + n_el),
                     n_el * (3 * d + 12))),
        "chol_inv (32,100,100)": (
            lambda: ck.chol_inv_cuda(K_stack), lambda: ck.chol_inv_plain(K_stack), None, 5,
            bound_ms(4 * nb * (M_ECOG * (M_ECOG + 1) // 2 + 2 * M_ECOG**2),
                     nb * 2 * M_ECOG**3 / 3)),
        "quadform_diag (8,3003,100,100)x(8,100,512)": (
            lambda: ck.quadform_diag_cuda(A, W), lambda: ck.quadform_diag_plain(A, W),
            lambda: torch.einsum("smn,sgmk->sgnk", A, W).square().sum(-1), 1,
            qf_bound(S_CHUNK, G_OFF, M_ECOG, B_ECOG)),
    }
    times = {}
    for name, (kern, plain, lib, inner, (b_ms, b_by)) in timed.items():
        k_ms = device_ms(kern, inner=inner)
        p_ms = device_ms(plain, inner=inner)
        l_ms = None if lib is None else device_ms(lib, inner=inner)
        k_b2b = back_to_back_ms(kern, inner=inner)
        times[name.split()[0]] = (k_ms, p_ms, l_ms, (b_ms, b_by))
        print(f"time {name}: kernel {k_ms:.4f} ms on the device ({k_b2b:.4f} ms a call back to "
              f"back, host launch included), plain {p_ms:.4f} ms, library "
              f"{'n/a' if l_ms is None else f'{l_ms:.4f} ms'}, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / k_ms:.1%} of bound")
    print(f"quadform_diag achieved {q_ops / (times['quadform_diag'][0] * 1e-3) / 1e9:.0f} "
          f"GFLOP/s FP32 of the triangular work ({smi})")

    pred_ms = host_ms(calls["predict_Y"][0])
    draw_ms = host_ms(calls["sample_Y"][0]) / N_DRAWS
    with ck.plain_versions():
        pred_plain = host_ms(calls["predict_Y"][0])
        draw_plain = host_ms(calls["sample_Y"][0]) / N_DRAWS
    print(f"time predict_Y B=512 request: {pred_ms:.3f} ms (plain versions {pred_plain:.3f} ms), "
          f"median of 20")
    print(f"time sample_Y per draw at B=512 ({N_DRAWS} draws, chunks of {S_CHUNK}): "
          f"{draw_ms:.3f} ms (plain versions {draw_plain:.3f} ms), median of 20")
    print("profile of one sample_Y call (16 draws, D=78, M=100, B=512):")
    profile_breakdown(calls["sample_Y"][0])
    print("profile of one predict_Y call (D=78, M=100, B=512):")
    profile_breakdown(calls["predict_Y"][0])
    print(f"peak device memory of the serving phases {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches on the serving paths: {launches}")

    # ------------------------------------------------------------- training
    trained = training(ck, dsvi, cnmgp, predict, sim, dev, gen, smi)
    print(f"launches in one ECoG training epoch: {trained}")
    t0 = time.perf_counter()
    scanned = scan_epochs_phase(ck, dsvi, cnmgp, dev, smi)
    print(f"scan_epochs phase {time.perf_counter() - t0:.1f} s; launches {scanned}")
    trained200 = ecog_m200(ck, dsvi, cnmgp, dev, smi)
    witness = chol_inv_witness(ck, cnmgp, dev, smi)
    print(f"launches in one ECoG M=200 training epoch: {trained200}")
    t0 = time.perf_counter()
    options = dsvi_options(ck, dsvi, sim, dev, smi, checkpoint, optimizers)
    print(f"dsvi_options phase {time.perf_counter() - t0:.1f} s; launches {options}")
    for k in ck.KERNELS:
        launches[k] += trained[k] + scanned[k] + trained200[k] + options[k]

    # ------------------------------------------------------ fully Bayesian
    t0 = time.perf_counter()
    fb_launched, fb_metrics, svc_K, nuts_run = fb_svc_nuts(ck, dev, smi)
    print(f"SVC NUTS phase {time.perf_counter() - t0:.1f} s; launches {fb_launched}")
    t0 = time.perf_counter()
    pred_launched, pred_more = prediction_phase(ck, dev, smi, *nuts_run)
    print(f"prediction phase {time.perf_counter() - t0:.1f} s; launches {pred_launched}")
    fb = fb_kernel_checks(ck, gen, dev, svc_K)
    more = {"cholesky": cholesky_routes(ck, gen, dev, smi), "kron_mv": kron_layouts(ck, gen, dev, smi),
            "quadform_diag": qf_rows, "gibbs": gibbs_rows, "rbf": rbf_rows,
            "chol_inv": chol_inv_shapes(ck, torch.Generator(device=dev).manual_seed(9), dev, smi),
            "whitened_factors": whitened_rows(ck, dev, smi)}
    t0 = time.perf_counter()
    sn_launched = fb_snmgp(ck, dev, smi)
    print(f"SNMGP phase {time.perf_counter() - t0:.1f} s; launches {sn_launched}")
    t0 = time.perf_counter()
    ch_launched = fb_chees(ck, dev, smi)
    print(f"ChEES phase {time.perf_counter() - t0:.1f} s; launches {ch_launched}")
    t0 = time.perf_counter()
    smc_launched, smc_more = fb_smc(ck, dev, smi)
    print(f"SMC phase {time.perf_counter() - t0:.1f} s; launches {smc_launched}")
    t0 = time.perf_counter()
    rd_launched, rd_more = realdata_phases(ck, dsvi, cnmgp, dev, smi)
    print(f"real-data phases {time.perf_counter() - t0:.1f} s; launches {rd_launched}")
    t0 = time.perf_counter()
    md_launched, md_more = multidevice_phase(ck, dsvi, cnmgp, dev, smi)
    print(f"multidevice phase {time.perf_counter() - t0:.1f} s; launches {md_launched} (the "
          f"ranks' included)")
    for name, entries in (list(smc_more.items()) + list(pred_more.items()) + list(rd_more.items())
                          + list(md_more.items())):
        more[name] = more.get(name, []) + entries
    for k in ck.KERNELS:
        launches[k] += (fb_launched[k] + pred_launched[k] + sn_launched[k] + ch_launched[k]
                        + smc_launched[k] + rd_launched[k] + md_launched[k])
    for name, ((kern, plain, lib, inner, (b_ms, b_by)), _) in fb.items():
        k_ms = device_ms(kern, inner=inner)
        p_ms = device_ms(plain, inner=inner)
        l_ms = None if lib is None else device_ms(lib, inner=inner)
        times[name] = (k_ms, p_ms, l_ms, (b_ms, b_by))
        print(f"time {name}: kernel {k_ms:.4f} ms on the device, plain {p_ms:.4f} ms, library "
              f"{'n/a' if l_ms is None else f'{l_ms:.4f} ms'}, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / k_ms:.1%} of bound ({smi})")

    src = "collaborative_nonstationary_multivariate_gaussian_process_tpu_torch/csrc/"
    tpu = "collaborative_nonstationary_multivariate_gaussian_process_tpu/ops/pallas_kernels.py"
    tc_bounds = {}
    rows = [
        ("gibbs", f"{tpu}:94", max(gibbs_errs + [gibbs_err])),
        ("rbf", f"{tpu}:144", max(fb["rbf"][1], rbf_err)),
        ("kron_mv", f"{tpu}:189", fb["kron_mv"][1]),
        ("cholesky", f"{tpu}:273", fb["cholesky"][1]),
        ("chol_inv", f"{tpu}:357", max(chol_err, fb["chol_inv (4,200,200)"][1])),
        ("quadform_diag", f"{tpu}:578", max(qf_err, qf64_err)),
    ]
    for n, line in (("quadform_diag_dw", 648), ("quadform_diag_da", 667), ("quadform_diag_bwd", 636)):
        rows.append((n, f"{tpu}:{line}",
                     max(backward[n][1], backward200[n][1], backward_pm[n][1], backward78[n][1])))
        times[n] = backward[n][0]
        tc_bounds[n] = backward[n][2]
        k_ms, p_ms, l_ms, (b_ms, b_by) = backward200[n][0]
        earlier = [{"at": f"M={M_ECOG200}", "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                    "bound_ms": b_ms, "bound_by": b_by, **backward200[n][2]}]
        k_ms, p_ms, l_ms, (b_ms, b_by) = backward_pm[n][0]
        earlier.append({"at": f"PM2.5-sub G={D_PM * (D_PM - 1) // 2} M={M_PM} N={B_PM}",
                        "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                        "bound_by": b_by, **backward_pm[n][2]})
        k_ms, p_ms, l_ms, (b_ms, b_by) = backward78[n][0]
        earlier.append({"at": f"G={D_ECOG}", "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                        "bound_ms": b_ms, "bound_by": b_by, **backward78[n][2]})
        more[n] = earlier + more.get(n, [])
    kernels = []
    for n, r, e in rows:
        k_ms, p_ms, l_ms, (b_ms, b_by) = times[n]
        kernels.append({"name": n, "route": "cuda", "source": f"{src}{n}.cu", "replaces": r,
                        "launches": launches[n], "max_abs_err": e, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
                        **tc_bounds.get(n, {}), "more": more.get(n, [])})
    kernels[[k["name"] for k in kernels].index("chol_inv")]["witness"] = witness
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all, the build included ({smi})")
    print(json.dumps({"kernels": kernels}))
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        for f in FAILURES:
            print("  " + f, file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


def scan_main() -> int:
    """The scan_epochs phase alone (with the kernels' build):
    python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.scan_main())'"""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    ck.build(TRAIN_KERNELS)
    t0 = time.perf_counter()
    launched = scan_epochs_phase(ck, dsvi, cnmgp, torch.device("cuda"), smi)
    print(f"scan_epochs phase {time.perf_counter() - t0:.1f} s; launches {launched}")
    for f in FAILURES:
        print("FAILED: " + f)
    return 1 if FAILURES else 0


def witness_main() -> int:
    """The chol_inv witness phase alone, on the port package beside this
    script (a checkout of another commit, for a before-and-after):
    python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.witness_main())'"""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp
    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    ck.build(TRAIN_KERNELS)
    chol_inv_witness(ck, cnmgp, torch.device("cuda"), smi)
    return 1 if FAILURES else 0


def rbf_compare_main(parent: str = "build/parent_rbf.cu") -> int:
    """The RBF kernel of this tree against another build of it (`parent`, a
    `rbf.cu` with the same C entry, e.g. the parent commit's, unpacked into
    a directory that .gitignore lists), in turns parent, this, this, parent
    at every shape of RBF_PATH_SHAPES, and the share of equal entries:
    python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.rbf_compare_main())'"""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import ctypes

    from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    ck.build(("rbf",))
    lib = Path(parent).with_suffix(".so")
    subprocess.run([ck._nvcc(), *ck._NVCC_FLAGS, "-o", str(lib), parent], check=True,
                   capture_output=True)
    launch = ctypes.CDLL(str(lib.resolve())).rbf_launch
    launch.argtypes, launch.restype = ck._ARGTYPES["rbf"], ctypes.c_int

    def other(x1, x2, s2, ls):
        out = torch.empty((s2.shape[0], x1.shape[0], x2.shape[0]), device=x1.device)
        err = launch(x1.data_ptr(), x2.data_ptr(), s2.data_ptr(), ls.data_ptr(), out.data_ptr(),
                     s2.shape[0], x1.shape[0], x2.shape[0], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{parent}: the launch returned CUDA error {err}")
        return out

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    print(f"launch floor {device_ms(lambda: torch.cuda._sleep(8), inner=10):.5f} ms ({smi})")
    for S, n, m in RBF_PATH_SHAPES:
        span, pairs = RBF_PATH_INPUTS[(S, n, m)]
        x1 = span * torch.rand(n, device=dev, generator=gen)
        x2 = torch.linspace(0.0, span, m, device=dev) if n != m else x1
        pairs = pairs or ((1.0, 40.0),)
        s2, ls = (torch.tensor(v, device=dev) for v in zip(*pairs))
        this = lambda: ck.rbf_cuda(x1, x2, s2, ls)  # noqa: E731
        theirs = lambda: other(x1, x2, s2, ls)  # noqa: E731
        same = float((this() == theirs()).double().mean())
        t = [device_ms(f, inner=10) for f in (theirs, this, this, theirs)]
        print(f"time rbf ({S},{n},{m}): parent {t[0]:.5f} / {t[3]:.5f} ms, this tree {t[1]:.5f} / "
              f"{t[2]:.5f} ms; {same:.1%} of the entries equal ({smi})")
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
