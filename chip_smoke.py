#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one CUDA card, and check
them.

    python3 chip_smoke.py          (from the repository root; one CUDA card,
                                    nvcc and g++ on the machine)

Phases, each printed with its elapsed seconds; any failure raises and the
script exits non-zero:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the Hopper kernels (nvcc, sm_90a, one process per source) and the
   native parser/factorizer (g++), all at once, from this checkout;
3. stencil kernel parity: B1 and B2 against their plain PyTorch twins on the
   card, in f32 and f64, at the mat10000-sized layout and at the flagship
   layout, bitwise, and the same over two launches; times of kernel, twin
   and the library call and each
   kernel's bound (see "Times" below); a small f64 solve on the card
   against the same solve on the CPU (plain twins);
4. main path 1, the flagship: grid_laplacian(100000, 100) (10M rows),
   Neumann-ILU k=4, MILU omega 0.96, f32, tol 1e-4 — solved twice, then
   refined to a true f64 relative residual <= 1e-6; the launch counts must
   show that B1 and B2 carried every matvec and msolve; then the cost of
   the solver's per-iteration host poll, and a torch.profiler trace of 30
   iterations split into the stencil kernel, the msolve kernels, the dots,
   the elementwise passes, other device work and idle;
5. banded trisolve parity: B4a and B4b (forward and backward) against their
   sequential twins and the chunked plain version of their algorithm in
   f32 and f64 at the mat10000 layout and the 1M-row layout, within 1e-5
   (f32) / 1e-12 (f64) of max|twin|, two launches bitwise equal; the plans
   (m, P); times and bounds as in 3, the chunked design's byte floor
   (printed) and each of B4b's three launches inside whole sweeps (a
   torch.profiler trace);
6. main path 2, the reference's default solve: exact ILU(0) BiCGSTAB
   (bicgstab_lu_precond) on data/mat900.mtx and data/mat10000.mtx on the
   card and on the CPU, in f64 and f32, against the goldens; refinement of
   mat10000 through an f32 ILU(0) solver; the 1M-row
   grid_laplacian(10000, 100) solved once in f64 and twice in f32;
7. banded DIA parity: B3 against its twin, bitwise, in f32 and f64, with
   both pad blocks checked zero, at mat3's layout, at the 10M-row grid's
   DIA and restrided-factor layouts and at the bench's 10M-row
   banded_laplacian_dia(3163) layout; B3's time there beside its twin,
   its bound and torch.mv of the same matrix in sparse CSR; A·x and M⁻¹x of
   the two 10M configurations below, equal element for element;
8. main path 3, banded DIA: the reference's plain and split entry points
   (bicgstab, bicgstab_split) and Jacobi on mat3 and mat10000, card
   against CPU and the goldens, in f64; then grid_laplacian(100000, 100)
   with exact-factor Neumann-ILU k=3, f32, tol 1e-4, as format="pallas_dia"
   (A and the factors on B3) and on the stencil layout (A on B1, the
   restrided factors on B3), each solved twice;
9. fusion kernel parity: B5 (the BLAS1-prologue msolve, three and two
   input streams, three scalar pairs) and B6 (B1 with dots in its epilogue
   and their sum in the same launch, with and without <y, y>) against their
   twins, bitwise, pad blocks zero, the same over two launches, in f32 and
   f64, at the mat10000 layout and at the flagship's fuse_blas1 layout; B6
   also equal to B1; times and bounds, beside B6 the device time of the
   unfused sequence it replaces (B1, then torch.dot for each dot), and B2's,
   B5's and B6's f64 device times (reported, not gated); B1 on the mono
   preconditioner's 37 terms against its twin;
10. main path 4a, the flagship with the loop's opt-in fusions: a
   fuse_blas1 solver's solves (i) fuse_blas1 and (ii) fuse_blas1 +
   fused_dots + check_halves=False, and on path 1's solver (iii) fused_dots
   and (iv) check_halves=False; the launches show B5 and B6 carrying every
   msolve and matvec of their loops; (ii) refined to <= 1e-6; then a
   prefer_mono solve of the mat10000 grid, card against CPU, in f64 (its
   37-term B1 stencil is checked against B1's twin in phase 9); after the
   path's launch counts are read, a profile of 30 iterations of (i) and of
   (iii) as in 4;
11. 2-D stencil parity: B7 (StencilOperator2D) against its twin, bitwise,
   ring zero, the same over two launches, in f32 and f64, constant and
   variable coefficients, at the 3163 x 3163 grid, and its A x equal to
   B1's on the same grid, B1 there against its own twin; times and bounds
   of both in f32 and f64 (f64 is path 4b's dtype) and torch.mv of the
   same matrix in sparse CSR;
12. main path 4b, StencilOperator2D in place of a matrix: the mat10000 grid
   solved by the h-form loop in both modes, card against CPU and the golden;
   then the 3163 x 3163 grid (10M rows) in f64, tol 1e-6, on B7 beside
   bicgstab of grid_laplacian(3163, 3163) on B1; after the path's launch
   counts are read, a profile of 30 iterations of each loop as in 4;
13. main path 5, the unpadded operators (make_operator, stock torch ops,
   no kernel of this repository), with TF32 off and float32 matmul
   precision "highest" asserted first:
   5a the CLI's default random system, random_diag_nonzero_system(10000,
   0.99, seed=0), b = ones: make_operator picks ELL; each of ell, csr,
   bell, dense and the automatic choice in f32 and f64 against the host
   f64 product (1e-5 / 1e-12 of max|y|), two calls bitwise equal, times
   (ms, device_ms), the byte bound and torch.mv of the sparse CSR matrix;
   then solve(precond="none", f32, tol 1e-4) in each format, twice on the
   card and once on the CPU: BREAKDOWN in 2..191 iterations (the
   reference's behaviour on this system; the iteration moves with the
   sum order), and each solve stopped after one iteration within 1e-4 of
   the f64 one's;
   5b the shuffled banded_laplacian(1000) (1M rows, numbered at random):
   ELL's matvec as in 5a; (i) Jacobi on ELL, f64, tol 1e-6, twice:
   CONVERGED in 1165..1800 iterations, the two bitwise equal; (ii)
   reorder="rcm" + ilu0_neumann k=3 (factors as unpadded operators),
   f64, tol 1e-6: CONVERGED in 370..560; both to a true residual ≤ 2e-6;
   (iii) (ii) in f32 at tol 1e-4,
   then solve_refined through it (reported); the launch counts of 5a-5b
   show no kernel B1-B7;
   5c the generic blocked trisolve: exact ILU(0) of mat10000 at
   trisolve_block=64 and of mat900 at 16, f64, card against CPU and the
   goldens, twice each (the first solve's ms/iter beside the second's);
   reorder="rcm" + exact ILU(0), B=128, on the shuffled
   banded_laplacian(316), once after a warm-up msolve, with the parts of
   its setup;
   5d bicg on mat900 and mat10000, f64, card against CPU and the goldens;
   5e bicgstab_split of mat10000's split form as format="csr", card
   against CPU and the golden.

Times: a kernel's ``ms`` is the median time between CUDA events around one
call of its front end, the host's work in between included (as twins and
library calls are timed); ``device_ms`` beside it is its device time alone
(one call captured in a CUDA graph, the mean over 50 replays).  The line before last is a JSON object with each kernel's
launches, error, times and bound; the last line is {"ok": true, "device":
{...}}.
"""

import contextlib
import dataclasses
import faulthandler
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.formats import reorder
from cuda_mat_tpu_torch.models import problems
from cuda_mat_tpu_torch.native import loader as native
from cuda_mat_tpu_torch.ops import _kernels
from cuda_mat_tpu_torch.ops import banded_trisolve as bt
from cuda_mat_tpu_torch.ops import dia_spmv as ds
from cuda_mat_tpu_torch.ops import operators as ops
from cuda_mat_tpu_torch.ops import stencil as st
from cuda_mat_tpu_torch.ops import stencil2d as t2d
from cuda_mat_tpu_torch.ops import trisolve as tri_mod
from cuda_mat_tpu_torch.precond import preconditioners as pre_mod
from cuda_mat_tpu_torch.solvers import bicgstab as bs
from cuda_mat_tpu_torch.utils.timing import PhaseTimer

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = (100000, 100)      # grid rows, cols: 10M rows, 50M nonzeros
ITERS = (33, 63)              # the flagship's 48 iterations (a TPU run) ± 15
FLAGSHIP_CFG = ct.SolverConfig(maxit=2000, tol=1e-4, dtype="float32",
                               precond="ilu0_neumann", neumann_terms=4,
                               milu_omega=0.96)
SMALL = (100, 100)            # the mat10000 grid
ONE_M = (10000, 100)          # 1M rows, bandwidth 100
# exact ILU(0), B=128, b = ones, tol 1e-4: the JAX package's CPU solves of
# grid_laplacian(R, 100), R = 500..5000, take 70-88 iterations in f32 and
# f64 (tests/test_torch_ilu_scan.py; at R = 10000 not run); 80 ± 30.
# BASELINE.md's 118 at 1M rows was taken under another RHS/tolerance
# protocol (BASELINE.md:123), so it anchors nothing here.
ONE_M_ITERS = (50, 110)
ILU_GOLDEN = {"mat900": 10, "mat10000": 45}   # tests/goldens/*_ilu.npz
ILU_SLACK = {"float64": {"mat900": 2, "mat10000": 6},
             "float32": {"mat900": 10, "mat10000": 15}}
TRISOLVE_BOUND = {torch.float32: 1e-5, torch.float64: 1e-12}
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 peak
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
STENCIL_SRC = "cuda_mat_tpu_torch/csrc/const_stencil.cu"
TRISOLVE_SRC = "cuda_mat_tpu_torch/csrc/banded_trisolve.cu"
DIA_SRC = "cuda_mat_tpu_torch/csrc/dia_spmv.cu"
STENCIL2D_SRC = "cuda_mat_tpu_torch/csrc/stencil2d.cu"
BENCH_SIDE = 3163             # banded_laplacian_dia(3163): bench.py's 10M SpMV
# exact-factor Neumann k=3, f32, tol 1e-4, b = ones: the port's CPU solves
# of grid_laplacian(R, 100) at 50k-1M rows take 95-110 iterations in both
# configurations (tests/test_torch_neumann_scan.py), flat in n; TPU runs at
# 10M rows (another RHS protocol) took 82 and 79.
NEUMANN_ITERS = (60, 300)
HFORM_GOLDEN = {"mat10000": 115, "mat10000_split": 117}   # tests/goldens
HFORM_SLACK = 6               # the goldens' h-form slack, also card vs CPU
DEMO_X = [7 / 6, 17 / 3, -23 / 6]
KERNELS = {
    "const_stencil_spmv": (STENCIL_SRC,
                           "cuda_mat_tpu/ops/pallas_stencil.py:306"),
    "const_series_msolve": (STENCIL_SRC,
                            "cuda_mat_tpu/ops/pallas_stencil.py:624"),
    "banded_fused_msolve": (TRISOLVE_SRC,
                            "cuda_mat_tpu/ops/pallas_trisolve.py:149"),
    "banded_sweep": (TRISOLVE_SRC, "cuda_mat_tpu/ops/pallas_trisolve.py:73"),
    "dia_spmv": (DIA_SRC, "cuda_mat_tpu/ops/pallas_spmv.py:75"),
    "const_series_msolve_fma": (STENCIL_SRC,
                                "cuda_mat_tpu/ops/pallas_stencil.py:681"),
    "const_stencil_spmv_dots": (STENCIL_SRC,
                                "cuda_mat_tpu/ops/pallas_stencil.py:416"),
    "stencil2d_spmv": (STENCIL2D_SRC,
                       "cuda_mat_tpu/ops/pallas_stencil.py:101"),
}
FMA_PAIRS = [(0.73, -1.21), (-0.4, 0.0), (0.0, 5.0)]   # test_neumann.py:265
# the h-form loop on grid_laplacian(s, s), f64, tol 1e-6, b = x0 = ones
# (tests/test_torch_hform_scan.py): the port's CPU solves take 120 / 350 /
# 1203 iterations at s = 100 / 300 / 1000; on an H100 B1 takes 1214 / 2501
# / 3615 / 5200 and B7 1342 / 2560 / 3411 / 5248 at s = 1000 / 2000 / 2500
# / 3163 (the count per grid row grows with s, 1.2 to 1.6); 5200 ± 20%,
# and the two kernels' counts, whose dots sum in other orders, at most 15%
# apart
HFORM_10M_ITERS = (4200, 6300)
HFORM_10M_APART = 0.15
PROFILE_ITERS = 30            # iterations of a loop_split profile
# path 5.  The CLI's default system (cli.py:149-150) breaks down unrefined,
# as the reference's does, at an iteration set by rounding alone: the JAX
# package's CPU f32 solves read 31 / 43 / 25 (ELL / CSR / BELL), and 2-191
# over its four formats on 16 symmetric renumberings P·A·Pᵀ, the same system
# in other sum orders (CSR 11-92, ELL 16-191, BELL 2-102, dense 13-153;
# tests/test_torch_unpadded_scan.py renumbered random 10000 16); the port's
# CPU solves 8-74 there, an H100 36 (ELL), 9 (CSR), 38 (BELL, dense).  The
# window is the reference's range.  The first iterate is held instead:
# rounding moves it little (the port's f32 one 1.3e-6 to 6.2e-6 of max|x|
# from the f64 one on the CPU over four renumberings;
# tools/renumbered_spread.py random 10000 4 cpu)
RANDOM_SYSTEM = (10000, 0.99)
BREAKDOWN_ITERS = (2, 191)
FIRST_ITERATE_TOL = 1e-4
UNPADDED = ("ell", "csr", "bell", "dense", None)   # None: make_operator's
MATVEC_BOUND = {torch.float32: 1e-5, torch.float64: 1e-12}
# the shuffled banded_laplacian(1000): the JAX package's CPU f64 solves take
# 1482 (Jacobi) and 460 (RCM + Neumann k=3) iterations; its Jacobi 1165-1367
# on six renumberings (tests/test_torch_unpadded_scan.py renumbered shuffled
# 1000 6), the port's 1175-1345 there on the CPU, 1197 on an H100: the count
# moves with the sum order.  The window's lower end is the reference's
# lowest; what does not move is the true residual
SHUFFLED_SIDE = 1000
JACOBI_1M_ITERS = (1165, 1800)
TRUE_RESIDUAL_1M = 2e-6       # both 1M f64 solves stop at tol 1e-6
NEUMANN_1M_ITERS = (370, 560)
BLOCKED_SIDE = 316            # 99,856 rows, band 316 after RCM > B = 128
BLOCKED_JAX_ITERS = 136       # the JAX package's CPU f64 solve
BICG_GOLDEN = {"mat900": 35, "mat10000": 158}    # tests/goldens/*_bicg.npz


@contextlib.contextmanager
def phase(timer, name):
    """A timed phase that ends with a device synchronise; prints its time."""
    with timer.phase(name, DEVICE):
        yield
    print(f"[phase] {name}: {timer.times[name]:.3f} s", flush=True)


def cuda_ms(fn, reps=20):
    """Median time in ms between CUDA events recorded before and after one
    call of ``fn`` (after one warm-up call): the card's time from the
    call's first launch to its last, and the host's work between them."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms(fn, reps=50):
    """Device time of one call of ``fn`` in ms: the call captured once in a
    CUDA graph (after a warm-up on the side stream that captures it), then
    ``reps`` replays back to back between two CUDA events.  Unlike cuda_ms
    it leaves out the host's work between launches, which for a short
    kernel behind a Python front end is most of cuda_ms."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_times(fn):
    """``{"ms": cuda_ms(fn), "device_ms": device_ms(fn)}``: the time from
    launch to launch of the kernel's front end (host work included), and
    the kernel's own time on the card."""
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn)}


def poison_allocator(like):
    """Leave a NaN-filled block of ``like``'s size in the caching allocator,
    so the next torch.empty of that size is likely to get it: an output
    element a kernel fails to write then shows as NaN."""
    torch.full_like(like, float("nan"))


def poison_dots(x, n_dots):
    """poison_allocator for B6's y and for its partials and dots, one
    allocation of n_dots per DOTS_BLOCK rows and the n_dots sums: a
    partial or a dot the kernel fails to write shows as NaN."""
    poison_allocator(x)
    torch.full((x.numel() // _kernels.DOTS_BLOCK * n_dots + n_dots,),
               float("nan"), dtype=x.dtype, device=x.device)


def bound(nbytes, flops):
    """The least time the card could take: the larger of the bytes over the
    HBM peak and the f32 operations over the f32 peak, in ms."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def torch_csr(indptr, indices, data, n, dtype):
    """A torch sparse CSR matrix on the card (the library calls' operand)."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(np.asarray(indptr, np.int32)),
        torch.from_numpy(np.asarray(indices, np.int32)),
        torch.from_numpy(np.asarray(data)).to(dtype), size=(n, n)).to(DEVICE)


def library_time(stats, name, call, label, check):
    """Time one PyTorch call computing the kernel's function (it is used
    nowhere in the port), from launch to launch as a kernel's ``ms``.
    ``check(out)`` returns its difference from the kernel, printed.  A
    call the installed torch refuses is recorded as ``none: <error>``."""
    try:
        out = call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        stats[name].update(library_ms=None, library=f"none: {e}"[:300])
        print(f"{name} library call {label}: none ({e})"[:400], flush=True)
        return
    ms = cuda_ms(call)
    stats[name].update(library_ms=ms, library=label)
    print(f"{name} library call {label}: {ms:.4f} ms (launch to launch),"
          f" max|library - kernel| / max|kernel| = {check(out)!r}",
          flush=True)


def kernel_parity(ps, dtype, tag, stats, timed):
    op, pre = ps.op, ps.pre
    if pre.fused != "kernel":
        raise RuntimeError(f"{tag}: preconditioner fell back to"
                           f" fused={pre.fused!r}; kernel B2 would not run")
    rng = np.random.default_rng(0)
    x = op.pad_vec(rng.standard_normal(op.n)).to(dtype)
    gap = op.gapmask.to(dtype)
    inv_d, gap_ext = pre.inv_d.to(dtype), pre.gap_ext.to(dtype)
    spmv_args = (gap, op.strided_terms, op.np_true, op.block, op.sub)
    ms_args = (inv_d, gap_ext, pre.nl.strided_terms, pre.nu.strided_terms,
               op.np_true, op.block, op.sub)
    cases = {
        "const_stencil_spmv": (
            lambda: st.const_stencil_spmv_padded(x, *spmv_args),
            lambda: st.const_stencil_spmv_padded_plain(x, *spmv_args)),
        "const_series_msolve": (
            lambda: st.const_series_msolve_padded(x, *ms_args),
            lambda: st.const_series_msolve_padded_plain(x, *ms_args)),
    }
    for name, (kern, plain) in cases.items():
        poison_allocator(x)
        yk = kern()
        poison_allocator(x)
        yk2 = kern()
        yp = plain()
        torch.cuda.synchronize()
        if not torch.isfinite(yk).all():
            raise RuntimeError(f"{tag} {name}: non-finite kernel output")
        if not torch.equal(yk, yk2):
            raise RuntimeError(f"{tag} {name}: two launches differ")
        err = float((yk - yp).abs().max())
        line = (f"{tag} {str(dtype)[6:]} {name}: max|kernel - twin| ="
                f" {err!r}, two launches equal")
        if timed:
            t, pms = kernel_times(kern), cuda_ms(plain)
            stats[name].update(**t, plain_ms=pms)
            line += (f", kernel {t['ms']:.4f} ms (device"
                     f" {t['device_ms']:.4f}), twin {pms:.4f} ms")
        print(line, flush=True)
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        if err != 0.0:
            raise RuntimeError(f"{tag} {name}: kernel differs from its twin"
                               f" (max abs {err!r}; bitwise required)")
    if timed:
        # B2: each padded vector read once and written once, plus the mask
        vec = x.numel() * x.element_size()
        n2 = len(pre.nl.strided_terms) + len(pre.nu.strided_terms)
        stats["const_stencil_spmv"].update(spmv_bound(
            x, gap, op.strided_terms, op.np_true, op.block))
        stats["const_series_msolve"].update(bound(
            3 * vec + gap_ext.numel() * gap_ext.element_size(),
            (2 * n2 + 2) * op.npad))
        for k in ("const_stencil_spmv", "const_series_msolve"):
            print(f"{k}: bound {stats[k]['bound_ms']:.4f} ms"
                  f" ({stats[k]['bound_by']})", flush=True)


def stencil_library(a, ps, stats):
    """B1's library yardstick: torch.mv of the sparse CSR matrix (cuSPARSE
    SpMV) on the same f32 vector, in true coordinates."""
    x = np.random.default_rng(0).standard_normal(a.n)
    xk = ps.op.pad_vec(x)
    y_k = ps.op.unpad_vec(st.const_stencil_spmv_padded(
        xk, ps.op.gapmask, ps.op.strided_terms, ps.op.np_true, ps.op.block,
        ps.op.sub))
    a_t = torch_csr(a.indptr, a.indices, a.data, a.n, torch.float32)
    x_t = torch.from_numpy(x).to(torch.float32).to(DEVICE)
    library_time(stats, "const_stencil_spmv", lambda: torch.mv(a_t, x_t),
                 "torch.mv(sparse CSR A, x)",
                 lambda y: float((y - y_k).abs().max() / y_k.abs().max()))
    stats["const_series_msolve"].update(
        library_ms=None, library="none: no one PyTorch call computes the"
        " Neumann-series polynomial msolve")


def poll_cost(ps, b, iters):
    """ms per iteration of ``iters`` solver steps with and without the
    per-iteration status poll, and the host's enqueue time per iteration
    (each read from the second of two runs)."""
    c = bs.loop_constants(torch.float32, ps.device, 1e-4)
    bd, x0 = ps.op.pad_vec(b), ps.op.pad_vec(np.ones(ps.n))
    out = {}
    for poll in (True, False, True, False):
        s = bs.precond_init(ps.op.matvec, torch.dot, x0, bd, iters, c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            s = bs.precond_step(ps.op.matvec, ps.pre.msolve, torch.dot, s, i,
                                c)
            if poll:
                torch.stack([s.status, s.i]).tolist()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out["poll" if poll else "no_poll"] = (t2 - t0) * 1e3 / iters
        if not poll:
            out["enqueue"] = (t1 - t0) * 1e3 / iters
    return out


# device kernels by name: which part of an iteration each one is (the first
# part whose words the name holds)
SPLIT_PARTS = (("spmv_dots", ("spmv_dots",)),
               ("stencil", ("const_stencil_spmv", "stencil2d")),
               ("msolve", ("msolve", "banded", "chunk_", "dia_spmv")),
               ("dots", ("dot", "reduce")),
               ("elementwise", ("elementwise",)))


def loop_split(tag, run):
    """Profile ``run()`` (a solve cut to a few iterations) with
    torch.profiler and print each iteration's device split: B6, the stencil
    kernel, the msolve kernels, the dots, the elementwise passes, other
    device work, and idle (the span from the first device event to the last
    that no event covers).  The trace goes to cuda_mat_tpu_torch/build/
    (git-ignored)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        r = run()
        torch.cuda.synchronize()
    out = os.path.join(ROOT, "cuda_mat_tpu_torch", "build")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "trace_" + "".join(
        ch if ch.isalnum() else "_" for ch in tag) + ".json")
    prof.export_chrome_trace(path)
    print(f"{tag} profile, {r.iters} iterations, ms/iter:"
          f" {trace_split(path, r.iters)}; trace {path}", flush=True)


def trace_split(path, iters):
    """Each iteration's device split in a chrome trace of ``iters``
    iterations of a loop (see loop_split), as printable text."""
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"]
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and "dur" in e]
    kern = [e for e in evs if e["cat"] == "kernel"]
    if not kern:
        return "no device kernels in the trace"
    # the loop's window: from the last upload (b and x0) or the first
    # kernel to the last kernel, so the download of x after it stays out
    w0 = max([min(e["ts"] for e in kern)]
             + [e["ts"] + e["dur"] for e in evs if "HtoD" in e["name"]])
    w1 = max(e["ts"] + e["dur"] for e in kern)
    parts = {k: 0.0 for k, _ in SPLIT_PARTS}
    parts["other"] = 0.0
    spans = []
    for e in evs:
        t0, t1 = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t1 <= t0:
            continue
        name = e["name"].lower()
        part = next((k for k, keys in SPLIT_PARTS
                     if any(w in name for w in keys)), "other")
        parts[part] += t1 - t0
        spans.append((t0, t1))
    busy, end = 0.0, w0
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    window = w1 - w0
    it = max(iters, 1)
    split = ", ".join(f"{k} {v / 1e3 / it:.4f}" for k, v in parts.items())
    return (f"{split}, idle {(window - busy) / 1e3 / it:.4f} of"
            f" {window / 1e3 / it:.4f} ({(window - busy) / window:.1%}"
            " idle)")


def band_sides(csr):
    """The lower and upper bandwidths of ``csr`` (and of its ILU(0)
    factor, which has its pattern): max(row - col), max(col - row)."""
    offs = csr.indices.astype(np.int64) - np.repeat(
        np.arange(csr.n, dtype=np.int64), csr.row_lengths)
    return int(max(-offs.min(), 0)), int(max(offs.max(), 0))


def trisolve_parity(tri, csr, tag, stats, timed):
    """B4a and B4b (forward, backward) against their sequential twins and
    against the chunked plain version of the kernel's algorithm on
    ``tri``'s arrays and plans (the factor of ``csr``), within
    TRISOLVE_BOUND of max|twin|; padded rows zero; two launches equal bit
    for bit.  ``timed``: kernel and twin times, the bound, the design's own
    byte floor and each phase's time."""
    dtype = tri.wt_lo.dtype
    f = tri._pad(torch.from_numpy(
        np.random.default_rng(1).standard_normal(tri.n)).to(DEVICE))
    lo, up = (tri.wt_lo, tri.wct_lo), (tri.wt_up, tri.wct_up)
    plans = (tri.plan_lo, tri.plan_up)
    print(f"{tag} {str(dtype)[6:]} plans: nb {tri.wt_lo.shape[0]}, B"
          f" {tri.block}, bw {plans[0].bw}/{plans[1].bw}, triangles"
          f" {plans[0].tri}/{plans[1].tri}, m {plans[0].m}, P"
          f" {plans[0].chunks}", flush=True)

    def chunked_msolve():
        y = bt.banded_sweep_chunked_plain(f, *lo, plans[0], True)
        return bt.banded_sweep_chunked_plain(y, *up, plans[1], False)

    cases = [
        ("banded_fused_msolve", "",
         lambda: bt.fused_msolve_padded(f, *lo, *up, plans),
         lambda: bt.fused_msolve_padded_plain(f, *lo, *up), chunked_msolve),
        ("banded_sweep", " forward",
         lambda: bt.banded_sweep_padded(f, *lo, True, plans[0]),
         lambda: bt.banded_sweep_padded_plain(f, *lo, True),
         lambda: bt.banded_sweep_chunked_plain(f, *lo, plans[0], True)),
        ("banded_sweep", " backward",
         lambda: bt.banded_sweep_padded(f, *up, False, plans[1]),
         lambda: bt.banded_sweep_padded_plain(f, *up, False),
         lambda: bt.banded_sweep_chunked_plain(f, *up, plans[1], False)),
    ]
    for name, what, kern, plain, chunked in cases:
        poison_allocator(f)
        yk = kern()
        poison_allocator(f)
        yk2 = kern()
        yp, yc = plain(), chunked()
        torch.cuda.synchronize()
        if not torch.isfinite(yk).all():
            raise RuntimeError(f"{tag} {name}{what}: non-finite kernel output")
        if torch.count_nonzero(yk[tri.n:]):
            raise RuntimeError(f"{tag} {name}{what}: padded rows not zero")
        if not torch.equal(yk, yk2):
            raise RuntimeError(f"{tag} {name}{what}: two launches differ")
        top = float(yp.abs().max())
        err = float((yk - yp).abs().max())
        rel, rel_c = err / top, float((yk - yc).abs().max()) / top
        line = (f"{tag} {str(dtype)[6:]} {name}{what}: max|kernel - twin| ="
                f" {err!r} ({rel!r} of max|twin|), against the chunked plain"
                f" version {rel_c!r}; two launches bitwise equal")
        if timed and what != " backward":
            t = kernel_times(kern)
            pms = cuda_ms(plain, reps=5)
            cms = cuda_ms(chunked, reps=5)
            stats[name].update(**t, plain_ms=pms, chunked_plain_ms=cms)
            line += (f", kernel {t['ms']:.4f} ms (device"
                     f" {t['device_ms']:.4f}), twin {pms:.4f} ms (median of"
                     f" 5), chunked plain {cms:.4f} ms")
        print(line, flush=True)
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        if not max(rel, rel_c) <= TRISOLVE_BOUND[dtype]:
            raise RuntimeError(f"{tag} {name}{what}: kernel differs from its"
                               f" twin by {rel!r} and from the chunked plain"
                               f" version by {rel_c!r} of max|twin| (bound"
                               f" {TRISOLVE_BOUND[dtype]})")
    if timed:
        nb, blk, item = tri.wt_lo.shape[0], tri.block, f.element_size()
        vec = f.numel() * item
        # the entries a sweep must read per block: Wt[b], the inverse of a
        # triangular block, is triangular, and only `bandwidth` rows of
        # WCt[b] are nonzero (the last ones forward, the first backward)
        w_lo, w_up = band_sides(csr)
        ent = [nb * (blk * (blk + 1) // 2 + w * blk) for w in (w_lo, w_up)]
        stats["banded_fused_msolve"].update(bound(sum(ent) * item + 2 * vec,
                                                  2 * sum(ent)))
        stats["banded_sweep"].update(bound(ent[0] * item + 2 * vec,
                                           2 * ent[0]))
        # beside it, for comparison: the dense arrays read whole, and only
        # the entries of this run's arrays that are not zero
        nnz = [int(torch.count_nonzero(w)) for w in (tri.wt_lo, tri.wct_lo,
                                                      tri.wt_up, tri.wct_up)]
        # and the chunked design's own floor: Wt's triangle once, the carry
        # rows twice (phases 1 and 3), T once, f read, y written, g written
        # and read again
        floor = [(nb * (blk * (blk + 1) // 2 + 2 * p.bw * blk)
                  + p.chunks * p.bw * p.bw) * item + 4 * vec for p in plans]
        floor_ms = [b / HBM_BYTES_PER_S * 1e3 for b in floor]
        for k, arrays, fl in (("banded_fused_msolve", 4, sum(floor_ms)),
                              ("banded_sweep", 2, floor_ms[0])):
            dense_ms, nnz_ms = (
                (entries * item + 2 * vec) / HBM_BYTES_PER_S * 1e3
                for entries in (arrays * nb * blk * blk, sum(nnz[:arrays])))
            print(f"{tag} {k}: bound {stats[k]['bound_ms']:.4f} ms"
                  f" ({stats[k]['bound_by']}; structural nonzeros,"
                  f" bandwidths {w_lo}/{w_up}); the chunked design's byte"
                  f" floor {fl:.4f} ms; its"
                  f" {arrays} (nb, B, B) arrays read whole: {dense_ms:.4f}"
                  f" ms; their nonzero entries alone: {nnz_ms:.4f} ms",
                  flush=True)
        phase_times(f, tri, tag, stats)


def sweep_launch_ms(sweep, reps=20):
    """Device times of the three launches of ``sweep()`` (phases 1, 2, 3),
    each the median over the sweeps of one torch.profiler trace of
    ``reps`` sweeps, and the number of sweeps found.  A sweep is a walk, a
    carry and a walk launch in a row; the last ``reps`` such triples in the
    trace are used.  Times None where the trace holds no such triple."""
    sweep()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            sweep()
        torch.cuda.synchronize()
    runs = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "chunk_" in e.name)
    kinds = ["chunk_walk_kernel", "chunk_carry_kernel", "chunk_walk_kernel"]
    sweeps, i = [], 0
    while i + 3 <= len(runs):
        if all(k in r[1] for k, r in zip(kinds, runs[i:i + 3])):
            sweeps.append([r[2] for r in runs[i:i + 3]])
            i += 3
        else:
            i += 1
    sweeps = sweeps[-reps:]
    if not sweeps:
        return None, len(runs)
    return [statistics.median(t[k] for t in sweeps) / 1e3
            for k in range(3)], len(sweeps)


def phase_times(f, tri, tag, stats):
    """Each of B4b's three launches inside whole sweeps, both directions
    (``sweep_launch_ms``); the forward sweep's go into B4b's stats."""
    for fw, wt, wct, plan in ((True, tri.wt_lo, tri.wct_lo, tri.plan_lo),
                              (False, tri.wt_up, tri.wct_up, tri.plan_up)):
        ms, found = sweep_launch_ms(lambda: bt.banded_sweep_padded(
            f, wt, wct, fw, plan))
        key = "forward" if fw else "backward"
        what = (f"not measured ({found} chunk kernels in the trace, no"
                f" walk-carry-walk triple)" if ms is None else
                ", ".join(f"{t:.4f}" for t in ms)
                + f" ms (median of {found} sweeps)")
        print(f"{tag} {str(f.dtype)[6:]} banded_sweep {key} launches (1 all"
              f" chunks from zero, 2 the carries, 3 the rerun; profiler"
              f" device times): {what}", flush=True)
        if fw:
            stats["banded_sweep"].pop("phase_ms", None)
            if ms is not None:
                stats["banded_sweep"]["phase_ms"] = ms


def trisolve_library(a, tri, stats):
    """B4a's and B4b's library yardsticks: torch.triangular_solve with the
    sparse CSR factors (cuSPARSE's triangular solve, the reference's route,
    pbicgstab.cu:92-98) — unit lower L then upper U for the msolve, L alone
    for one (forward) sweep."""
    m = native.ilu0_factorize(a)
    rows = np.repeat(np.arange(a.n), a.row_lengths)
    factors = []
    for keep in (a.indices < rows, a.indices >= rows):
        indptr = np.concatenate([[0], np.cumsum(np.bincount(
            rows[keep], minlength=a.n))])
        factors.append(torch_csr(indptr, a.indices[keep], m[keep], a.n,
                                 tri.wt_lo.dtype))
    lo, up = factors
    f = torch.from_numpy(np.random.default_rng(1).standard_normal(a.n)).to(
        tri.wt_lo.dtype).to(DEVICE)
    x_k, y_k = tri.msolve(f), tri.solve_lower(f)

    def lower():
        return torch.triangular_solve(f.view(-1, 1), lo, upper=False,
                                      unitriangular=True).solution

    def both():
        return torch.triangular_solve(lower(), up, upper=True).solution

    def rel(k):
        return lambda v: float((v.view(-1) - k).abs().max() / k.abs().max())

    library_time(stats, "banded_fused_msolve", both,
                 "torch.triangular_solve(sparse CSR L) then (U)", rel(x_k))
    library_time(stats, "banded_sweep", lower,
                 "torch.triangular_solve(sparse CSR L)", rel(y_k))


def counts():
    return {"const_stencil_spmv": st.const_stencil_spmv_padded.launches,
            "const_series_msolve": st.const_series_msolve_padded.launches,
            "banded_fused_msolve": bt.fused_msolve_padded.launches,
            "banded_sweep": bt.banded_sweep_padded.launches,
            "dia_spmv": ds.dia_spmv_block_padded.launches,
            "const_series_msolve_fma":
                st.const_series_msolve_fma_padded.launches,
            "const_stencil_spmv_dots":
                st.const_stencil_spmv_dots_padded.launches,
            "stencil2d_spmv": t2d.stencil_spmv_padded.launches}


def reset_counts():
    st.reset_launch_counts()
    bt.reset_launch_counts()
    ds.reset_launch_counts()
    t2d.reset_launch_counts()


def check_counted(path, got, kernels):
    print(f"{path} launches: {got}", flush=True)
    for k in kernels:
        if got[k] < 1:
            raise RuntimeError(f"{path}: kernel {k} was never launched")


def reference_solves(cfg, dev):
    """bicgstab_lu_precond on mat900 and mat10000, card against CPU and the
    goldens, f64 then f32 (path 2)."""
    mats = {}
    for name in ("mat900", "mat10000"):
        mats[name] = ct.load_mm_sparse_matrix(
            os.path.join(ROOT, "data", f"{name}.mtx"))
    for dtype in ("float64", "float32"):
        for name, a in mats.items():
            c = cfg.replace(dtype=dtype)
            b = np.ones(a.n)
            r = ct.bicgstab_lu_precond(a, b, c)
            slack = ILU_SLACK[dtype][name]
            line = (f"{name} {dtype} exact ILU(0): card {r.status.name}"
                    f" {r.iters} it (golden {ILU_GOLDEN[name]}), dtAlg"
                    f" {r.dt_alg * 1e3:.3f} ms, true residual"
                    f" {r.residual_true!r}")
            if not (r.converged and abs(r.iters - ILU_GOLDEN[name]) <= slack
                    and np.isfinite(r.x).all()):
                raise RuntimeError(line + " — outside the golden window")
            if dtype == "float64":
                rc = ct.bicgstab_lu_precond(a, b, c, device="cpu")
                dx = float(np.linalg.norm(r.x - rc.x) / np.linalg.norm(rc.x))
                line += (f"; cpu {rc.status.name} {rc.iters} it, |x diff|/|x|"
                         f" = {dx!r}")
                if not (rc.converged and abs(r.iters - rc.iters) <= 2
                        and dx <= 1e-8):
                    raise RuntimeError(line + " — card and CPU disagree")
            print(line, flush=True)
    a = mats["mat10000"]
    b = np.ones(a.n)
    ps = ct.make_solver(a, cfg.replace(dtype="float32", tol=1e-4,
                                       true_residual=False), device=dev)
    rr = ct.solve_refined(a, b, cfg, 1e-4, solver=ps)
    true_rel = float(np.linalg.norm(b - bs.host_matvec_f64(a, rr.x))
                     / np.linalg.norm(b - bs.host_matvec_f64(a, np.ones(a.n))))
    print(f"mat10000 refined through an f32 ILU(0) solver: {rr.status.name},"
          f" true f64 relative residual {true_rel!r}, {rr.iters} inner"
          f" iterations", flush=True)
    if rr.status != ct.SolverStatus.CONVERGED or not true_rel <= 1e-6:
        raise RuntimeError(f"mat10000 refinement reached only {true_rel!r}")


def one_m_solve(ps, b, tag):
    """One 1M-row exact ILU(0) solve, checked: CONVERGED, finite, and B1
    and B4a (each its two B4b sweeps) carried every matvec and msolve."""
    c0 = counts()
    r = ps.solve(b)
    c1 = counts()
    d1 = c1["const_stencil_spmv"] - c0["const_stencil_spmv"]
    d4 = c1["banded_fused_msolve"] - c0["banded_fused_msolve"]
    d4b = c1["banded_sweep"] - c0["banded_sweep"]
    print(f"1M exact ILU(0) {tag} solve: {r.status.name} {r.iters} it, dtAlg"
          f" {r.dt_alg * 1e3:.3f} ms ({r.dt_alg * 1e3 / max(r.iters, 1):.4f}"
          f" ms/iter), true relative residual"
          f" {float(r.residual_true / np.linalg.norm(b))!r}, launches B1"
          f" {d1} B4a {d4} B4b {d4b}", flush=True)
    if r.status != ct.SolverStatus.CONVERGED or not np.isfinite(r.x).all():
        raise RuntimeError(f"1M {tag}: {r.status.name}, or non-finite x")
    if d1 < 2 * r.iters + 1 or d4 < 2 * r.iters or d4b != 2 * d4:
        raise RuntimeError(f"1M {tag}: kernels B1/B4a/B4b did not carry the"
                           f" solve (launches {d1}, {d4}, {d4b})")
    return r


def dia_parity(op, tag, stats, timed=False):
    """B3 against its twin on ``op``'s layout, in f32 and f64, bitwise,
    both pad blocks zero (the kernel's output is poisoned first);
    ``timed``: also print the f32 kernel's time."""
    for dtype in (torch.float32, torch.float64):
        o = dataclasses.replace(op, data=op.data.to(dtype), vec_dtype=dtype)
        x = o.pad_vec(np.random.default_rng(3).standard_normal(o.n))
        args = (o.data, x, o.offsets, o.block, o.sub)
        poison_allocator(x)
        yk = ds.dia_spmv_block_padded(*args)
        yp = ds.dia_spmv_block_padded_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(yk).all():
            raise RuntimeError(f"{tag} dia_spmv: non-finite kernel output")
        if torch.count_nonzero(yk[:o.block]) or torch.count_nonzero(
                yk[o.block + o.npad:]):
            raise RuntimeError(f"{tag} dia_spmv: pad blocks not zero")
        err = float((yk - yp).abs().max())
        line = (f"{tag} {str(dtype)[6:]} dia_spmv (n {o.n}, npad {o.npad},"
                f" block {o.block}, sub {o.sub}, offsets {o.offsets}):"
                f" max|kernel - twin| = {err!r}")
        if timed and dtype == torch.float32:
            ms = cuda_ms(lambda: ds.dia_spmv_block_padded(*args))
            line += f", kernel {ms:.4f} ms"
        print(line, flush=True)
        stats["dia_spmv"]["max_abs_err"] = max(
            stats["dia_spmv"]["max_abs_err"], err)
        if err != 0.0:
            raise RuntimeError(f"{tag} dia_spmv: kernel differs from its twin"
                               f" (max abs {err!r}; bitwise required)")


def same_operators(ps_dia, ps_st):
    """The two 10M configurations apply the same A and the same M⁻¹ in
    two layouts: each product and sum is the same in both, so A·x and
    M⁻¹x agree element for element in true coordinates, and only the
    dots (over vectors of other lengths and zero patterns) can part their
    trajectories."""
    x = np.random.default_rng(5).standard_normal(ps_dia.n)
    for what, fn in (("A x", lambda ps: ps.op.matvec(ps.op.pad_vec(x))),
                     ("M^-1 x", lambda ps: ps.pre.msolve(ps.op.pad_vec(x)))):
        y_dia = ps_dia.op.unpad_vec(fn(ps_dia))
        y_st = ps_st.op.unpad_vec(fn(ps_st))
        diff = float((y_dia - y_st).abs().max())
        print(f"10M {what}: pallas_dia layout against the restrided stencil"
              f" layout, max|difference| = {diff!r}", flush=True)
        if not torch.equal(y_dia, y_st):
            raise RuntimeError(f"10M {what} differs between the two layouts")


def dia_bench(stats, smi):
    """B3 at the bench's 10M-row banded_laplacian_dia(3163) layout, block
    32768, f32: parity, then kernel and twin times, the bound, the bench's
    own byte model and torch.mv of the same matrix in sparse CSR."""
    dia = ct.banded_laplacian_dia(BENCH_SIDE)
    op = ds.PallasDIAOperator.from_dia(dia, dtype=torch.float32,
                                       device=DEVICE)
    dia_parity(op, "bench 10M layout", stats)
    x = np.random.default_rng(4).standard_normal(op.n)
    xk = op.pad_vec(x)
    args = (op.data, xk, op.offsets, op.block, op.sub)
    t = kernel_times(lambda: ds.dia_spmv_block_padded(*args))
    ms = t["ms"]
    pms = cuda_ms(lambda: ds.dia_spmv_block_padded_plain(*args))
    stats["dia_spmv"].update(**t, plain_ms=pms)
    # the diagonals read once, x read once and y written once
    item = xk.element_size()
    stats["dia_spmv"].update(bound(
        (op.data.numel() + 2 * xk.numel()) * item,
        2 * len(op.offsets) * op.npad))
    gbps = (5 * op.n + 2 * op.n) * 4 / (ms * 1e-3) / 1e9
    print(f"bench 10M layout dia_spmv f32: kernel {ms:.4f} ms (device"
          f" {t['device_ms']:.4f}), twin"
          f" {pms:.4f} ms, bound {stats['dia_spmv']['bound_ms']:.4f} ms"
          f" ({stats['dia_spmv']['bound_by']}); bench byte model"
          f" (5n + 2n)·4 B / t = {gbps:.1f} GB/s; {smi}", flush=True)
    # the same matrix in CSR, rows in order, entries in ascending column
    offs = np.asarray(dia.offsets, np.int64)
    vals = dia.data.T
    keep = vals != 0
    cols = (np.arange(dia.n, dtype=np.int64)[:, None] + offs[None, :])[keep]
    indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
    a_t = torch_csr(indptr, cols, vals[keep], dia.n, torch.float32)
    x_t = torch.from_numpy(x).to(torch.float32).to(DEVICE)
    y_k = op.unpad_vec(ds.dia_spmv_block_padded(*args))
    library_time(stats, "dia_spmv", lambda: torch.mv(a_t, x_t),
                 "torch.mv(sparse CSR A, x)",
                 lambda y: float((y - y_k).abs().max() / y_k.abs().max()))


def check_card_cpu(line, r, rc, iters, slack):
    """Card result ``r`` against the CPU's ``rc`` and a golden count."""
    dx = float(np.linalg.norm(r.x - rc.x) / np.linalg.norm(rc.x))
    line += (f" (golden {iters}); cpu {rc.status.name} {rc.iters} it,"
             f" |x diff|/|x| = {dx!r}")
    print(line, flush=True)
    if not (r.converged and rc.converged and np.isfinite(r.x).all()
            and abs(r.iters - iters) <= slack
            and abs(r.iters - rc.iters) <= HFORM_SLACK and dx <= 1e-6):
        raise RuntimeError(line + " — outside the window")


def entry_solves():
    """The reference's plain and split entry points and Jacobi, f64, card
    against CPU (plain twins) and the goldens; each solve's own launches
    show which kernel carried A."""
    def load(name):
        return ct.load_mm_sparse_matrix(os.path.join(ROOT, "data",
                                                     f"{name}.mtx"))

    mat3, vec3 = load("mat3"), ct.to_dense_vector(load("vec3"))
    a0, d3 = load("mat3_A0"), ct.to_dense_vector(load("vec3_d"))
    m = load("mat10000")
    one = np.ones(m.n)
    m0, dm = ct.split_form(m)
    demo = ct.SolverConfig(maxit=200, tol=1e-5)
    cfg = ct.SolverConfig(maxit=2000, tol=1e-6)
    cases = [
        ("bicgstab(mat3, vec3)", "dia_spmv", 3, 0,
         lambda dev: ct.bicgstab(mat3, vec3, demo, device=dev)),
        ("bicgstab_split(mat3_A0, vec3_d, ones, vec3)", "dia_spmv", 3, 0,
         lambda dev: ct.bicgstab_split(a0, d3, np.ones(3), vec3,
                                       demo.replace(maxit=2000),
                                       device=dev)),
        ("bicgstab(mat10000)", "const_stencil_spmv", HFORM_GOLDEN["mat10000"],
         HFORM_SLACK, lambda dev: ct.bicgstab(m, one, cfg, device=dev)),
        ("bicgstab(mat10000, format='pallas_dia')", "dia_spmv",
         HFORM_GOLDEN["mat10000"], HFORM_SLACK,
         lambda dev: ct.bicgstab(m, one, cfg, format="pallas_dia",
                                 device=dev)),
        ("bicgstab_split(*split_form(mat10000), ones, ones)",
         "const_stencil_spmv", HFORM_GOLDEN["mat10000_split"], HFORM_SLACK,
         lambda dev: ct.bicgstab_split(m0, dm, one, one, cfg, device=dev)),
    ]
    for what, kernel, iters, slack, run in cases:
        c0 = counts()
        r = run(DEVICE)
        launched = counts()[kernel] - c0[kernel]
        line = (f"{what}: card {r.status.name} {r.iters} it on {kernel}"
                f" ({launched} launches), dtAlg {r.dt_alg * 1e3:.3f} ms")
        if launched < 2 * r.iters + 1:
            raise RuntimeError(line + f" — {kernel} did not carry A")
        if iters == 3 and not np.allclose(r.x, DEMO_X, rtol=1e-9, atol=0):
            raise RuntimeError(f"{line}: x = {r.x!r}, not {DEMO_X}")
        check_card_cpu(line, r, run("cpu"), iters, slack)
    jac = cfg.replace(precond="jacobi")
    c0 = counts()["dia_spmv"]
    r = ct.solve(m, one, jac, format="pallas_dia", device=DEVICE)
    line = (f"solve(mat10000, precond='jacobi', format='pallas_dia'): card"
            f" {r.status.name} {r.iters} it ({counts()['dia_spmv'] - c0} B3"
            " launches)")
    rc = ct.solve(m, one, jac, format="pallas_dia", device="cpu")
    check_card_cpu(line, r, rc, rc.iters, HFORM_SLACK)


def neumann_10m_solve(ps, b, tag):
    """One 10M-row exact-factor Neumann solve, checked: CONVERGED in the
    window, finite, and the launches of its configuration: per iteration 2
    A-matvecs (B3 on DIA, B1 on the stencil) and 2 msolves of 2(k−1) = 4
    factor matvecs on B3; B2 and B4 never."""
    c0 = counts()
    r = ps.solve(b)
    got = {k: v - c0[k] for k, v in counts().items()}
    it = r.iters
    print(f"10M exact-factor Neumann {tag}: {r.status.name} {it} it, dtAlg"
          f" {r.dt_alg * 1e3:.3f} ms ({r.dt_alg * 1e3 / max(it, 1):.4f}"
          f" ms/iter), true relative residual"
          f" {float(r.residual_true / np.linalg.norm(b))!r}, dt_setup"
          f" {ps.dt_setup:.3f} s, launches {got}", flush=True)
    if r.status != ct.SolverStatus.CONVERGED or not np.isfinite(r.x).all() \
            or not NEUMANN_ITERS[0] <= it <= NEUMANN_ITERS[1]:
        raise RuntimeError(f"10M {tag}: {r.status.name} in {it} iterations"
                           f" (want CONVERGED in {NEUMANN_ITERS})")
    if tag == "pallas_dia":
        ok = got["dia_spmv"] >= 10 * it + 1 and got["const_stencil_spmv"] == 0
    else:
        ok = (got["const_stencil_spmv"] >= 2 * it + 1
              and got["dia_spmv"] >= 8 * it)
    if not ok or got["const_series_msolve"] or got["banded_fused_msolve"] \
            or got["banded_sweep"]:
        raise RuntimeError(f"10M {tag}: the launches do not show the"
                           f" configuration's kernels ({got})")
    return r


def pads_zero(v, block, npad):
    return not (torch.count_nonzero(v[:block])
                or torch.count_nonzero(v[block + npad:]))


def fusion_parity(ps, dtype, tag, stats, timed):
    """B5 (three and two input streams, FMA_PAIRS) and B6 (with and without
    <y, y>) against their twins on ``ps``'s layout, bitwise, both pad
    blocks zero (outputs poisoned first); B6's y also equal to B1's and
    both outputs the same over two launches.  ``timed``: times and bounds
    (the f32 flagship layout)."""
    op, pre = ps.op, ps.pre
    if pre.fused != "kernel" or not pre.fma_fits:
        raise RuntimeError(f"{tag}: fused={pre.fused!r}, fma_fits="
                           f"{pre.fma_fits}; kernel B5 would not run")
    rng = np.random.default_rng(2)
    av, bv, cv = (op.pad_vec(rng.standard_normal(op.n)).to(dtype)
                  for _ in range(3))
    gap = op.gapmask.to(dtype)
    layout = (pre.inv_d.to(dtype), pre.gap_ext.to(dtype),
              pre.nl.strided_terms, pre.nu.strided_terms, op.np_true,
              op.block, op.sub)
    spmv = (op.strided_terms, op.np_true, op.block, op.sub)
    name = "const_series_msolve_fma"
    for c1, c2 in FMA_PAIRS:
        s1 = torch.tensor(c1, dtype=dtype, device=DEVICE)
        s2 = torch.tensor(c2, dtype=dtype, device=DEVICE)
        for three in (True, False):
            args = (av, s1, bv, s2 if three else None, cv if three else None,
                    *layout)
            poison_allocator(av)
            poison_allocator(av)
            pk, yk = st.const_series_msolve_fma_padded(*args)
            poison_allocator(av)
            poison_allocator(av)
            pk2, yk2 = st.const_series_msolve_fma_padded(*args)
            pp, yp = st.const_series_msolve_fma_padded_plain(*args)
            torch.cuda.synchronize()
            what = f"{tag} {str(dtype)[6:]} {name} ({3 if three else 2}" \
                   f" streams, c1 {c1}, c2 {c2 if three else None})"
            if not (torch.isfinite(pk).all() and torch.isfinite(yk).all()):
                raise RuntimeError(f"{what}: non-finite kernel output")
            if not (torch.equal(pk, pk2) and torch.equal(yk, yk2)):
                raise RuntimeError(f"{what}: two launches differ")
            if not (pads_zero(pk, op.block, op.npad)
                    and pads_zero(yk, op.block, op.npad)):
                raise RuntimeError(f"{what}: pad blocks not zero")
            err = max(float((pk - pp).abs().max()),
                      float((yk - yp).abs().max()))
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            if err != 0.0:
                raise RuntimeError(f"{what}: kernel differs from its twin"
                                   f" (max abs {err!r}; bitwise required)")
    print(f"{tag} {str(dtype)[6:]} {name}: bitwise equal to its twin (p and"
          f" y) and the same over two launches in {2 * len(FMA_PAIRS)}"
          " cases", flush=True)
    name = "const_stencil_spmv_dots"
    for with_self in (True, False):
        poison_dots(av, 1 + with_self)
        yk, dk = st.const_stencil_spmv_dots_padded(av, gap, (bv,), *spmv,
                                                   with_self=with_self)
        poison_dots(av, 1 + with_self)
        yk2, dk2 = st.const_stencil_spmv_dots_padded(av, gap, (bv,), *spmv,
                                                     with_self=with_self)
        yp, dp = st.const_stencil_spmv_dots_padded_plain(
            av, gap, (bv,), *spmv, with_self=with_self)
        y1 = st.const_stencil_spmv_padded(av, gap, *spmv)
        torch.cuda.synchronize()
        what = f"{tag} {str(dtype)[6:]} {name} (with_self {with_self})"
        if not (torch.isfinite(yk).all() and torch.isfinite(dk).all()):
            raise RuntimeError(f"{what}: non-finite kernel output")
        if not pads_zero(yk, op.block, op.npad):
            raise RuntimeError(f"{what}: pad blocks not zero")
        err = max(float((yk - yp).abs().max()), float((dk - dp).abs().max()))
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        same = (torch.equal(yk, y1) and torch.equal(yk, yk2)
                and torch.equal(dk, dk2))
        print(f"{what}: max|kernel - twin| = {err!r} (y and dots); y equal"
              f" to B1's and both outputs the same over two launches:"
              f" {same}; dots {dk.tolist()}", flush=True)
        if err != 0.0 or not same:
            raise RuntimeError(f"{what}: differs from its twin, from B1 or"
                               " from its own second launch")
    if timed:
        vec = av.numel() * av.element_size()
        n2 = len(pre.nl.strided_terms) + len(pre.nu.strided_terms)
        ge = layout[1].numel() * layout[1].element_size()
        t = {}
        for three in (True, False):
            args = (av, torch.tensor(0.5, dtype=dtype, device=DEVICE), bv,
                    torch.tensor(-0.5, dtype=dtype, device=DEVICE)
                    if three else None, cv if three else None, *layout)
            t[three] = (
                kernel_times(lambda: st.const_series_msolve_fma_padded(
                    *args)),
                cuda_ms(lambda: st.const_series_msolve_fma_padded_plain(
                    *args)),
                bound((6 if three else 5) * vec + ge,
                      ((4 if three else 2) + 2 * n2 + 2) * av.numel()))
            print(f"{tag} const_series_msolve_fma, {3 if three else 2}"
                  f" streams: kernel {t[three][0]['ms']:.4f} ms (device"
                  f" {t[three][0]['device_ms']:.4f}), twin"
                  f" {t[three][1]:.4f} ms, bound"
                  f" {t[three][2]['bound_ms']:.4f} ms"
                  f" ({t[three][2]['bound_by']})", flush=True)
        stats["const_series_msolve_fma"].update(
            **t[True][0], plain_ms=t[True][1], **t[True][2],
            ms_two_streams=t[False][0]["ms"],
            device_ms_two_streams=t[False][0]["device_ms"],
            bound_ms_two_streams=t[False][2]["bound_ms"], library_ms=None,
            library="none: no one PyTorch call computes the combination"
            " and the polynomial msolve")
        t6 = kernel_times(lambda: st.const_stencil_spmv_dots_padded(
            av, gap, (bv,), *spmv, with_self=True))
        pms = cuda_ms(lambda: st.const_stencil_spmv_dots_padded_plain(
            av, gap, (bv,), *spmv, with_self=True))
        b6 = spmv_bound(av, gap, op.strided_terms, op.np_true, op.block,
                        n_w=1, n_dots=2)

        def unfused():
            y = st.const_stencil_spmv_padded(av, gap, *spmv)
            return torch.dot(bv, y), torch.dot(y, y)

        u_ms = device_ms(unfused)
        stats["const_stencil_spmv_dots"].update(
            **t6, plain_ms=pms, **b6, unfused_device_ms=u_ms,
            library_ms=None, library="none: no one PyTorch call computes the"
            " SpMV with its dots")
        print(f"{tag} const_stencil_spmv_dots (one weight and <y, y>, their"
              f" sum included): kernel {t6['ms']:.4f} ms (device"
              f" {t6['device_ms']:.4f}), twin {pms:.4f} ms, bound"
              f" {b6['bound_ms']:.4f} ms ({b6['bound_by']}); the unfused"
              f" sequence it replaces (B1, torch.dot(w, y), torch.dot(y,"
              f" y)): device {u_ms:.4f} ms", flush=True)


def spmv_bound(x, gap, terms, np_true, block, base=0, n_w=0, n_dots=0):
    """B1's bound (``n_w``, ``n_dots`` 0) or B6's (its weights and dots),
    from the bytes this layout needs: the rows below lim = np_true - base
    (y is 0 from there on, and in the pad blocks) read x there and as far
    beside as the terms reach, the weights there and gap's rows once; y is
    written whole and the dots once.  Each of those rows takes each term's
    product and sum (gap's product for the last sum) and each dot's
    product and sum."""
    npad = x.numel() - 2 * block
    lim = min(max(np_true - base, 0), npad)
    behind = max(0, -min(t[0] for t in terms))
    ahead = max(0, max(t[0] for t in terms))
    x_rows = min(lim + ahead, npad + block) + min(behind, block) if lim else 0
    return bound((x_rows + n_w * lim + x.numel() + n_dots) * x.element_size()
                 + min(block, lim) * gap.element_size(),
                 (2 * len(terms) + 2 * n_dots) * lim)


def f64_times(ps, ps_f, stats):
    """B2's, B5's (both forms) and B6's device times in f64 at the layouts
    where their f32 times are taken (path 1's and the fuse_blas1
    solver's), with their f64 bounds: reported, not gated."""
    rng = np.random.default_rng(3)
    dt = torch.float64
    out = {}
    for solver, key in ((ps, "b2"), (ps_f, "b5")):
        op, pre = solver.op, solver.pre
        av, bv, cv = (op.pad_vec(rng.standard_normal(op.n)).to(dt)
                      for _ in range(3))
        layout = (pre.inv_d.to(dt), pre.gap_ext.to(dt), pre.nl.strided_terms,
                  pre.nu.strided_terms, op.np_true, op.block, op.sub)
        vec = av.numel() * av.element_size()
        ge = layout[1].numel() * layout[1].element_size()
        n2 = len(pre.nl.strided_terms) + len(pre.nu.strided_terms)
        if key == "b2":
            out["b2"] = (device_ms(lambda: st.const_series_msolve_padded(
                av, *layout)), bound(3 * vec + ge, (2 * n2 + 2) * op.npad))
            continue
        s1 = torch.tensor(0.5, dtype=dt, device=DEVICE)
        s2 = torch.tensor(-0.5, dtype=dt, device=DEVICE)
        for three in (True, False):
            args = (av, s1, bv, s2 if three else None, cv if three else None,
                    *layout)
            out[three] = (device_ms(
                lambda: st.const_series_msolve_fma_padded(*args)),
                bound((6 if three else 5) * vec + ge,
                      ((4 if three else 2) + 2 * n2 + 2) * av.numel()))
        gap = op.gapmask.to(dt)
        spmv = (op.strided_terms, op.np_true, op.block, op.sub)
        out["b6"] = (device_ms(lambda: st.const_stencil_spmv_dots_padded(
            av, gap, (bv,), *spmv, with_self=True)),
            spmv_bound(av, gap, op.strided_terms, op.np_true, op.block,
                       n_w=1, n_dots=2))
    stats["const_series_msolve"].update(
        device_ms_f64=out["b2"][0], bound_ms_f64=out["b2"][1]["bound_ms"])
    stats["const_series_msolve_fma"].update(
        device_ms_f64=out[True][0], bound_ms_f64=out[True][1]["bound_ms"],
        device_ms_f64_two_streams=out[False][0],
        bound_ms_f64_two_streams=out[False][1]["bound_ms"])
    stats["const_stencil_spmv_dots"].update(
        device_ms_f64=out["b6"][0], bound_ms_f64=out["b6"][1]["bound_ms"])
    print(f"f64 device times: B2 {out['b2'][0]:.4f} ms (bound"
          f" {out['b2'][1]['bound_ms']:.4f}), B5 three streams"
          f" {out[True][0]:.4f} ({out[True][1]['bound_ms']:.4f}), two"
          f" streams {out[False][0]:.4f} ({out[False][1]['bound_ms']:.4f}),"
          f" B6 {out['b6'][0]:.4f} ({out['b6'][1]['bound_ms']:.4f})",
          flush=True)


def fusion_profiles(a, ps, ps_f, b, label=""):
    """loop_split profiles of PROFILE_ITERS iterations of path 4a's (i)
    fuse_blas1 (on ``ps_f``'s layout) and (iii) fused_dots (on path 1's
    solver ``ps``); ``label`` tags the lines."""
    for tag, solver, flags in (("(i) fuse_blas1", ps_f, {"fuse_blas1": True}),
                               ("(iii) fused_dots", ps, {"fused_dots": True})):
        cut = bs.PreparedSolver(a, solver.op, solver.pre, FLAGSHIP_CFG.replace(
            maxit=PROFILE_ITERS, **flags), solver.dt_setup)
        loop_split(f"flagship {tag}{label}", lambda: cut.solve(b))


def loop_steps(r):
    """Steps the preconditioned loop took: ``iters``, plus one where it
    left at a first half-step (that step is recorded but not counted)."""
    h = r.residual_history
    return r.iters + int(2 * r.iters < h.shape[0] and h[2 * r.iters] >= 0)


def fusion_solve(ps, b, tag, want, ms_path1):
    """One flagship solve under ``ps``'s flags, checked: CONVERGED in
    ITERS, finite, and each kernel's launches as ``want(steps)`` gives
    them ({kernel: count})."""
    c0 = counts()
    r = ps.solve(b)
    got = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
    steps = loop_steps(r)
    print(f"flagship {tag}: {r.status.name} {r.iters} it ({steps} loop"
          f" steps), dtAlg {r.dt_alg * 1e3:.3f} ms,"
          f" {r.dt_alg * 1e3 / max(r.iters, 1):.4f} ms/iter (path 1:"
          f" {ms_path1:.4f}), true residual {r.residual_true!r}, launches"
          f" {got}", flush=True)
    if r.status != ct.SolverStatus.CONVERGED or not np.isfinite(r.x).all() \
            or not ITERS[0] <= r.iters <= ITERS[1]:
        raise RuntimeError(f"flagship {tag}: {r.status.name} in {r.iters}"
                           f" iterations (want CONVERGED in {ITERS})")
    if got != want(steps):
        raise RuntimeError(f"flagship {tag}: launches {got}, want"
                           f" {want(steps)}")
    return r


MONO_CFG = ct.SolverConfig(maxit=2000, tol=1e-8, dtype="float64",
                           precond="ilu0_neumann", neumann_terms=4,
                           milu_omega=0.96)


def mono_setup(a, d):
    """The operator of ``a`` and its "mono" preconditioner
    (from_csr(prefer_mono=True)) on device ``d``."""
    op = ct.make_solver(a, MONO_CFG, device=d).op
    pre = pre_mod.NeumannILUPreconditioner.from_csr(
        a, terms=4, pad_like=op, prefer_mono=True, milu_omega=0.96)
    if pre.fused != "mono":
        raise RuntimeError(f"prefer_mono gave fused={pre.fused!r}")
    return op, pre


def mono_parity(dev):
    """B1 on the mono preconditioner's wide stencil of the mat10000 grid
    against its twin, bitwise."""
    a = ct.grid_laplacian(*SMALL)
    m = mono_setup(a, dev)[1].nl
    xm = m.pad_vec(np.random.default_rng(0).uniform(1.0, 5.0, a.n))
    args = (xm, m.gapmask, m.strided_terms, m.np_true, m.block, m.sub)
    poison_allocator(xm)
    if not torch.equal(st.const_stencil_spmv_padded(*args),
                       st.const_stencil_spmv_padded_plain(*args)):
        raise RuntimeError("mono: B1 differs from its twin on the"
                           f" {len(m.strided_terms)}-term stencil")
    print(f"mono layout const_stencil_spmv ({len(m.strided_terms)} terms):"
          " equal to its twin", flush=True)


def mono_solve(dev):
    """The mat10000 grid's f64 solve with the "mono" preconditioner
    (from_csr(prefer_mono=True)), card against CPU."""
    a = ct.grid_laplacian(*SMALL)
    cfg64 = MONO_CFG
    b = np.random.default_rng(0).uniform(1.0, 5.0, a.n)
    res = {}
    for d in (dev, "cpu"):
        op, pre = mono_setup(a, d)
        c0 = counts()
        res[d] = bs.PreparedSolver(a, op, pre, cfg64, 0.0).solve(b)
        if d == dev:
            got = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
    r, rc = res[dev], res["cpu"]
    dx = float(np.linalg.norm(r.x - rc.x) / np.linalg.norm(rc.x))
    steps = loop_steps(r)
    print(f"mat10000 f64 mono ({len(pre.nl.terms)} terms, one B1 launch per"
          f" msolve): card {r.status.name} {r.iters} it, cpu"
          f" {rc.status.name} {rc.iters} it, |x diff|/|x| = {dx!r}, true"
          f" residual {r.residual_true!r}, card launches {got}", flush=True)
    if not (r.converged and rc.converged and abs(r.iters - rc.iters) <= 2
            and dx <= 1e-8):
        raise RuntimeError("mono: card and CPU solves disagree")
    if got != {"const_stencil_spmv": 4 * steps + 1}:
        raise RuntimeError(f"mono: launches {got}")


def stencil2d_parity(ps3, a3, stats, smi):
    """B7 against its twin at the 3163 x 3163 grid, bitwise, ring zero, in
    f32 and f64, constant and variable coefficients; its unpadded A·x equal
    to B1's (``ps3.op``) on the same x; B1 against its own twin there too.
    Times and bounds of both kernels in f32 and f64 (f64 is path 4b's
    dtype) and torch.mv."""
    x = np.random.default_rng(6).standard_normal(a3.n)
    y_b1 = {}
    for dtype in (torch.float32, torch.float64):
        o = dataclasses.replace(ps3.op, gapmask=ps3.op.gapmask.to(dtype),
                                vec_dtype=dtype)
        xp = o.pad_vec(x)
        args = (xp, o.gapmask, o.strided_terms, o.np_true, o.block, o.sub)
        poison_allocator(xp)
        yk = st.const_stencil_spmv_padded(*args)
        yp = st.const_stencil_spmv_padded_plain(*args)
        torch.cuda.synchronize()
        err = float((yk - yp).abs().max())
        stats["const_stencil_spmv"]["max_abs_err"] = max(
            stats["const_stencil_spmv"]["max_abs_err"], err)
        y_b1[dtype] = o.unpad_vec(yk)
        t = kernel_times(lambda: st.const_stencil_spmv_padded(*args))
        ms = t["ms"]
        pms = cuda_ms(lambda: st.const_stencil_spmv_padded_plain(*args))
        b1 = spmv_bound(xp, o.gapmask, o.strided_terms, o.np_true, o.block)
        dt = str(dtype)[6:]
        stats["const_stencil_spmv"].update(
            {f"ms_{BENCH_SIDE}_{dt}": ms,
             f"device_ms_{BENCH_SIDE}_{dt}": t["device_ms"],
             f"bound_ms_{BENCH_SIDE}_{dt}": b1["bound_ms"]})
        print(f"{BENCH_SIDE}^2 layout {dt} const_stencil_spmv (stride"
              f" {o.stride} sub {o.sub} block {o.block} npad {o.npad}):"
              f" max|kernel - twin| = {err!r}; kernel {ms:.4f} ms (device"
              f" {t['device_ms']:.4f}), twin {pms:.4f} ms, bound"
              f" {b1['bound_ms']:.4f} ms"
              f" ({b1['bound_by']}); {smi}", flush=True)
        if err != 0.0 or not torch.isfinite(yk).all():
            raise RuntimeError(f"{BENCH_SIDE}^2 {dt} const_stencil_spmv:"
                               " differs from its twin (bitwise required)")
    for constant in (True, False):
        for dtype in (torch.float32, torch.float64):
            op = ct.StencilOperator2D.laplacian(BENCH_SIDE, BENCH_SIDE, dtype,
                                                constant=constant,
                                                device=DEVICE)
            xp = op.pad_vec(x)
            args = (op.coeffs, xp, op.offsets, op.tr, op.tc, op.rp, op.cp,
                    op.r, op.c)
            poison_allocator(xp)
            yk = t2d.stencil_spmv_padded(*args)
            yk2 = t2d.stencil_spmv_padded(*args)
            yp = t2d.stencil_spmv_padded_plain(*args)
            torch.cuda.synchronize()
            dt = str(dtype)[6:]
            tag = (f"{BENCH_SIDE}^2 {'constant' if constant else 'variable'}"
                   f" {dt} stencil2d_spmv (padded"
                   f" {op.rp + 2 * op.tr}x{op.cp + 2 * op.tc})")
            if not torch.isfinite(yk).all():
                raise RuntimeError(f"{tag}: non-finite kernel output")
            ring = yk.view(op.rp + 2 * op.tr, op.cp + 2 * op.tc).clone()
            ring[op.tr:op.tr + op.r, op.tc:op.tc + op.c] = 0
            err = float((yk - yp).abs().max())
            d1 = float((op.unpad_vec(yk) - y_b1[dtype]).abs().max())
            line = (f"{tag}: max|kernel - twin| = {err!r}; max|B7 - B1| on"
                    f" the grid = {d1!r}")
            stats["stencil2d_spmv"]["max_abs_err"] = max(
                stats["stencil2d_spmv"]["max_abs_err"], err)
            t = kernel_times(lambda: t2d.stencil_spmv_padded(*args))
            ms = t["ms"]
            pms = cuda_ms(lambda: t2d.stencil_spmv_padded_plain(*args))
            b7 = bound((2 * xp.numel() + op.coeffs.numel())
                       * xp.element_size(),
                       2 * len(op.offsets) * op.rp * op.cp)
            line += (f"; kernel {ms:.4f} ms (device"
                     f" {t['device_ms']:.4f}), twin {pms:.4f} ms, bound"
                     f" {b7['bound_ms']:.4f} ms ({b7['bound_by']})")
            if dtype == torch.float32 and constant:
                stats["stencil2d_spmv"].update(**t, plain_ms=pms, **b7)
            else:
                key = f"{'' if constant else 'variable_'}{dt}"
                stats["stencil2d_spmv"].update(
                    {f"ms_{key}": ms, f"device_ms_{key}": t["device_ms"],
                     f"plain_ms_{key}": pms,
                     f"bound_ms_{key}": b7["bound_ms"]})
            print(line, flush=True)
            if err != 0.0 or torch.count_nonzero(ring) or d1 != 0.0 \
                    or not torch.equal(yk, yk2):
                raise RuntimeError(f"{tag}: differs from its twin, from B1"
                                   " or from its own second launch, or the"
                                   " ring is not zero")
    a_t = torch_csr(a3.indptr, a3.indices, a3.data, a3.n, torch.float32)
    x_t = torch.from_numpy(x).to(torch.float32).to(DEVICE)
    library_time(stats, "stencil2d_spmv", lambda: torch.mv(a_t, x_t),
                 "torch.mv(sparse CSR A, x)",
                 lambda y: float((y - y_b1[torch.float32]).abs().max()
                                 / y_b1[torch.float32].abs().max()))
    print(f"stencil2d_spmv timed on: {smi}", flush=True)


def stencil2d_solves(dev):
    """StencilOperator2D.laplacian(100, 100) through solve(op, ones) in
    both modes, f64, tol 1e-6, card against CPU and mat10000's h-form
    golden; B7 carries every matvec."""
    cfg = ct.SolverConfig(maxit=2000, tol=1e-6, dtype="float64")
    one = np.ones(SMALL[0] * SMALL[1])
    for constant in (True, False):
        def run(d):
            op = ct.StencilOperator2D.laplacian(*SMALL, torch.float64,
                                                constant=constant, device=d)
            return ct.solve(op, one, cfg, device=d)

        c0 = counts()["stencil2d_spmv"]
        r = run(dev)
        launched = counts()["stencil2d_spmv"] - c0
        line = (f"solve(StencilOperator2D.laplacian(100, 100,"
                f" constant={constant}), ones): card {r.status.name}"
                f" {r.iters} it on stencil2d_spmv ({launched} launches)")
        if launched < 2 * r.iters + 1 or r.residual_true is not None:
            raise RuntimeError(line + " — B7 did not carry A")
        check_card_cpu(line, r, run("cpu"), HFORM_GOLDEN["mat10000"],
                       HFORM_SLACK)


def hform_10m(ps3, a3, dev):
    """The 3163 x 3163 grid, f64, tol 1e-6, b = x0 = ones: the h-form loop
    on B7 (StencilOperator2D, constant) beside bicgstab on B1."""
    b = np.ones(a3.n)
    r0 = float(np.linalg.norm(b - bs.host_matvec_f64(a3, np.ones(a3.n))))
    op = ct.StencilOperator2D.laplacian(BENCH_SIDE, BENCH_SIDE, torch.float64,
                                        device=dev)
    cfg = ps3._config
    out = {}
    for tag, run in (("B7 StencilOperator2D", lambda: ct.solve(op, b, cfg,
                                                               device=dev)),
                     ("B1 bicgstab", lambda: ps3.solve(b))):
        c0 = counts()
        r = run()
        got = {k: v - c0[k] for k, v in counts().items() if v - c0[k]}
        true_rel = float(np.linalg.norm(b - bs.host_matvec_f64(a3, r.x))
                         / r0)
        print(f"{BENCH_SIDE}^2 h-form on {tag}: {r.status.name} {r.iters} it,"
              f" dtAlg {r.dt_alg * 1e3:.3f} ms"
              f" ({r.dt_alg * 1e3 / max(r.iters, 1):.4f} ms/iter), true f64"
              f" relative residual {true_rel!r}, launches {got}", flush=True)
        kernel = "stencil2d_spmv" if tag.startswith("B7") \
            else "const_stencil_spmv"
        if not (r.converged and np.isfinite(r.x).all() and true_rel <= 1e-5
                and HFORM_10M_ITERS[0] <= r.iters <= HFORM_10M_ITERS[1]
                and got.get(kernel, 0) >= 2 * r.iters + 1):
            raise RuntimeError(f"{BENCH_SIDE}^2 {tag}: want CONVERGED in"
                               f" {HFORM_10M_ITERS}, true residual <= 1e-5,"
                               f" {kernel} carrying A")
        out[tag] = r.iters
    it7, it1 = out.values()
    if abs(it7 - it1) > HFORM_10M_APART * it1:
        raise RuntimeError(f"{BENCH_SIDE}^2: B7 took {it7} iterations, B1"
                           f" {it1}: more than {HFORM_10M_APART:.0%} apart")


def hform_10m_profile(ps3, a3, dev):
    """A profile of PROFILE_ITERS iterations of each of hform_10m's loops
    (loop_split)."""
    b = np.ones(a3.n)
    op = ct.StencilOperator2D.laplacian(BENCH_SIDE, BENCH_SIDE, torch.float64,
                                        device=dev)
    cut = ps3._config.replace(maxit=PROFILE_ITERS)
    loop_split(f"{BENCH_SIDE}^2 h-form on B7",
               lambda: ct.solve(op, b, cut, device=dev))
    loop_split(f"{BENCH_SIDE}^2 h-form on B1", lambda: bs.PreparedSolver(
        a3, ps3.op, ps3.pre, cut, ps3.dt_setup).solve(b))


def shuffled_laplacian(side):
    """banded_laplacian(side) numbered at random (the permutation of
    np.random.default_rng(0)), as tests/test_reorder.py:16-22 builds it."""
    a = ct.grid_laplacian(side, side)
    return reorder.permute_csr(
        a, np.random.default_rng(0).permutation(a.n).astype(np.int64))


def operator_bytes(op, x, y):
    """Every tensor of the operator read once, x read once, y written
    once."""
    return sum(getattr(op, f.name).nbytes for f in dataclasses.fields(op)
               if isinstance(getattr(op, f.name), torch.Tensor)) \
        + x.nbytes + y.nbytes


def operator_check(a, fmt, dtype, tag, table):
    """make_operator(a, format=fmt) on the card: y against the host f64
    product, two calls bitwise, times, the byte bound and torch.mv of the
    sparse CSR matrix; one row of ``table``."""
    op = ops.make_operator(a, dtype=dtype, format=fmt, device=DEVICE)
    x = np.random.default_rng(7).standard_normal(a.n)
    xd = op.pad_vec(x)
    y1, y2 = op.matvec(xd), op.matvec(xd)
    y_h = bs.host_matvec_f64(a, x)
    err = float(np.abs(y1.double().cpu().numpy() - y_h).max()
                / np.abs(y_h).max())
    same = torch.equal(y1, y2)
    t = kernel_times(lambda: op.matvec(xd))
    values = sum(getattr(op, f.name).numel() for f in dataclasses.fields(op)
                 if isinstance(getattr(op, f.name), torch.Tensor)
                 and getattr(op, f.name).is_floating_point())
    b = bound(operator_bytes(op, xd, y1), 2 * values)
    a_t = torch_csr(a.indptr, a.indices, a.data, a.n, dtype)
    x_t = torch.from_numpy(x).to(dtype).to(DEVICE)
    lib = cuda_ms(lambda: torch.mv(a_t, x_t))
    row = dict(tag=tag, format=fmt or f"auto={type(op).__name__}",
               dtype=str(dtype)[6:], err=err, **t, **b, torch_mv_ms=lib)
    table.append(row)
    print(f"{tag} {row['format']} {row['dtype']} matvec: max|card - host"
          f" f64| / max|y| = {err!r}, two calls bitwise {same}; {t['ms']:.4f}"
          f" ms (device {t['device_ms']:.4f}), bound {b['bound_ms']:.4f} ms"
          f" ({b['bound_by']}), torch.mv(sparse CSR) {lib:.4f} ms",
          flush=True)
    if not same or not err <= MATVEC_BOUND[dtype]:
        raise RuntimeError(f"{tag} {row['format']} {row['dtype']}: matvec"
                           " not deterministic or off the host product")
    return type(op)


def first_iterate_ref(a, b, cfg):
    """x after one iteration of ``cfg``'s solve in f64 on the CPU (CSR)."""
    return ct.solve(a, b, cfg.replace(maxit=1, dtype="float64"),
                    format="csr", device="cpu").x


def first_iterate_err(a, b, cfg, fmt, device, ref):
    """max|x₁ − ref| / max|ref| of ``cfg``'s solve stopped after one
    iteration on ``device`` in ``fmt``."""
    x = ct.solve(a, b, cfg.replace(maxit=1), format=fmt, device=device).x
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def random_system_solves(a, dev):
    """5a's solves: precond none, f32, tol 1e-4, b = ones, in each format,
    twice on the card and once on the CPU; each BREAKDOWN in the window,
    the card's two bitwise equal, and the first iterate of each on the
    f64 one's."""
    cfg = ct.SolverConfig(maxit=2000, tol=1e-4, dtype="float32")
    b = np.ones(a.n)
    ref = first_iterate_ref(a, b, cfg)
    for fmt in UNPADDED:
        ps = ct.make_solver(a, cfg, format=fmt, device=dev)
        r1, r2 = ps.solve(b), ps.solve(b)
        rc = ct.solve(a, b, cfg, format=fmt, device="cpu")
        e1 = {d: first_iterate_err(a, b, cfg, fmt, d, ref)
              for d in (dev, "cpu")}
        line = (f"random system solve format={fmt} ({type(ps.op).__name__}):"
                f" card {r1.status.name} {r1.iters} it / {r2.status.name}"
                f" {r2.iters} it, {r2.dt_alg * 1e3 / max(r2.iters, 1):.4f}"
                f" ms/iter (second), dt_setup {ps.dt_setup:.3f} s; cpu"
                f" {rc.status.name} {rc.iters} it; first iterate against"
                f" f64: card {e1[dev]!r}, cpu {e1['cpu']!r}")
        print(line, flush=True)
        del ps
        for r in (r1, rc):
            if r.status != ct.SolverStatus.BREAKDOWN or not \
                    BREAKDOWN_ITERS[0] <= r.iters <= BREAKDOWN_ITERS[1]:
                raise RuntimeError(line + f" — want BREAKDOWN in"
                                   f" {BREAKDOWN_ITERS}")
        if r1.iters != r2.iters or not np.array_equal(r1.x, r2.x,
                                                      equal_nan=True):
            raise RuntimeError(line + " — two card solves differ")
        if not max(e1.values()) <= FIRST_ITERATE_TOL:
            raise RuntimeError(line + f" — first iterate off the f64 one by"
                               f" more than {FIRST_ITERATE_TOL}")


def report_solve(tag, ps, r, b, a, extra=""):
    true_rel = float(np.linalg.norm(b - bs.host_matvec_f64(a, r.x))
                     / np.linalg.norm(b))
    print(f"{tag}: {r.status.name} {r.iters} it, dtAlg {r.dt_alg * 1e3:.3f}"
          f" ms ({r.dt_alg * 1e3 / max(r.iters, 1):.4f} ms/iter), dt_setup"
          f" {ps.dt_setup:.3f} s{extra}, true relative residual"
          f" {true_rel!r}; A {type(ps.op).__name__}", flush=True)
    return true_rel


def shuffled_1m(a, dev, table):
    """5b: ELL's matvec at 1M rows, (i) Jacobi on ELL twice, (ii) RCM +
    Neumann k=3 in f64, (iii) the same in f32, refined."""
    for dt in (torch.float32, torch.float64):
        operator_check(a, "ell", dt, "1M shuffled", table)
    b = np.ones(a.n)
    ps = ct.make_solver(a, ct.SolverConfig(maxit=5000, tol=1e-6,
                                           precond="jacobi"), device=dev)
    r1, r2 = ps.solve(b), ps.solve(b)
    true_rel = [report_solve("5b (i) Jacobi, f64", ps, r, b, a)
                for r in (r1, r2)]
    if not (isinstance(ps.op, ops.ELLOperator) and r1.converged
            and JACOBI_1M_ITERS[0] <= r1.iters <= JACOBI_1M_ITERS[1]
            and max(true_rel) <= TRUE_RESIDUAL_1M
            and r1.iters == r2.iters and np.array_equal(r1.x, r2.x)):
        raise RuntimeError(f"5b (i): want ELL, CONVERGED in {JACOBI_1M_ITERS}"
                           f" to a true residual ≤ {TRUE_RESIDUAL_1M} and two"
                           " bitwise equal solves")
    del ps
    t0 = time.perf_counter()
    reorder.rcm_permutation(a)
    t_rcm = time.perf_counter() - t0
    cfg = ct.SolverConfig(maxit=2000, tol=1e-6, precond="ilu0_neumann",
                          neumann_terms=3, reorder="rcm")
    ps = ct.make_solver(a, cfg, device=dev)
    r = ps.solve(b)
    true_rel = report_solve(
        "5b (ii) RCM + Neumann k=3, f64", ps, r, b, a,
        f" (RCM {t_rcm:.3f} s of it, timed alone); factors"
        f" {type(ps.pre.nl).__name__}/{type(ps.pre.nu).__name__}")
    if not (r.converged and NEUMANN_1M_ITERS[0] <= r.iters
            <= NEUMANN_1M_ITERS[1] and true_rel <= TRUE_RESIDUAL_1M
            and not ps.pre.nl.padded):
        raise RuntimeError(f"5b (ii): want CONVERGED in {NEUMANN_1M_ITERS}"
                           f" to a true residual ≤ {TRUE_RESIDUAL_1M} on"
                           " true-n factor operators")
    del ps
    cfg32 = cfg.replace(dtype="float32", tol=1e-4)
    ps = ct.make_solver(a, cfg32.replace(true_residual=False), device=dev)
    report_solve("5b (iii) RCM + Neumann k=3, f32, tol 1e-4", ps,
                 ps.solve(b), b, a)
    rr = ct.solve_refined(a, b, cfg32.replace(tol=1e-6), 1e-4, solver=ps)
    true_rel = float(np.linalg.norm(b - bs.host_matvec_f64(a, rr.x))
                     / np.linalg.norm(b - bs.host_matvec_f64(a, np.ones(a.n))))
    print(f"5b (iii) refined through it: {rr.status.name}, {rr.iters} inner"
          f" iterations, dtAlg {rr.dt_alg * 1e3:.3f} ms, true f64 relative"
          f" residual {true_rel!r} (reported, not gated)", flush=True)


def blocked_trisolves(dev):
    """5c: exact ILU(0) through the generic blocked trisolve — mat10000 at
    B = 64 and mat900 at B = 16, f64, card against CPU and the goldens;
    then RCM + exact ILU(0), B = 128, on the shuffled banded_laplacian(316)
    once, with the parts of its setup."""
    for name, block in (("mat10000", 64), ("mat900", 16)):
        a = ct.load_mm_sparse_matrix(os.path.join(ROOT, "data",
                                                  f"{name}.mtx"))
        cfg = ct.SolverConfig(maxit=2000, tol=1e-6, precond="ilu0",
                              trisolve_block=block)
        ps = ct.make_solver(a, cfg, device=dev)
        if not isinstance(ps.pre.inner.tri, tri_mod.BlockTriangularSolver):
            raise RuntimeError(f"{name}: the blocked trisolve was not taken")
        # the first solve pays one-time costs inside its timed loop; the
        # second is the steady state
        r0, r = ps.solve(np.ones(a.n)), ps.solve(np.ones(a.n))
        rc = ct.solve(a, np.ones(a.n), cfg, device="cpu")
        dx = float(np.linalg.norm(r.x - rc.x) / np.linalg.norm(rc.x))
        line = (f"5c {name} exact ILU(0), B = {block} (nb"
                f" {ps.pre.inner.tri.nb}), f64: card {r.status.name}"
                f" {r.iters} it (golden {ILU_GOLDEN[name]}),"
                f" {r.dt_alg * 1e3 / max(r.iters, 1):.4f} ms/iter (second"
                f" solve; first {r0.dt_alg * 1e3 / max(r0.iters, 1):.4f}), A"
                f" {type(ps.op).__name__}; cpu {rc.status.name} {rc.iters}"
                f" it, |x diff|/|x| = {dx!r}")
        print(line, flush=True)
        if not (r.converged and rc.converged
                and abs(r.iters - ILU_GOLDEN[name]) <= 2
                and abs(r.iters - rc.iters) <= 2 and dx <= 1e-8):
            raise RuntimeError(line + " — outside the window")
        if r0.iters != r.iters or not np.array_equal(r0.x, r.x):
            raise RuntimeError(line + " — two card solves differ")
    a = shuffled_laplacian(BLOCKED_SIDE)
    t = {}
    t0 = time.perf_counter()
    perm = reorder.rcm_permutation(a)
    t["rcm"] = time.perf_counter() - t0
    ap = reorder.permute_csr(a, perm)
    t["permute"] = time.perf_counter() - t0 - t["rcm"]
    t0 = time.perf_counter()
    mvals = pre_mod._factorize(ap)
    t["factorize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lower in (True, False):
        tri_mod._block_setup_tri(ap, mvals, 128, lower)
    t["block arrays and inverses"] = time.perf_counter() - t0
    cfg = ct.SolverConfig(maxit=2000, tol=1e-6, precond="ilu0",
                          trisolve_block=128, reorder="rcm")
    ps = ct.make_solver(a, cfg, device=dev)
    tri = getattr(ps.pre, "inner", ps.pre).tri
    b = np.ones(a.n)
    f = torch.from_numpy(np.random.default_rng(8).standard_normal(a.n)).to(
        DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tri.msolve(f)
    torch.cuda.synchronize()
    t_first = (time.perf_counter() - t0) * 1e3
    # warmed up by the msolves above, so the solve's loop is the steady state
    t_msolve = cuda_ms(lambda: tri.msolve(f), reps=5)
    r = ps.solve(b)
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in t.items())
    report_solve(f"5c shuffled banded_laplacian({BLOCKED_SIDE}) RCM + exact"
                 f" ILU(0), B = 128 (bandwidth {reorder.bandwidth(ap)}, nb"
                 f" {tri.nb}; JAX CPU {BLOCKED_JAX_ITERS} it)", ps, r, b, a,
                 f" (parts timed alone: {parts}); one msolve"
                 f" {t_msolve:.3f} ms (launch to launch; the first, before"
                 f" the solve, {t_first:.3f} ms); the trisolve's"
                 f" launches an iteration by the code's count:"
                 f" {4 * (5 * tri.nb + 3)}"
                 " (5 a block step and 3 a sweep, two sweeps a msolve, two"
                 " msolves)")
    if not (isinstance(tri, tri_mod.BlockTriangularSolver) and r.converged
            and np.isfinite(r.x).all()):
        raise RuntimeError("5c: the 316² blocked solve did not converge")


def bicg_and_split(dev):
    """5d: bicg on mat900 and mat10000; 5e: bicgstab_split of mat10000's
    split form as format="csr"; f64, card against CPU and the goldens."""
    cfg = ct.SolverConfig(maxit=2000, tol=1e-6)
    m = {}
    for name in ("mat900", "mat10000"):
        m[name] = ct.load_mm_sparse_matrix(os.path.join(ROOT, "data",
                                                        f"{name}.mtx"))
        one = np.ones(m[name].n)
        r = ct.bicg(m[name], one, cfg, device=dev)
        check_card_cpu(f"5d bicg({name}): card {r.status.name} {r.iters} it,"
                       f" {r.dt_alg * 1e3 / max(r.iters, 1):.4f} ms/iter", r,
                       ct.bicg(m[name], one, cfg, device="cpu"),
                       BICG_GOLDEN[name], HFORM_SLACK)
    a0, d = ct.split_form(m["mat10000"])
    one = np.ones(a0.n)
    r = ct.bicgstab_split(a0, d, one, one, cfg, format="csr", device=dev)
    check_card_cpu(f"5e bicgstab_split(*split_form(mat10000), format='csr'):"
                   f" card {r.status.name} {r.iters} it", r,
                   ct.bicgstab_split(a0, d, one, one, cfg, format="csr",
                                     device="cpu"),
                   HFORM_GOLDEN["mat10000_split"], HFORM_SLACK)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # a fatal signal (a fault in native or library code) prints the Python
    # stack of each thread to stderr before the process dies
    faulthandler.enable()
    timer = PhaseTimer()
    with phase(timer, "card"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(smi)
        print(f"python {sys.version.split()[0]}, torch {torch.__version__},"
              f" CUDA {torch.version.cuda}, device"
              f" {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    with phase(timer, "build"):
        with ThreadPoolExecutor() as pool:
            for fut in [pool.submit(f) for f in (
                    _kernels.library, _kernels.trisolve_library,
                    _kernels.dia_library, _kernels.stencil2d_library,
                    native.library)]:
                fut.result()
        print(f"built at once: kernels {_kernels.build_seconds}, native"
              f" parser/factorizer {native.build_seconds:.2f} s")
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 matmuls are on: the twins would not run"
                               " in full f32")

    dev = torch.device(DEVICE)
    cfg = FLAGSHIP_CFG
    stats = {k: {"max_abs_err": 0.0} for k in KERNELS}

    with phase(timer, "stencil kernel parity"):
        a_s = ct.grid_laplacian(*SMALL)
        ps_s = ct.make_solver(a_s, cfg, device=dev)
        for dt in (torch.float32, torch.float64):
            kernel_parity(ps_s, dt, "mat10000 layout", stats, timed=False)
        # the whole solve on the card against the CPU (plain twins), in f64
        cfg64 = cfg.replace(dtype="float64", tol=1e-8)
        b_s = np.random.default_rng(0).uniform(1.0, 5.0, a_s.n)
        r_gpu = ct.make_solver(a_s, cfg64, device=dev).solve(b_s)
        r_cpu = ct.make_solver(a_s, cfg64, device="cpu").solve(b_s)
        dx = float(np.linalg.norm(r_gpu.x - r_cpu.x)
                   / np.linalg.norm(r_cpu.x))
        print(f"mat10000 f64 solve: card {r_gpu.status.name} {r_gpu.iters}"
              f" it, cpu {r_cpu.status.name} {r_cpu.iters} it,"
              f" |x diff|/|x| = {dx!r}")
        if not (r_gpu.converged and r_cpu.converged
                and abs(r_gpu.iters - r_cpu.iters) <= 2 and dx <= 1e-8):
            raise RuntimeError("card and CPU solves of mat10000 disagree")

        if not native.available():
            raise RuntimeError("native factorizer unavailable: the 10M-row"
                               " setup would run the numpy loops")
        a = ct.grid_laplacian(*FLAGSHIP)
        ps = ct.make_solver(a, cfg, device=dev)
        print(f"flagship setup (make_solver): {ps.dt_setup:.3f} s; layout"
              f" stride {ps.op.stride} sub {ps.op.sub} block {ps.op.block}"
              f" npad {ps.op.npad}; msolve mode {ps.pre.fused}")
        for dt in (torch.float32, torch.float64):
            kernel_parity(ps, dt, "flagship layout", stats,
                          timed=dt == torch.float32)
        stencil_library(a, ps, stats)

    # ---- main path 1: the flagship's two solves and its refinement
    b = np.ones(a.n)
    reset_counts()
    with phase(timer, "flagship solve"):
        for _ in range(2):
            n1 = st.const_stencil_spmv_padded.launches
            n2 = st.const_series_msolve_padded.launches
            r = ps.solve(b)
            d1 = st.const_stencil_spmv_padded.launches - n1
            d2 = st.const_series_msolve_padded.launches - n2
            print(f"flagship solve: {r.status.name} {r.iters} it, dtAlg"
                  f" {r.dt_alg * 1e3:.3f} ms, true residual"
                  f" {r.residual_true!r}, launches B1 {d1} B2 {d2}",
                  flush=True)
            if r.status != ct.SolverStatus.CONVERGED \
                    or not ITERS[0] <= r.iters <= ITERS[1]:
                raise RuntimeError(f"flagship: {r.status.name} in {r.iters}"
                                   f" iterations (want CONVERGED in {ITERS})")
            if not np.isfinite(r.residual_true) or not np.isfinite(r.x).all():
                raise RuntimeError("flagship: non-finite result")
            if d1 < 2 * r.iters + 1 or d2 < 2 * r.iters:
                raise RuntimeError("flagship: kernels B1/B2 did not carry the"
                                   f" solve (launches {d1}, {d2})")
        print(f"flagship (second solve): dt_setup {ps.dt_setup:.3f} s, dtAlg"
              f" {r.dt_alg * 1e3:.3f} ms, {r.dt_alg * 1e3 / r.iters:.4f}"
              f" ms/iter, {r.iters} iterations")

    with phase(timer, "refine"):
        rr = ct.solve_refined(a, b, cfg.replace(tol=1e-6), 1e-4, solver=ps)
        true_rel = float(
            np.linalg.norm(b - bs.host_matvec_f64(a, rr.x))
            / np.linalg.norm(b - bs.host_matvec_f64(a, np.ones(a.n))))
        print(f"refined: {rr.status.name}, true f64 relative residual"
              f" {true_rel!r}, {rr.iters} inner iterations, dtAlg"
              f" {rr.dt_alg * 1e3:.3f} ms")
        if rr.status != ct.SolverStatus.CONVERGED or not true_rel <= 1e-6:
            raise RuntimeError(f"refinement reached only {true_rel!r}")
    path1 = counts()
    check_counted("main path 1 (flagship)", path1,
                  ("const_stencil_spmv", "const_series_msolve"))

    with phase(timer, "poll cost"):
        pc = poll_cost(ps, b, r.iters)
        print(f"per-iteration host poll: {pc['poll']:.4f} ms/it with it,"
              f" {pc['no_poll']:.4f} ms/it without (host enqueue"
              f" {pc['enqueue']:.4f} ms/it); poll costs"
              f" {pc['poll'] - pc['no_poll']:.4f} ms/it")
        cut = bs.PreparedSolver(a, ps.op, ps.pre,
                                cfg.replace(maxit=PROFILE_ITERS), ps.dt_setup)
        loop_split("flagship", lambda: cut.solve(b))
    ms_path1 = r.dt_alg * 1e3 / r.iters

    with phase(timer, "fusion kernel parity"):
        for dt in (torch.float32, torch.float64):
            fusion_parity(ps_s, dt, "mat10000 layout", stats, timed=False)
        cfg_f = cfg.replace(fuse_blas1=True)
        ps_f = ct.make_solver(a, cfg_f, device=dev)
        print(f"flagship fuse_blas1 setup (make_solver): {ps_f.dt_setup:.3f}"
              f" s; layout stride {ps_f.op.stride} sub {ps_f.op.sub} block"
              f" {ps_f.op.block} npad {ps_f.op.npad}; msolve mode"
              f" {ps_f.pre.fused}, B5 fits {ps_f.pre.fma_fits}", flush=True)
        for dt in (torch.float32, torch.float64):
            fusion_parity(ps_f, dt, "flagship fuse_blas1 layout", stats,
                          timed=dt == torch.float32)
        f64_times(ps, ps_f, stats)
        mono_parity(dev)

    # ---- main path 4a: the flagship with the loop's opt-in fusions
    reset_counts()
    with phase(timer, "flagship with fusions"):
        every = cfg.replace(fuse_blas1=True, fused_dots=True,
                            check_halves=False)
        cases = [
            ("(i) fuse_blas1", ps_f, lambda s: {
                "const_stencil_spmv": 2 * s + 1,
                "const_series_msolve_fma": 2 * s}),
            ("(ii) fuse_blas1 + fused_dots + check_halves=False",
             bs.PreparedSolver(a, ps_f.op, ps_f.pre, every, ps_f.dt_setup),
             lambda s: {"const_stencil_spmv": 1,
                        "const_series_msolve_fma": 2 * s,
                        "const_stencil_spmv_dots": 2 * s}),
            ("(iii) fused_dots", bs.PreparedSolver(
                a, ps.op, ps.pre, cfg.replace(fused_dots=True),
                ps.dt_setup), lambda s: {
                    "const_stencil_spmv": 1, "const_series_msolve": 2 * s,
                    "const_stencil_spmv_dots": 2 * s}),
            ("(iv) check_halves=False", bs.PreparedSolver(
                a, ps.op, ps.pre, cfg.replace(check_halves=False),
                ps.dt_setup), lambda s: {
                    "const_stencil_spmv": 2 * s + 1,
                    "const_series_msolve": 2 * s}),
        ]
        for tag, solver, want in cases:
            fusion_solve(solver, b, tag, want, ms_path1)
        rr = ct.solve_refined(a, b, every.replace(tol=1e-6), 1e-4,
                              solver=cases[1][1])
        true_rel = float(
            np.linalg.norm(b - bs.host_matvec_f64(a, rr.x))
            / np.linalg.norm(b - bs.host_matvec_f64(a, np.ones(a.n))))
        print(f"refined through (ii): {rr.status.name}, true f64 relative"
              f" residual {true_rel!r}, {rr.iters} inner iterations, dtAlg"
              f" {rr.dt_alg * 1e3:.3f} ms", flush=True)
        if rr.status != ct.SolverStatus.CONVERGED or not true_rel <= 1e-6:
            raise RuntimeError(f"refinement through (ii) reached only"
                               f" {true_rel!r}")
        mono_solve(dev)
    path4a = counts()
    check_counted("main path 4a (flagship with fusions)", path4a,
                  ("const_stencil_spmv", "const_series_msolve",
                   "const_series_msolve_fma", "const_stencil_spmv_dots"))
    with phase(timer, "flagship fusion profiles"):
        fusion_profiles(a, ps, ps_f, b)
    del ps, ps_f, cases, a

    cfg_ilu = ct.SolverConfig(maxit=2000, tol=1e-6, dtype="float64",
                              precond="ilu0", trisolve_block=128)
    a10k = ct.load_mm_sparse_matrix(os.path.join(ROOT, "data",
                                                 "mat10000.mtx"))
    with phase(timer, "trisolve parity"):
        for dt in (torch.float32, torch.float64):
            tri = pre_mod.ILU0Preconditioner.from_csr(
                a10k, block=128, dtype=dt, device=dev).tri
            trisolve_parity(tri, a10k, "mat10000 layout", stats, timed=True)
        a1m = ct.grid_laplacian(*ONE_M)
        cfg1m = cfg_ilu.replace(dtype="float32", tol=1e-4)
        ps1m = ct.make_solver(a1m, cfg1m, device=dev)
        tri = ps1m.pre.inner.tri
        print(f"1M-row exact ILU(0) setup (make_solver): dt_setup"
              f" {ps1m.dt_setup:.3f} s; nb {tri.wt_lo.shape[0]}, B"
              f" {tri.block}, {4 * tri.wt_lo.nbytes / 1e9:.3f} GB of"
              f" block arrays", flush=True)
        t0 = time.perf_counter()
        for fw, wt, wct in ((True, tri.wt_lo, tri.wct_lo),
                            (False, tri.wt_up, tri.wct_up)):
            bt.sweep_plan(wt, wct, fw)
        torch.cuda.synchronize()
        print(f"1M-row f32 plans of both sweeps (part of dt_setup):"
              f" {time.perf_counter() - t0:.4f} s", flush=True)
        trisolve_parity(tri, a1m, "1M layout", stats, timed=True)
        trisolve_library(a1m, tri, stats)
        ps1m64 = ct.make_solver(a1m, cfg1m.replace(dtype="float64"),
                                device=dev)
        print(f"1M-row f64 setup: dt_setup {ps1m64.dt_setup:.3f} s",
              flush=True)
        trisolve_parity(ps1m64.pre.inner.tri, a1m, "1M layout", stats,
                        timed=False)

    # ---- main path 2: the reference's default solve, exact ILU(0)
    reset_counts()
    with phase(timer, "exact ILU(0) reference solves"):
        reference_solves(cfg_ilu, dev)
    with phase(timer, "1M-row exact ILU(0) solve"):
        b1 = np.ones(a1m.n)
        r64 = one_m_solve(ps1m64, b1, "f64")
        if not ONE_M_ITERS[0] <= r64.iters <= ONE_M_ITERS[1]:
            raise RuntimeError(f"1M f64: {r64.iters} iterations (want"
                               f" {ONE_M_ITERS})")
        for k in range(2):
            r = one_m_solve(ps1m, b1, "f32")
            if not ONE_M_ITERS[0] <= r.iters <= ONE_M_ITERS[1]:
                raise RuntimeError(f"1M f32: {r.iters} iterations (want"
                                   f" {ONE_M_ITERS}; f64 took {r64.iters})")
            if k == 0 and r.dt_alg > 60.0:
                print("1M: one solve took more than 60 s; solved once")
                break
        print(f"1M exact ILU(0) f32: dt_setup {ps1m.dt_setup:.3f} s, dtAlg"
              f" {r.dt_alg * 1e3:.3f} ms, {r.dt_alg * 1e3 / r.iters:.4f}"
              f" ms/iter, {r.iters} iterations (last solve)", flush=True)
    path2 = counts()
    check_counted("main path 2 (exact ILU(0))", path2,
                  ("const_stencil_spmv", "banded_fused_msolve",
                   "banded_sweep"))
    del ps1m, ps1m64, tri

    cfg_n = ct.SolverConfig(maxit=2000, tol=1e-4, dtype="float32",
                            precond="ilu0_neumann", neumann_terms=3,
                            neumann_const_factors=False)
    with phase(timer, "banded DIA parity"):
        mat3 = ct.load_mm_sparse_matrix(os.path.join(ROOT, "data",
                                                     "mat3.mtx"))
        dia_parity(ds.PallasDIAOperator.from_dia(
            mat3.to_dia(max_diags=16), device=DEVICE), "mat3 layout", stats)
        a = ct.grid_laplacian(*FLAGSHIP)
        ps_dia = ct.make_solver(a, cfg_n, format="pallas_dia", device=dev)
        ps_st = ct.make_solver(a, cfg_n, device=dev)
        for tag, ps_n in (("pallas_dia", ps_dia), ("stencil", ps_st)):
            print(f"10M {tag} setup (make_solver): {ps_n.dt_setup:.3f} s;"
                  f" A: {type(ps_n.op).__name__} npad {ps_n.op.npad} block"
                  f" {ps_n.op.block} sub {ps_n.op.sub}; factors: n"
                  f" {ps_n.pre.nl.n} npad {ps_n.pre.nl.npad} block"
                  f" {ps_n.pre.nl.block} offsets {ps_n.pre.nl.offsets} /"
                  f" {ps_n.pre.nu.offsets}", flush=True)
        same_operators(ps_dia, ps_st)
        dia_parity(ps_dia.op, "10M grid DIA layout", stats, timed=True)
        dia_parity(ps_dia.pre.nl, "10M DIA-factor layout (N_l)", stats,
                   timed=True)
        dia_parity(ps_st.pre.nl, "10M restrided-factor layout (N_l)", stats,
                   timed=True)
        dia_parity(ps_st.pre.nu, "10M restrided-factor layout (N_u)", stats)
        dia_bench(stats, smi)

    # ---- main path 3: banded DIA
    reset_counts()
    with phase(timer, "entry points (h-form, split, Jacobi)"):
        entry_solves()
    with phase(timer, "10M exact-factor Neumann solves"):
        b = np.ones(a.n)
        its = {}
        for tag, ps_n in (("pallas_dia", ps_dia), ("stencil", ps_st)):
            for _ in range(2):
                r = neumann_10m_solve(ps_n, b, tag)
            its[tag] = r.iters
            print(f"10M {tag} (second solve): dt_setup {ps_n.dt_setup:.3f}"
                  f" s, dtAlg {r.dt_alg * 1e3:.3f} ms,"
                  f" {r.dt_alg * 1e3 / r.iters:.4f} ms/iter, {r.iters}"
                  f" iterations, true residual {r.residual_true!r}",
                  flush=True)
        print(f"10M iterations side by side: pallas_dia {its['pallas_dia']},"
              f" stencil + restrided factors {its['stencil']}", flush=True)
    path3 = counts()
    check_counted("main path 3 (banded DIA)", path3,
                  ("dia_spmv", "const_stencil_spmv"))
    del ps_dia, ps_st, a

    with phase(timer, "2-D stencil parity"):
        a3 = ct.grid_laplacian(BENCH_SIDE, BENCH_SIDE)
        ps3 = ct.make_solver(a3, ct.SolverConfig(maxit=20000, tol=1e-6),
                             device=dev)
        stencil2d_parity(ps3, a3, stats, smi)

    # ---- main path 4b: StencilOperator2D in place of a matrix
    reset_counts()
    with phase(timer, "StencilOperator2D solves"):
        stencil2d_solves(dev)
    with phase(timer, "10M h-form on B7 beside B1"):
        hform_10m(ps3, a3, dev)
    path4b = counts()
    check_counted("main path 4b (StencilOperator2D)", path4b,
                  ("stencil2d_spmv", "const_stencil_spmv"))
    with phase(timer, "10M h-form profiles"):
        hform_10m_profile(ps3, a3, dev)
    del ps3, a3

    # ---- main path 5: the unpadded operators
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("TF32 matmuls are on: BELL, dense and the blocked"
                           " trisolve would not run in full f32")
    reset_counts()
    table = []
    with phase(timer, "5a random system"):
        a = problems.random_diag_nonzero_system(*RANDOM_SYSTEM, seed=0)[0]
        print(f"random system: n {a.n}, nnz {a.nnz}, max row"
              f" {a.row_lengths.max()}", flush=True)
        if operator_check(a, None, torch.float32, "random system",
                          table) is not ops.ELLOperator:
            raise RuntimeError("make_operator did not pick ELL")
        for fmt in UNPADDED[:-1]:
            for dt in (torch.float32, torch.float64):
                operator_check(a, fmt, dt, "random system", table)
        random_system_solves(a, dev)
    with phase(timer, "5b shuffled 1M"):
        shuffled_1m(shuffled_laplacian(SHUFFLED_SIDE), dev, table)
    got = counts()
    print(f"main path 5a-5b launches: {got}", flush=True)
    if any(got.values()):
        raise RuntimeError("5a-5b launched a kernel of this repository")
    print(json.dumps({"matvec_table": table}), flush=True)
    with phase(timer, "5c blocked trisolve"):
        blocked_trisolves(dev)
    with phase(timer, "5d-5e bicg and split on csr"):
        bicg_and_split(dev)
    path5 = counts()
    check_counted("main path 5 (unpadded operators)", path5,
                  ("const_stencil_spmv",))

    paths = (path1, path2, path3, path4a, path4b, path5)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(p[k] for p in paths), **stats[k]}
        for k, (src, rep) in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
