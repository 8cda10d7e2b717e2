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
   layout, bitwise; times of kernel, twin and the library call (median of
   20 after a warm-up, CUDA events) and each kernel's bound; a small f64
   solve on the card against the same solve on the CPU (plain twins);
4. main path 1, the flagship: grid_laplacian(100000, 100) (10M rows),
   Neumann-ILU k=4, MILU omega 0.96, f32, tol 1e-4 — solved twice, then
   refined to a true f64 relative residual <= 1e-6; the launch counts must
   show that B1 and B2 carried every matvec and msolve; then the cost of
   the solver's per-iteration host poll;
5. banded trisolve parity: B4a and B4b (forward and backward) against their
   twins in f32 and f64 at the mat10000 layout and the 1M-row layout,
   within 1e-5 (f32) / 1e-12 (f64) of max|twin|; times and bounds as in 3;
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
   restrided factors on B3), each solved twice.

The line before last is a JSON object with each kernel's launches, error,
times and bound; the last line is {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
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
from cuda_mat_tpu_torch.native import loader as native
from cuda_mat_tpu_torch.ops import _kernels
from cuda_mat_tpu_torch.ops import banded_trisolve as bt
from cuda_mat_tpu_torch.ops import dia_spmv as ds
from cuda_mat_tpu_torch.ops import stencil as st
from cuda_mat_tpu_torch.precond import preconditioners as pre_mod
from cuda_mat_tpu_torch.solvers import bicgstab as bs
from cuda_mat_tpu_torch.utils.timing import PhaseTimer

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = (100000, 100)      # grid rows, cols: 10M rows, 50M nonzeros
ITERS = (33, 63)              # the flagship's 48 iterations (a TPU run) ± 15
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
}


@contextlib.contextmanager
def phase(timer, name):
    """A timed phase that ends with a device synchronise; prints its time."""
    with timer.phase(name, DEVICE):
        yield
    print(f"[phase] {name}: {timer.times[name]:.3f} s", flush=True)


def cuda_ms(fn, reps=20):
    """Median device time of ``fn`` in ms, after one warm-up call."""
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


def poison_allocator(like):
    """Leave a NaN-filled block of ``like``'s size in the caching allocator,
    so the next torch.empty of that size is likely to get it: an output
    element a kernel fails to write then shows as NaN."""
    torch.full_like(like, float("nan"))


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
    nowhere in the port).  ``check(out)`` returns its difference from the
    kernel, printed.  A call the installed torch refuses is recorded as
    ``none: <error>``."""
    try:
        out = call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        stats[name].update(library_ms=None, library=f"none: {e}"[:300])
        print(f"{name} library call {label}: none ({e})"[:400], flush=True)
        return
    ms = cuda_ms(call)
    stats[name].update(library_ms=ms, library=label)
    print(f"{name} library call {label}: {ms:.4f} ms, max|library - kernel|"
          f" / max|kernel| = {check(out)!r}", flush=True)


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
        yp = plain()
        torch.cuda.synchronize()
        if not torch.isfinite(yk).all():
            raise RuntimeError(f"{tag} {name}: non-finite kernel output")
        err = float((yk - yp).abs().max())
        line = f"{tag} {str(dtype)[6:]} {name}: max|kernel - twin| = {err!r}"
        if timed:
            ms, pms = cuda_ms(kern), cuda_ms(plain)
            stats[name].update(ms=ms, plain_ms=pms)
            line += f", kernel {ms:.4f} ms, twin {pms:.4f} ms"
        print(line, flush=True)
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        if err != 0.0:
            raise RuntimeError(f"{tag} {name}: kernel differs from its twin"
                               f" (max abs {err!r}; bitwise required)")
    if timed:
        # each padded vector read once and written once, plus the masks
        vec = x.numel() * x.element_size()
        n1 = len(op.strided_terms)
        n2 = len(pre.nl.strided_terms) + len(pre.nu.strided_terms)
        stats["const_stencil_spmv"].update(bound(
            2 * vec + gap.numel() * gap.element_size(), 2 * n1 * op.npad))
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


def band_sides(csr):
    """The lower and upper bandwidths of ``csr`` (and of its ILU(0)
    factor, which has its pattern): max(row - col), max(col - row)."""
    offs = csr.indices.astype(np.int64) - np.repeat(
        np.arange(csr.n, dtype=np.int64), csr.row_lengths)
    return int(max(-offs.min(), 0)), int(max(offs.max(), 0))


def trisolve_parity(tri, csr, tag, stats, timed):
    """B4a and B4b (forward, backward) against their twins on ``tri``'s
    arrays (the factor of ``csr``), within TRISOLVE_BOUND of max|twin|."""
    dtype = tri.wt_lo.dtype
    f = tri._pad(torch.from_numpy(
        np.random.default_rng(1).standard_normal(tri.n)).to(DEVICE))
    lo, up = (tri.wt_lo, tri.wct_lo), (tri.wt_up, tri.wct_up)
    cases = [
        ("banded_fused_msolve", "",
         lambda: bt.fused_msolve_padded(f, *lo, *up),
         lambda: bt.fused_msolve_padded_plain(f, *lo, *up)),
        ("banded_sweep", " forward",
         lambda: bt.banded_sweep_padded(f, *lo, True),
         lambda: bt.banded_sweep_padded_plain(f, *lo, True)),
        ("banded_sweep", " backward",
         lambda: bt.banded_sweep_padded(f, *up, False),
         lambda: bt.banded_sweep_padded_plain(f, *up, False)),
    ]
    for name, what, kern, plain in cases:
        poison_allocator(f)
        yk = kern()
        yp = plain()
        torch.cuda.synchronize()
        if not torch.isfinite(yk).all():
            raise RuntimeError(f"{tag} {name}{what}: non-finite kernel output")
        if torch.count_nonzero(yk[tri.n:]):
            raise RuntimeError(f"{tag} {name}{what}: padded rows not zero")
        err = float((yk - yp).abs().max())
        rel = err / float(yp.abs().max())
        line = (f"{tag} {str(dtype)[6:]} {name}{what}: max|kernel - twin| ="
                f" {err!r} ({rel!r} of max|twin|)")
        if timed and what != " backward":
            ms = cuda_ms(kern)
            pms = cuda_ms(plain, reps=5)
            stats[name].update(ms=ms, plain_ms=pms)
            line += f", kernel {ms:.4f} ms, twin {pms:.4f} ms (median of 5)"
        print(line, flush=True)
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        if not rel <= TRISOLVE_BOUND[dtype]:
            raise RuntimeError(f"{tag} {name}{what}: kernel differs from its"
                               f" twin by {rel!r} of max|twin| (bound"
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
        for k, arrays in (("banded_fused_msolve", 4), ("banded_sweep", 2)):
            dense_ms, nnz_ms = (
                (entries * item + 2 * vec) / HBM_BYTES_PER_S * 1e3
                for entries in (arrays * nb * blk * blk, sum(nnz[:arrays])))
            print(f"{tag} {k}: bound {stats[k]['bound_ms']:.4f} ms"
                  f" ({stats[k]['bound_by']}; structural nonzeros,"
                  f" bandwidths {w_lo}/{w_up}); its {arrays} (nb, B, B)"
                  f" arrays read whole: {dense_ms:.4f} ms; their nonzero"
                  f" entries alone: {nnz_ms:.4f} ms", flush=True)


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
            "dia_spmv": ds.dia_spmv_block_padded.launches}


def reset_counts():
    st.reset_launch_counts()
    bt.reset_launch_counts()
    ds.reset_launch_counts()


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
    ms = cuda_ms(lambda: ds.dia_spmv_block_padded(*args))
    pms = cuda_ms(lambda: ds.dia_spmv_block_padded_plain(*args))
    stats["dia_spmv"].update(ms=ms, plain_ms=pms)
    # the diagonals read once, x read once and y written once
    item = xk.element_size()
    stats["dia_spmv"].update(bound(
        (op.data.numel() + 2 * xk.numel()) * item,
        2 * len(op.offsets) * op.npad))
    gbps = (5 * op.n + 2 * op.n) * 4 / (ms * 1e-3) / 1e9
    print(f"bench 10M layout dia_spmv f32: kernel {ms:.4f} ms, twin"
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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
                    _kernels.dia_library, native.library)]:
                fut.result()
        print(f"built at once: kernels {_kernels.build_seconds}, native"
              f" parser/factorizer {native.build_seconds:.2f} s")
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 matmuls are on: the twins would not run"
                               " in full f32")

    dev = torch.device(DEVICE)
    cfg = ct.SolverConfig(maxit=2000, tol=1e-4, dtype="float32",
                          precond="ilu0_neumann", neumann_terms=4,
                          milu_omega=0.96)
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
    del ps, a

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

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": path1[k] + path2[k] + path3[k], **stats[k]}
        for k, (src, rep) in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
