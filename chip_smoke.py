#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py          (from the repository root; one CUDA card,
                                    nvcc and g++ on the machine)

Phases, each printed with its elapsed seconds; any failure raises and the
script exits non-zero:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the Hopper kernels (nvcc, sm_90a) and the native MILU factorizer
   (g++), from the sources in this checkout;
3. kernel parity: each kernel against its plain PyTorch twin on the card,
   in f32 and f64, at the mat10000-sized layout and at the flagship
   layout, bitwise; times of kernel and twin (median of 20 after a
   warm-up, CUDA events), and a small-input check of the whole solve on the
   card against the same solve on the CPU (plain twins) in f64;
4. the flagship: grid_laplacian(100000, 100) (10M rows), Neumann-ILU k=4,
   MILU omega 0.96, f32, tol 1e-4 — solved twice; the kernel launch counts
   must show that kernels B1 and B2 carried every matvec and msolve;
5. refinement of the flagship to a true f64 relative residual <= 1e-6;
   then the cost of the solver's per-iteration host poll.

The line before last is a JSON object with each kernel's launches, error
and times; the last line is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.native import loader as native
from cuda_mat_tpu_torch.ops import _kernels
from cuda_mat_tpu_torch.ops import stencil as st
from cuda_mat_tpu_torch.solvers import bicgstab as bs
from cuda_mat_tpu_torch.utils.timing import PhaseTimer

FLAGSHIP = (100000, 100)      # grid rows, cols: 10M rows, 50M nonzeros
ITERS = (33, 63)              # the flagship's 48 iterations (a TPU run) ± 15
SMALL = (100, 100)            # the mat10000 grid
DEVICE = "cuda"
KERNELS = {
    "const_stencil_spmv": "cuda_mat_tpu/ops/pallas_stencil.py:306",
    "const_series_msolve": "cuda_mat_tpu/ops/pallas_stencil.py:624",
}
SOURCE = "cuda_mat_tpu_torch/csrc/const_stencil.cu"


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


def poll_cost(ps, b, iters):
    """ms per iteration of ``iters`` solver steps with and without the
    per-iteration status poll, and the host's enqueue time per iteration
    (each read from the second of two runs)."""
    c = bs.loop_constants(torch.float32, ps.device, 1e-4)
    bd, x0 = ps.op.pad_vec(b), ps.op.pad_vec(np.ones(ps.n))
    out = {}
    for poll in (True, False, True, False):
        st = bs.precond_init(ps.op.matvec, torch.dot, x0, bd, iters, c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            st = bs.precond_step(ps.op.matvec, ps.pre.msolve, torch.dot, st,
                                 i, c)
            if poll:
                torch.stack([st.status, st.i]).tolist()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out["poll" if poll else "no_poll"] = (t2 - t0) * 1e3 / iters
        if not poll:
            out["enqueue"] = (t1 - t0) * 1e3 / iters
    return out


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
        _kernels.library()
        native.library()
        print(f"kernels built in {_kernels.build_seconds:.2f} s, native"
              f" factorizer in {native.build_seconds:.2f} s")

    dev = torch.device(DEVICE)
    cfg = ct.SolverConfig(maxit=2000, tol=1e-4, dtype="float32",
                          precond="ilu0_neumann", neumann_terms=4,
                          milu_omega=0.96)
    stats = {k: {"max_abs_err": 0.0} for k in KERNELS}

    with phase(timer, "kernel parity"):
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

    # ---- the main path: two solves and the refinement, kernels counted
    b = np.ones(a.n)
    st.reset_launch_counts()
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
    launches = {"const_stencil_spmv": st.const_stencil_spmv_padded.launches,
                "const_series_msolve": st.const_series_msolve_padded.launches}

    with phase(timer, "poll cost"):
        pc = poll_cost(ps, b, r.iters)
        print(f"per-iteration host poll: {pc['poll']:.4f} ms/it with it,"
              f" {pc['no_poll']:.4f} ms/it without (host enqueue"
              f" {pc['enqueue']:.4f} ms/it); poll costs"
              f" {pc['poll'] - pc['no_poll']:.4f} ms/it")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": rep,
         "launches": launches[k], "max_abs_err": stats[k]["max_abs_err"],
         "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"]}
        for k, rep in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
