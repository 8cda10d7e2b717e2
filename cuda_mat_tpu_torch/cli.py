"""Command-line driver — the equivalent of the reference ``example`` binary
(counterpart of :mod:`cuda_mat_tpu.cli`: the same flags, defaults, printed
lines, error strings and exit codes).

Mirrors the reference CLI contract (reference example.cpp:168-378):

- ``-M/--matrix``     Matrix Market file for A (else a random system)
- ``-V/--vector``     Matrix Market file for b (else random, P(zero)=0.2)
- ``-D/--debug``      per-iteration residual prints
- ``-R/--zero-prob``  P(zero) for the random matrix (default 0.99)
- ``-N/--dim``        dimension of the random system (default 10000)
- ``-P/--print``      print the solution vector
- maxit=2000, tol=1e-6 defaults (reference example.cpp:179-180); the default
  solve is ILU(0)-preconditioned BiCGSTAB (reference example.cpp:352)

Flags whose JAX meaning has no torch counterpart are mapped, never dropped:
``--platform cpu|cuda`` (default: the card; without one the CLI exits 1
unless ``--platform cpu`` is given), ``--x64`` (float64 as the default
``--dtype``; nothing global is set), ``--debug-nans`` (FloatingPointError at
the first non-finite residual), ``--profile DIR`` (a ``torch.profiler``
Chrome trace of the solve phase in DIR, with the program's spans of
:mod:`~cuda_mat_tpu_torch.utils.timing` beside the kernels) and
``--devices N`` (the distributed solver over a mesh of N row shards of the
``--platform`` device).  ``--format`` reaches the solver, including the inner solver of
``--refine`` (the JAX CLI drops it, ROADMAP C8).  With ``--devices``,
``--format`` and ``--reorder`` have no path and exit 1 (the JAX CLI drops
them silently, ROADMAP C11).

Usage::

    python -m cuda_mat_tpu_torch.cli -M data/mat10000.mtx -D
    python -m cuda_mat_tpu_torch.cli -M data/mat10000.mtx --platform cpu --x64
    python -m cuda_mat_tpu_torch.cli -N 4000 -R 0.999 --precond jacobi
    python -m cuda_mat_tpu_torch.cli -M data/mat10000.mtx --devices 4 \
        --precond none --x64
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

REFINE_INNER_TOL = 1e-4       # solve_refined's default inner tolerance


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cuda_mat_tpu_torch",
        description="sparse BiCGSTAB Ax=b solver on a CUDA card (Matrix"
                    " Market ingestion, hand-written Hopper kernels,"
                    " ILU(0)/Jacobi)")
    p.add_argument("-M", "--matrix", help=".mtx file for A")
    p.add_argument("-V", "--vector", help=".mtx file for b")
    p.add_argument("-D", "--debug", action="store_true",
                   help="print per-iteration residual norms")
    p.add_argument("-R", "--zero-prob", type=float, default=0.99,
                   help="P(zero) for random off-diagonal entries")
    p.add_argument("-N", "--dim", type=int, default=10000,
                   help="dimension of the generated random system")
    p.add_argument("-P", "--print", dest="print_x", action="store_true",
                   help="print the solution vector")
    p.add_argument("--solver", choices=["bicgstab", "bicg"],
                   default="bicgstab")
    p.add_argument("--precond",
                   choices=["none", "jacobi", "ilu0", "ilu0_neumann",
                            "bjacobi_ilu0"],
                   default="ilu0")
    p.add_argument("--neumann-terms", type=int, default=3,
                   help="series terms k for --precond ilu0_neumann")
    p.add_argument("--neumann-exact-factors", action="store_true",
                   help="ilu0_neumann on the stencil path: keep exact-pattern"
                        " restrided factors instead of the fused"
                        " interior-constant series")
    p.add_argument("--milu-omega", type=float, default=0.0,
                   help="relaxed modified-ILU(0) factor values for the"
                        " ilu0 / ilu0_neumann preconditioners: omega x"
                        " dropped fill subtracted from the diagonal"
                        " (0 = reference-parity ILU(0))")
    p.add_argument("--fuse-blas1", action="store_true",
                   help="fold the p-update/r1 axpys into the fused msolve"
                        " kernel (stencil ilu0_neumann path)")
    p.add_argument("--maxit", type=int, default=2000)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--dtype", choices=["float32", "float64"], default=None,
                   help="default: float64 with --x64, else float32")
    p.add_argument("--format",
                   choices=["csr", "ell", "dia", "bell", "dense",
                            "pallas_dia", "stencil"],
                   default=None, help="force an operator format (pallas_dia ="
                   " banded DIA kernel; stencil = matrix-free"
                   " constant-coefficient grid stencil)")
    p.add_argument("--trisolve-block", type=int, default=128)
    p.add_argument("--reorder", choices=["none", "rcm"], default="none",
                   help="bandwidth-reducing reordering (RCM) before the "
                        "solve; x is scattered back to the input ordering")
    p.add_argument("--devices", type=int, default=None,
                   help="row-partition across N shards of the device"
                        " (distributed solver)")
    p.add_argument("--refine", action="store_true",
                   help="mixed-precision iterative refinement: f32 device "
                        "solves + f64 host residual correction")
    p.add_argument("--omp-format", action="store_true",
                   help="read -M/-V in the bicstab_omp custom text formats "
                        "instead of Matrix Market")
    p.add_argument("--checkpoint", help="save the final iterate to this .npz")
    p.add_argument("--resume", help="resume x0 from a checkpoint .npz")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the solve"
                        " into DIR")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast (FloatingPointError) on a non-finite"
                        " residual")
    p.add_argument("--x64", action="store_true",
                   help="float64 as the default --dtype")
    p.add_argument("--platform", choices=["cpu", "cuda"], default=None,
                   help="device to solve on (default: the CUDA card)")
    p.add_argument("--seed", type=int, default=0)
    return p


@contextlib.contextmanager
def profile_into(out_dir, device):
    """``torch.profiler`` over the block (CPU activity, and CUDA's on a
    card), written as a Chrome trace into ``out_dir`` (made if missing)."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        out_dir, f"solve-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
                 ".pt.trace.json"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    device = torch.device(args.platform or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --platform cpu to solve on the CPU",
              file=sys.stderr)
        return 1

    from cuda_mat_tpu_torch import (CSRMatrix, SolverConfig, bicg,
                                    load_mm_sparse_matrix, make_solver,
                                    read_mm, solve, to_dense_vector)
    from cuda_mat_tpu_torch.models.problems import (gen_rand_vector,
                                                    random_diag_nonzero_system)
    from cuda_mat_tpu_torch.solvers.bicgstab import debug_nans
    from cuda_mat_tpu_torch.utils.timing import PhaseTimer

    if args.dtype is None:
        args.dtype = "float64" if args.x64 else "float32"

    timer = PhaseTimer()
    t_total0 = time.perf_counter()

    with timer.phase("load"):
        if args.matrix:
            print(f"Using matrix input file [{args.matrix}]")
            if args.omp_format:
                from cuda_mat_tpu_torch.io import omp_format

                a = omp_format.read_matrix(args.matrix)
            else:
                a = load_mm_sparse_matrix(args.matrix)
            if a.n != a.m:
                print("!!!! square matrix is expected", file=sys.stderr)
                return 1
        else:
            a, _ = random_diag_nonzero_system(args.dim, args.zero_prob,
                                              seed=args.seed)
        if args.vector:
            print(f"Using vector input file [{args.vector}]")
            if args.omp_format:
                from cuda_mat_tpu_torch.io import omp_format

                b = omp_format.read_vector(args.vector)
                if b.shape[0] != a.n:
                    print("incorrect dim", file=sys.stderr)
                    return 1
            else:
                _, coo = read_mm(args.vector)
                vec = CSRMatrix.from_coo(coo)
                if vec.m != 1:
                    print("b must be a vector !", file=sys.stderr)
                    return 1
                if vec.n != a.n:
                    print("incorrect dim", file=sys.stderr)
                    return 1
                b = to_dense_vector(vec)
        else:
            b = gen_rand_vector(a.n, 0.2, 1.0, 5.0, seed=args.seed + 1)

    print(f"n={a.n}, nnz={a.nnz}, solver={args.solver}, "
          f"precond={args.precond}, dtype={args.dtype}, "
          f"backend={device.type}")

    cfg = SolverConfig(maxit=args.maxit, tol=args.tol, debug=args.debug,
                       dtype=args.dtype, precond=args.precond,
                       trisolve_block=args.trisolve_block,
                       reorder=args.reorder, neumann_terms=args.neumann_terms,
                       neumann_const_factors=not args.neumann_exact_factors,
                       fuse_blas1=args.fuse_blas1,
                       milu_omega=args.milu_omega)

    x0 = None
    if args.resume:
        from cuda_mat_tpu_torch.utils.checkpoint import load_checkpoint

        ck = load_checkpoint(args.resume)
        x0 = ck.x
        print(f"resuming from {args.resume} (iters={ck.iters}, "
              f"residual={ck.residual:.3e})")

    prof = (profile_into(args.profile, device) if args.profile
            else contextlib.nullcontext())
    # flag-combination contract: no flag is ever silently dropped
    if args.solver == "bicg" and (args.refine or args.devices):
        print("--solver bicg has no refined/distributed path; drop "
              "--refine/--devices or use --solver bicgstab", file=sys.stderr)
        return 1
    nans = debug_nans() if args.debug_nans else contextlib.nullcontext()
    with nans, prof, timer.phase("solve", device):
        if args.devices:
            if args.precond == "ilu0":
                print("exact global ILU(0) does not distribute; use "
                      "--precond bjacobi_ilu0 (per-shard ILU) or jacobi",
                      file=sys.stderr)
                return 1
            if args.format is not None or args.reorder != "none":
                # the JAX CLI drops both here without a word (ROADMAP C11)
                print("--format/--reorder do not reach the distributed "
                      "solver (row partitions, no reordering); drop them or "
                      "--devices", file=sys.stderr)
                return 1
            from cuda_mat_tpu_torch.parallel import (dist_bicgstab,
                                                     make_mesh)

            mesh = make_mesh(args.devices, device=device)
            if args.refine:
                from cuda_mat_tpu_torch.solvers.refine import solve_refined

                # f32 inner solves over the mesh, f64 host residual restarts
                res = solve_refined(a, b, cfg, x0=x0, mesh=mesh)
            else:
                res = dist_bicgstab(a, b, mesh, cfg, x0=x0)
        elif args.solver == "bicg":
            res = bicg(a, b, cfg, format=args.format, device=device)
        elif args.refine:
            from cuda_mat_tpu_torch.solvers.refine import solve_refined

            # the f32 inner solver is built here so that --format reaches
            # it; its setup counts in the result's, as when solve_refined
            # builds it
            inner = make_solver(a, cfg.replace(dtype="float32",
                                               tol=REFINE_INNER_TOL,
                                               true_residual=False),
                                args.format, device=device)
            res = solve_refined(a, b, cfg, REFINE_INNER_TOL, x0=x0,
                                solver=inner)
            res.dt_setup += inner.dt_setup
        else:
            res = solve(a, b, cfg, x0=x0, format=args.format, device=device)
    t_total = time.perf_counter() - t_total0

    if args.checkpoint:
        from cuda_mat_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, res)
        print(f"checkpoint saved to {args.checkpoint}")

    if res.converged:
        print("success")
        if args.print_x:
            print("result:")
            from cuda_mat_tpu_torch.io.vectors import dump_vector

            print(dump_vector(res.x))
        print(f"iterations = {res.iters}, relative residual = "
              f"{res.residual / res.residual0:.3e}")
        if res.residual_true is not None:
            # recomputed ||b - A x|| in f64 on the host — the recursive
            # residual above drifts optimistic in f32
            rel_true = res.residual_true / res.residual0
            print(f"true relative residual = {rel_true:.3e}")
            # the miss is only attributable to f32 drift — and fixable by
            # --refine — when the recursive residual itself converged
            if not args.refine and res.converged and rel_true > 10 * cfg.tol:
                print(f"note: the true residual misses tol={cfg.tol:.0e} "
                      f"(f32 recursive-residual drift); rerun with --refine "
                      f"for f64-grade accuracy at f32 speed")
        print(f"algorithm delta time = {res.dt_alg:.6f} s")
        print(f"setup time (operator+precond) = {res.dt_setup:.6f} s")
        print(f"total delta time = {t_total:.6f} s")
        return 0
    print(f"method failed: {res.status.name} after {res.iters} iterations "
          f"(residual {res.residual:.3e})", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
