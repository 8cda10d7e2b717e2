"""One run of one cell: set-up, the measured window, the traced solves, the
reference's check of the window's answers, and the result line.

The system under test is the port's prepared solver,
``cuda_mat_tpu_torch.make_solver`` then ``PreparedSolver.solve(b)`` for each
right-hand side, on the benchmark's own matrix and right-hand sides.  From
the program the harness takes only that call and what it returns.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from portbench import matrices, spec, trace, traffic
from portbench.reference.check import answer_readings, judge

FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_mat_tpu")


@dataclasses.dataclass
class SolveRow:
    wall_s: float        # the call with a host b until x is on the host
    dt_alg_s: float      # the program's loop time (SolveResult.dt_alg)
    iters: int
    steps: int           # loop steps executed, a first-half exit included
    converged: bool


@dataclasses.dataclass
class Record:
    """What the metric readers read (``metrics/<name>.py``)."""
    config: dict
    n: int
    nnz: int
    itemsize: int
    setup_s: float
    window_s: float
    solves: List[SolveRow]          # the window's, never profiled
    traced: List[SolveRow]          # the profiled solves after the window
    trace: Optional[trace.Summary]
    spans: dict


def steps_of(result) -> int:
    """Loop steps a solve executed: the residual history's written pairs
    (each step writes its first-half residual, a norm, into slot 2i)."""
    return int(np.count_nonzero(result.residual_history[0::2] >= 0))


def _row(result, wall_s: float) -> SolveRow:
    return SolveRow(wall_s, result.dt_alg, int(result.iters),
                    steps_of(result), bool(result.converged))


def forbidden_modules(modules) -> List[str]:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _timed_solve(ps, b):
    t = time.perf_counter()
    r = ps.solve(b)
    return r, time.perf_counter() - t


def prepared_solver(csr, config: dict, solver: dict, device):
    """The system under test: the port's ``make_solver`` on the benchmark's
    CSR arrays, with the configuration's solver fields and format."""
    from cuda_mat_tpu_torch import CSRMatrix, SolverConfig, make_solver

    return make_solver(CSRMatrix(csr.n, csr.n, csr.data, csr.indices,
                                 csr.indptr), SolverConfig(**solver),
                       format=config.get("format"), device=device)


def run(workload: str, seed: int, seconds: float, traced: bool, device: str,
        t_start: float, age_at_start: float = 0.0, root: str = spec.ROOT):
    """One run.  ``t_start``: ``time.perf_counter()`` at the process's
    start of work, ``age_at_start`` the process's age then.  Returns
    ``(result, info_lines, check_lines)``."""
    cell = spec.load_cell(workload, root)
    cfg, mix = cell.config, cell.traffic
    traffic.check(mix)
    solver = cfg["solver"]
    info, spans = [], {}

    t = time.perf_counter()
    import torch

    from cuda_mat_tpu_torch.native import loader
    from cuda_mat_tpu_torch.ops import _kernels
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
    spans["imports"] = time.perf_counter() - t

    t = time.perf_counter()
    csr = matrices.make(cfg["matrix"])
    spans["matrix"] = time.perf_counter() - t
    t = time.perf_counter()
    rhs = traffic.right_hand_sides(mix, csr.n, solver["dtype"], seed, dev)
    spans["rhs"] = time.perf_counter() - t

    t = time.perf_counter()
    ps = prepared_solver(csr, cfg, solver, dev)
    spans["make_solver"] = time.perf_counter() - t
    t = time.perf_counter()
    _timed_solve(ps, rhs[0])                  # warm-up
    spans["warm_up"] = time.perf_counter() - t
    builds = dict(_kernels.build_seconds, native=loader.build_seconds)
    info.append("builds (s, 0 = reused): " + ", ".join(
        f"{k} {v:.1f}" for k, v in builds.items()))

    # the window: one caller, closed loop, b_0 .. b_{K-1} in turn
    sample = traffic.Sample(int(mix["check_sample"]), seed)
    rows: List[SolveRow] = []
    t_open = time.perf_counter()
    setup_s = age_at_start + t_open - t_start
    deadline, t_end, k = t_open + seconds, t_open, 0
    while time.perf_counter() < deadline:
        r, wall = _timed_solve(ps, rhs[k % len(rhs)])
        t_end = time.perf_counter()
        rows.append(_row(r, wall))
        sample.offer(k, r.iters, (k % len(rhs), r.x, r.residual))
        k += 1
        del r
    window_s = t_end - t_open

    traced_rows: List[SolveRow] = []
    summary = None
    if traced:
        with trace.profiled(dev.type) as out:
            for j in range(int(mix["trace_solves"])):
                with trace.solve_span():
                    r, wall = _timed_solve(ps, rhs[(k + j) % len(rhs)])
                traced_rows.append(_row(r, wall))
        summary = out[0]
        if summary is not None:
            info.append("traced kernels (device s, launches): " + "; ".join(
                f"{trace.short(k, 60)} {v:.6f} {summary.launches[k]}"
                for k, v in sorted(summary.kernels.items(),
                                   key=lambda kv: -kv[1])[:25]))

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del ps
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference judges the window's answers, the program's state freed
    t = time.perf_counter()
    from portbench.reference.operator import CSROperator

    a_ref = CSROperator(csr.indptr, csr.indices, csr.data, dev, torch.float64)
    kept = sample.items()
    numbers = answer_readings(a_ref, np.ones(csr.n),
                              [(rhs[b], x, res) for _, (b, x, res) in kept])
    numbers["unconverged"] = sum(not r.converged for r in rows)
    del a_ref
    correct, check_lines, checks = judge(numbers, cell.limits["limits"])
    info.append(f"check: {len(kept)} answers of {len(rows)} judged in"
                f" {time.perf_counter() - t:.2f} s")

    rec = Record(cfg, csr.n, int(csr.indices.size),
                 np.dtype(solver["dtype"]).itemsize, setup_s, window_s, rows,
                 traced_rows, summary, spans)
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = spec.metric_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else dev.type,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(rows),
              "failed": int(numbers["unconverged"]), "metrics": metrics,
              "device": device_info}
    if summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    info.append("set-up parts (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in spans.items()))
    walls = sorted(r.wall_s * 1e3 for r in rows)
    half = len(rows) // 2
    info.append("solve wall ms: min {:.2f}, median {:.2f}, max {:.2f};"
                " means of the window's halves {:.2f}, {:.2f}".format(
                    walls[0], walls[len(walls) // 2], walls[-1],
                    sum(r.wall_s for r in rows[:half]) * 1e3 / max(half, 1),
                    sum(r.wall_s for r in rows[half:]) * 1e3
                    / max(len(rows) - half, 1)))
    info.append(f"window: {len(rows)} solves in {window_s:.3f} s,"
                f" {sum(r.iters for r in rows)} iterations,"
                f" {numbers['unconverged']} unconverged; set-up {setup_s:.3f} s;"
                f" peak device memory {peak} bytes")
    return result, info, check_lines
