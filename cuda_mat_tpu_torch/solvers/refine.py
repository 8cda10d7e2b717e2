"""Mixed-precision iterative refinement (counterpart of
:mod:`cuda_mat_tpu.solvers.refine`, same control flow):

    r_k = b − A x_k          (float64, host)
    e_k ≈ solve(A, r_k)      (float32, device, tol_inner)
    x_{k+1} = x_k + e_k      (float64, host)

The inner solves run through ONE prepared solver, built once (the
reference's setup/solve split, pbicgstab.cu:335-363 vs :366):
:func:`~cuda_mat_tpu_torch.solvers.bicgstab.make_solver` on one device, or
:func:`~cuda_mat_tpu_torch.parallel.dist_solver.make_dist_bicgstab` over a
mesh of row shards.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from cuda_mat_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from cuda_mat_tpu_torch.solvers.bicgstab import host_matvec_f64, make_solver
from cuda_mat_tpu_torch.solvers.result import SolveResult, SolverStatus
from cuda_mat_tpu_torch.utils import timing


def solve_refined(a, b: np.ndarray, config: SolverConfig = DEFAULT_CONFIG,
                  inner_tol: float = 1e-4, max_restarts: int = 20,
                  x0: Optional[np.ndarray] = None, mesh=None,
                  local_engine: str = "auto", solver=None,
                  device="cuda") -> SolveResult:
    """Solve to ``config.tol`` relative residual in float64 terms, using
    float32 inner solves.

    ``mesh``: run the inner solves through the distributed solver over this
    mesh of row shards (``local_engine`` as in
    :func:`~cuda_mat_tpu_torch.parallel.dist_solver.make_dist_bicgstab`);
    the outer f64 arithmetic is the same either way (the JAX signature,
    cuda_mat_tpu/solvers/refine.py:39-77).

    ``solver``: a prebuilt :class:`~cuda_mat_tpu_torch.solvers.bicgstab.
    PreparedSolver` or :class:`~cuda_mat_tpu_torch.parallel.dist_solver.
    DistBicgstabSolver` for ``a`` to run the inner solves through (its
    config should solve to ~``inner_tol`` in float32; ``mesh`` and
    ``local_engine`` are then not read); otherwise one is built from
    ``config`` with ``dtype="float32"`` and ``tol=inner_tol``, over
    ``mesh`` or on ``device``.

    The returned ``residual_history`` holds the float64 outer residuals (one
    per restart); ``iters`` is the total inner iteration count.  A correction
    that makes the f64 residual worse is reverted and the loop stops with
    status MAXIT, as in the JAX package (its residual stays last in the
    history).

    Recorded as a ``refine`` (:mod:`~cuda_mat_tpu_torch.utils.timing`):
    each restart's host residual is the span ``refine.residual``, its
    inner solve ``refine.inner``.
    """
    with timing.record("refine") as rec:
        res = _refine(a, b, config, inner_tol, max_restarts, x0, mesh,
                      local_engine, solver, device)
    res.dt_setup = rec.seconds("refine") - res.dt_alg
    return res


def _refine(a, b, config, inner_tol, max_restarts, x0, mesh, local_engine,
            solver, device) -> SolveResult:
    b64 = np.asarray(b, dtype=np.float64)
    norm_b0: Optional[float] = None
    x = (np.ones(a.n, dtype=np.float64) if x0 is None
         else np.asarray(x0, dtype=np.float64))
    if solver is None:
        # inner solves skip the per-solve true-residual SpMV: the outer loop
        # already computes the f64 residual each restart
        inner_cfg = config.replace(dtype="float32", tol=inner_tol,
                                   true_residual=False)
        if mesh is not None:
            from cuda_mat_tpu_torch.parallel.dist_solver import \
                make_dist_bicgstab

            solver = make_dist_bicgstab(a, mesh, inner_cfg,
                                        local_engine=local_engine)
        else:
            solver = make_solver(a, inner_cfg, device=device)
    zero = np.zeros(a.n)
    total_inner = 0
    outer_hist: List[float] = []
    dt_alg = 0.0
    status = SolverStatus.MAXIT
    rel = np.inf
    prev_nrm = np.inf
    x_prev = x
    for _ in range(max_restarts):
        with timing.span("refine.residual"):
            r = b64 - host_matvec_f64(a, x)         # float64 true residual
            nrm = float(np.linalg.norm(r))
        if norm_b0 is None:
            norm_b0 = nrm if nrm > 0 else 1.0       # ||r0|| as in the reference
        outer_hist.append(nrm)
        if nrm > prev_nrm:
            # the last correction made the f64 residual worse: the inner
            # solve diverged — revert it and stop
            x = x_prev
            rel = prev_nrm / norm_b0
            break
        rel = nrm / norm_b0
        if rel < config.tol:
            status = SolverStatus.CONVERGED
            break
        with timing.span("refine.inner"):
            inner = solver.solve(r, x0=zero)
        dt_alg += inner.dt_alg
        total_inner += inner.iters
        if inner.status == SolverStatus.BREAKDOWN and \
                not np.isfinite(inner.x).all():
            status = SolverStatus.BREAKDOWN
            break
        prev_nrm = nrm
        x_prev = x
        x = x + inner.x.astype(np.float64)
    return SolveResult(
        x=x, status=status, iters=total_inner, residual=float(rel * norm_b0),
        residual0=float(norm_b0), dt_alg=dt_alg,
        residual_history=np.asarray(outer_hist),
        residual_true=float(rel * norm_b0))
