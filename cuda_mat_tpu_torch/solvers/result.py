"""Structured solve results.

The reference reports success as a bare bool — and the ILU path always
returns ``true`` even when it hit maxit without converging (reference
pbicgstab.cu:408).  The unpreconditioned paths distinguish convergence from
omega-breakdown only by the bool (reference pbicgstab.cu:554-566).  Here the
result is structured: status, iteration count, final residual, timings, and
the residual trajectory (the reference exposes the trajectory only as debug
prints, pbicgstab.cu:113-114,:550-552 — promoting it to data is what makes
trajectory tests possible, SURVEY §4).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class SolverStatus(enum.IntEnum):
    RUNNING = 0
    CONVERGED = 1
    BREAKDOWN = 2      # |omega| < breakdown_tol or NaN (reference pbicgstab.cu:559)
    MAXIT = 3


@dataclasses.dataclass
class SolveResult:
    x: np.ndarray
    status: SolverStatus
    iters: int
    residual: float            # recursive residual norm from the iteration
    residual0: float
    dt_alg: float = 0.0        # solver-only time, reference dtAlg semantics
    dt_setup: float = 0.0      # operator + preconditioner setup
    residual_history: Optional[np.ndarray] = None  # -1 entries = unused slots
    # ||b - A x|| recomputed in float64 on the host after the solve.  The
    # in-loop ``residual`` is the *recursive* residual (the reference's
    # convergence quantity, pbicgstab.cu:116,147) which drifts from the true
    # residual in f32, so CONVERGED is only an honest claim next to this
    # number.  None when true_residual=False.
    residual_true: Optional[float] = None

    @property
    def converged(self) -> bool:
        return self.status == SolverStatus.CONVERGED

    @property
    def breakdown(self) -> bool:
        return self.status == SolverStatus.BREAKDOWN

    def __bool__(self) -> bool:
        # the reference's bool return value (pbicgstab.h:113-120)
        return self.converged

    def trajectory(self) -> np.ndarray:
        """Residual norms actually recorded (history with unused slots removed)."""
        if self.residual_history is None:
            return np.array([])
        h = np.asarray(self.residual_history)
        return h[h >= 0]
