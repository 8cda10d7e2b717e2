"""Plain Jacobi-preconditioned BiCGSTAB in one dtype, the reference's loop
(two half-steps, each checked against tol * ||r0||), for the control: the
reference in the program's place at a lower precision than the
configuration states."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.operator import CSROperator


class Answer(NamedTuple):
    x: np.ndarray
    converged: bool
    iters: int
    residual: float


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u * v).sum()


def solve(a: CSROperator, b, x0, tol: float, maxit: int) -> Answer:
    """Runs to convergence, to ``maxit`` or to a breakdown (a residual norm
    that is not finite); on a breakdown it returns the last iterate whose
    residual was finite, and that residual."""
    dt, dev = a.dtype, a.vals.device
    inv_d = 1.0 / a.diag
    x = torch.as_tensor(x0, device=dev).to(dt)
    r = torch.as_tensor(b, device=dev).to(dt) - a.matvec(x)
    rw = r.clone()
    nrm0 = float(torch.sqrt(_dot(r, r)))
    p = torch.zeros_like(r)
    v = torch.zeros_like(r)
    rho = alpha = omega = torch.ones((), dtype=dt, device=dev)
    best, nrm, converged, i = x, nrm0, False, 0
    while i < maxit:
        rho_new = _dot(rw, r)
        p = r + (rho_new / rho) * (alpha / omega) * (p - omega * v)
        y = inv_d * p
        v = a.matvec(y)
        rho = rho_new
        alpha = rho / _dot(rw, v)
        x = x + alpha * y
        r = r - alpha * v
        half = float(torch.sqrt(_dot(r, r)))
        if not math.isfinite(half):
            break
        best, nrm = x, half
        if nrm < tol * nrm0:
            converged = True
            break
        z = inv_d * r
        t = a.matvec(z)
        omega = _dot(t, r) / _dot(t, t)
        x = x + omega * z
        r = r - omega * t
        i += 1
        full = float(torch.sqrt(_dot(r, r)))
        if not math.isfinite(full):
            break
        best, nrm = x, full
        if nrm < tol * nrm0:
            converged = True
            break
    return Answer(best.to(torch.float64).cpu().numpy(), converged, i, nrm)
