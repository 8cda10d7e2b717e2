"""Plain BiCG in PyTorch (counterpart of :mod:`cuda_mat_tpu.solvers.bicg`),
the device twin of the reference's CPU OpenMP comparison solver.

It keeps the update order of reference bicstab_omp/bicstab.cpp:93-196 and
its two quirks: the convergence check uses the *entering* residual
``sqrt(<R,R>)/||b||`` (reference :164), and on the converged pass the final
``x += alfa*P`` is skipped (the check at :164-165 breaks before the update
at :167-168).  BiCG needs Aᵀ: its operator is built at load time from the
host transpose (which replaces the reference's ``Transpose2``,
bicstab.cpp:35-66).  As in the BiCGSTAB loops, scalars stay on the device
and the host reads ``status`` and ``i`` once per iteration.
"""

from __future__ import annotations

from typing import Optional

import torch

from cuda_mat_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from cuda_mat_tpu_torch.formats.csr import CSRMatrix
from cuda_mat_tpu_torch.ops.operators import make_operator
from cuda_mat_tpu_torch.solvers.bicgstab import (LoopWatch, PreparedSolver,
                                                 _dtype_of)
from cuda_mat_tpu_torch.solvers.result import SolveResult
from cuda_mat_tpu_torch.utils import timing
from cuda_mat_tpu_torch.utils.timing import device_sync


def bicg_core(matvec, matvec_t, b: torch.Tensor, eps: float, maxit: int,
              debug: bool = False):
    """The BiCG loop from x0 = ones.  Returns ``(x, status, iters, check,
    norm, hist)`` as device tensors: ``status`` 1 converged, 0 not;
    ``check`` the last relative residual tested (with no step, the
    entering one); ``hist`` (maxit,) the
    checks, −1 where none ran (``debug``: see
    :class:`~cuda_mat_tpu_torch.solvers.bicgstab.LoopWatch`)."""
    dot = torch.dot
    watch = LoopWatch(("iter = {}, check = {}",), debug)
    norm = torch.sqrt(dot(b, b))
    eps_t = torch.tensor(eps, dtype=b.dtype, device=b.device)
    x = torch.ones_like(b)
    r = b - matvec(x)
    bir, p, bip = r, r, r
    i_t = torch.zeros((), dtype=torch.int32, device=b.device)
    status_t = torch.zeros_like(i_t)
    # the entering relative residual, which the first step tests; with
    # maxit = 0 it is the result's, as the BiCGSTAB loops return theirs
    check = torch.sqrt(dot(r, r)) / norm
    hist = torch.full((maxit,), -1.0, dtype=b.dtype, device=b.device)
    status, i = 0, 0
    while i < maxit and status == 0:
        watch.step()
        ap = matvec(p)
        atbip = matvec_t(bip)
        numerator = dot(bir, r)
        alfa = numerator / dot(bip, ap)
        nr = r - alfa * ap
        nbir = bir - alfa * atbip
        beta = dot(nbir, nr) / numerator
        check = torch.sqrt(dot(r, r)) / norm
        conv = check < eps_t
        x = torch.where(conv, x, x + alfa * p)
        hist[i] = check
        i_t = torch.where(conv, i_t, i_t + 1)
        status_t = conv.to(torch.int32)
        r, bir, p, bip = nr, nbir, nr + beta * p, nbir + beta * bip
        status, i = watch.poll(status_t, i_t, (check,), i)
    watch.close()
    return x, status_t, i_t, check, norm, hist


class _BiCGSolver(PreparedSolver):
    """The loop is :func:`bicg_core` over ``op`` and Aᵀ's ``op_t``; it
    starts from its own ones, so the x0 it is given is not read."""

    def __init__(self, a, op, op_t, config: SolverConfig, dt_setup: float):
        super().__init__(a, op, None, config, dt_setup)
        self.op_t = op_t

    def _loop(self, x0d: torch.Tensor, bd: torch.Tensor):
        cfg = self._config
        return bicg_core(self.op.matvec, self.op_t.matvec, bd, cfg.tol,
                         cfg.maxit, cfg.debug)


def bicg(a, b, config: SolverConfig = DEFAULT_CONFIG,
         format: Optional[str] = None, device="cuda") -> SolveResult:
    """Solve Ax = b with plain BiCG, x0 = ones, to the relative residual
    ``config.tol`` (reference EPSILON = 1e-6, bicstab.cpp:9) within
    ``config.maxit`` iterations (reference :244).  ``a``: a host CSR
    matrix, whose operator and its transpose's are built by
    :func:`~cuda_mat_tpu_torch.ops.operators.make_operator` (``format``) on
    ``device``; or a pair ``(op, op_t)`` of unpadded operators for A and
    Aᵀ, used on their own device.  Solved as a
    :class:`~cuda_mat_tpu_torch.solvers.bicgstab.PreparedSolver`."""
    dt = _dtype_of(config)
    with timing.record("make_solver") as rec:
        with timing.span("make_solver.operator"):
            if isinstance(a, CSRMatrix):
                op = make_operator(a, dtype=dt, format=format, device=device)
                op_t = make_operator(a.transpose(), dtype=dt, format=format,
                                     device=device)
            else:
                op, op_t = a
        device_sync(op.device)
    return _BiCGSolver(a, op, op_t, config,
                       rec.seconds("make_solver")).solve(b)
