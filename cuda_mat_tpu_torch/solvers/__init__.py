"""The BiCGSTAB family and BiCG (the exports of
:mod:`cuda_mat_tpu.solvers`)."""

from cuda_mat_tpu_torch.solvers.bicg import bicg
from cuda_mat_tpu_torch.solvers.bicgstab import (PreparedSolver, bicgstab,
                                                 bicgstab_lu_precond,
                                                 bicgstab_split, make_solver,
                                                 solve)
from cuda_mat_tpu_torch.solvers.refine import solve_refined
from cuda_mat_tpu_torch.solvers.result import SolveResult, SolverStatus

__all__ = [
    "SolveResult",
    "SolverStatus",
    "bicgstab",
    "bicgstab_split",
    "bicgstab_lu_precond",
    "bicg",
    "solve",
    "make_solver",
    "PreparedSolver",
    "solve_refined",
]
