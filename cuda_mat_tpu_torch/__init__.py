"""cuda_mat_tpu_torch — the PyTorch/CUDA port of ``cuda_mat_tpu``.

The JAX package stays the reference; this package mirrors its layout so
each module's counterpart is easy to find, imports ``torch`` and numpy, and
never JAX.  Ported so far: Matrix Market ingestion and the solve path of
constant-coefficient grid stencils (the Laplacian family) by BiCGSTAB with
the Neumann-series ILU(0)/MILU(0) preconditioner (the flagship) or exact
ILU(0) (the reference's ``bicgstab_lu_precond``), with f64 host refinement.
The hot kernels are hand-written for Hopper (``csrc/*.cu``, built with nvcc
at first use); on CPU tensors they run as plain PyTorch.
"""

from cuda_mat_tpu_torch.config import SolverConfig
from cuda_mat_tpu_torch.formats.csr import CSRMatrix
from cuda_mat_tpu_torch.formats.dia import DIAMatrix
from cuda_mat_tpu_torch.io.mmio import load_mm_sparse_matrix, read_mm
from cuda_mat_tpu_torch.models.problems import grid_laplacian
from cuda_mat_tpu_torch.solvers.bicgstab import (PreparedSolver,
                                                 bicgstab_lu_precond,
                                                 make_solver, solve)
from cuda_mat_tpu_torch.solvers.refine import solve_refined
from cuda_mat_tpu_torch.solvers.result import SolveResult, SolverStatus

__all__ = [
    "CSRMatrix",
    "DIAMatrix",
    "PreparedSolver",
    "SolveResult",
    "SolverConfig",
    "SolverStatus",
    "bicgstab_lu_precond",
    "grid_laplacian",
    "load_mm_sparse_matrix",
    "make_solver",
    "read_mm",
    "solve",
    "solve_refined",
]
