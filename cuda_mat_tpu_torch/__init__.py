"""cuda_mat_tpu_torch — the PyTorch/CUDA port of ``cuda_mat_tpu``.

The JAX package stays the reference; this package mirrors its layout so
each module's counterpart is easy to find, imports ``torch`` and numpy, and
never JAX.  Ported so far: Matrix Market ingestion; the reference's three
entry points (``bicgstab``, ``bicgstab_split``, ``bicgstab_lu_precond``)
and ``solve``/``make_solver`` on banded matrices — constant-coefficient
grid stencils matrix-free, other bands as DIA — with no preconditioner,
Jacobi, exact ILU(0) or the Neumann-series ILU(0)/MILU(0) (constant or
exact factors; the 10M-row flagship), and f64 host refinement.
The hot kernels are hand-written for Hopper (``csrc/*.cu``, built with nvcc
at first use); on CPU tensors they run as plain PyTorch.
"""

from cuda_mat_tpu_torch.config import SolverConfig
from cuda_mat_tpu_torch.formats.csr import CSRMatrix
from cuda_mat_tpu_torch.formats.dia import DIAMatrix
from cuda_mat_tpu_torch.io.mmio import load_mm_sparse_matrix, read_mm
from cuda_mat_tpu_torch.io.vectors import to_dense_vector
from cuda_mat_tpu_torch.models.problems import (banded_laplacian_dia,
                                               grid_laplacian, split_form)
from cuda_mat_tpu_torch.solvers.bicgstab import (PreparedSolver, bicgstab,
                                                 bicgstab_lu_precond,
                                                 bicgstab_split, make_solver,
                                                 solve)
from cuda_mat_tpu_torch.solvers.refine import solve_refined
from cuda_mat_tpu_torch.solvers.result import SolveResult, SolverStatus

__all__ = [
    "CSRMatrix",
    "DIAMatrix",
    "PreparedSolver",
    "SolveResult",
    "SolverConfig",
    "SolverStatus",
    "banded_laplacian_dia",
    "bicgstab",
    "bicgstab_lu_precond",
    "bicgstab_split",
    "grid_laplacian",
    "load_mm_sparse_matrix",
    "make_solver",
    "read_mm",
    "solve",
    "solve_refined",
    "split_form",
    "to_dense_vector",
]
