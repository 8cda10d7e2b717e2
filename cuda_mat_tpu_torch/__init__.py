"""cuda_mat_tpu_torch — the PyTorch/CUDA port of ``cuda_mat_tpu``.

The JAX package stays the reference; this package mirrors its layout so
each module's counterpart is easy to find, imports ``torch`` and numpy, and
never JAX.  Ported so far: the flagship solve path — a constant-coefficient
grid stencil (the Laplacian family) solved by Neumann-series ILU(0)/MILU(0)
preconditioned BiCGSTAB, with f64 host refinement.  Its two hot kernels are
hand-written for Hopper (``csrc/const_stencil.cu``, built with nvcc at first
use); on CPU tensors they run as plain PyTorch.
"""

from cuda_mat_tpu_torch.config import SolverConfig
from cuda_mat_tpu_torch.formats.csr import CSRMatrix
from cuda_mat_tpu_torch.formats.dia import DIAMatrix
from cuda_mat_tpu_torch.models.problems import grid_laplacian
from cuda_mat_tpu_torch.solvers.bicgstab import (PreparedSolver, make_solver,
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
    "grid_laplacian",
    "make_solver",
    "solve",
    "solve_refined",
]
