"""cuda_mat_tpu_torch — the PyTorch/CUDA port of ``cuda_mat_tpu``.

The JAX package stays the reference; this package mirrors its layout so
each module's counterpart is easy to find, imports ``torch`` and numpy, and
never JAX.  Ported: Matrix Market ingestion and writing; the
CSR/COO/ELL/DIA/BSR host formats; the reference's three entry points
(``bicgstab``, ``bicgstab_split``, ``bicgstab_lu_precond``),
``solve``/``make_solver``
and ``bicg`` on any square matrix — constant-coefficient grid stencils
matrix-free, other bands as padded DIA, everything else (or any
``format="csr"|"ell"|"dia"|"bell"|"dense"``) on the unpadded operators of
``make_operator`` — with no preconditioner, Jacobi, exact ILU(0) (banded
or generic blocked triangular solves) or the Neumann-series ILU(0)/MILU(0)
(constant or exact factors; the 10M-row flagship), reverse Cuthill–McKee
reordering (``reorder="rcm"``), the loop's opt-in fusions
(``fuse_blas1``, ``fused_dots``, ``check_halves=False``), a device
operator such as the 2-D tile stencil ``StencilOperator2D`` in place of a
matrix, f64 host refinement, the per-iteration ``debug=True`` prints, the
command line (``python -m cuda_mat_tpu_torch.cli``), the generator
(``python -m cuda_mat_tpu_torch.generator``), the host utilities
(checkpoints, norms, dense QR, the OMP text formats) and the numpy CPU
oracles; and the row-partitioned distributed solver
(:mod:`cuda_mat_tpu_torch.parallel`) with its three local engines: stock
torch ops, the banded DIA kernel B3 and the stencil kernels B1/B2/B5 a
shard.  Every entry point solves through one
:meth:`PreparedSolver.solve`, the host boundary of every solve.  The hot
kernels are hand-written for Hopper (``csrc/*.cu``, built with nvcc at
first use); on CPU tensors they run as plain PyTorch.
"""

from cuda_mat_tpu_torch.config import SolverConfig
from cuda_mat_tpu_torch.formats.bsr import BSRMatrix
from cuda_mat_tpu_torch.formats.coo import COOMatrix
from cuda_mat_tpu_torch.formats.csr import CSRMatrix
from cuda_mat_tpu_torch.formats.dia import DIAMatrix
from cuda_mat_tpu_torch.formats.ell import ELLMatrix
from cuda_mat_tpu_torch.io.mmio import (load_mm_sparse_matrix, read_mm,
                                        write_mm)
from cuda_mat_tpu_torch.io.vectors import to_dense_vector
from cuda_mat_tpu_torch.models.problems import (banded_laplacian_dia,
                                               grid_laplacian, split_form)
from cuda_mat_tpu_torch.ops.stencil2d import StencilOperator2D
from cuda_mat_tpu_torch.solvers.bicg import bicg
from cuda_mat_tpu_torch.solvers.bicgstab import (PreparedSolver, bicgstab,
                                                 bicgstab_lu_precond,
                                                 bicgstab_split, make_solver,
                                                 solve)
from cuda_mat_tpu_torch.solvers.refine import solve_refined
from cuda_mat_tpu_torch.solvers.result import SolveResult, SolverStatus

__all__ = [
    "BSRMatrix",
    "COOMatrix",
    "CSRMatrix",
    "DIAMatrix",
    "ELLMatrix",
    "PreparedSolver",
    "SolveResult",
    "SolverConfig",
    "SolverStatus",
    "StencilOperator2D",
    "banded_laplacian_dia",
    "bicg",
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
    "write_mm",
]
