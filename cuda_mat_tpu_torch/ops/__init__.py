"""Device operators and kernels: the SpMV formats, the triangular solves
and the hand-written Hopper kernels behind them (the exports of
:mod:`cuda_mat_tpu.ops`)."""

from cuda_mat_tpu_torch.ops.operators import (CSROperator, DenseOperator,
                                              DIAOperator, ELLOperator,
                                              SplitOperator, make_operator)
from cuda_mat_tpu_torch.ops.trisolve import BlockTriangularSolver

__all__ = [
    "CSROperator",
    "ELLOperator",
    "DIAOperator",
    "SplitOperator",
    "DenseOperator",
    "make_operator",
    "BlockTriangularSolver",
]
