"""Preconditioners: identity, Jacobi, ILU(0) and the Neumann series (the
exports of :mod:`cuda_mat_tpu.precond`)."""

from cuda_mat_tpu_torch.precond.preconditioners import (
    IdentityPreconditioner, ILU0Preconditioner, JacobiPreconditioner,
    make_preconditioner)

__all__ = [
    "IdentityPreconditioner",
    "JacobiPreconditioner",
    "ILU0Preconditioner",
    "make_preconditioner",
]
