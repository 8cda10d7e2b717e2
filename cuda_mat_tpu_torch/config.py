"""Solver configuration — the same fields and defaults as
:class:`cuda_mat_tpu.config.SolverConfig`, so a config means the same thing
to both packages.

The reference hardcodes its solve parameters in the CLI (maxit=2000,
tol=1e-6, reference example.cpp:179-180).  The JAX package's global
switches have no field here: ``dtype`` is always explicit (no
``use_x64``), and ``jax_debug_nans`` is the context manager
:func:`cuda_mat_tpu_torch.solvers.bicgstab.debug_nans`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Parameters of a BiCGSTAB solve (defaults follow the reference CLI)."""

    maxit: int = 2000
    tol: float = 1e-6
    # |omega| guard of the unpreconditioned loops (reference pbicgstab.cu:559)
    breakdown_tol: float = 1e-5
    # print each iteration's residuals (the JAX loops' jax.debug.print)
    debug: bool = False
    # device compute dtype: "float64" (the reference's precision) | "float32"
    dtype: str = "float64"
    # preconditioner: "none" | "jacobi" | "ilu0" | "ilu0_neumann"
    precond: str = "none"
    # block size of the blocked triangular solve (exact ILU(0) path)
    trisolve_block: int = 128
    # bandwidth-reducing reordering before the solve: "none" | "rcm"
    reorder: str = "none"
    # terms k of the truncated Neumann series for precond="ilu0_neumann"
    neumann_terms: int = 3
    # on the gap-strided stencil path, approximate the Neumann factors by
    # their deep-interior constants and apply them matrix-free (perturbs the
    # preconditioner only in a boundary layer; the system is unchanged)
    neumann_const_factors: bool = True
    # relaxed modified-ILU(0): omega times each row's dropped fill is
    # subtracted from its diagonal; 0 = reference-parity ILU(0)
    milu_omega: float = 0.0
    # recompute ||b - A x|| in float64 on the host after the solve
    true_residual: bool = True
    # fuse the alpha/omega dots into the matvec kernel's epilogue
    fused_dots: bool = False
    # fold the p-update / r1-production axpys into the msolve kernel
    fuse_blas1: bool = False
    # reference parity: test convergence after each half-iteration
    # (reference pbicgstab.cu:116,147)
    check_halves: bool = True

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SolverConfig()
