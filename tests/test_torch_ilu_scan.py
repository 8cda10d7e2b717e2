"""Iteration counts of exact-ILU(0) BiCGSTAB on the narrow-band Laplacian
family grid_laplacian(R, 100), b = ones, tol 1e-4, trisolve_block 128: the
JAX package (its CPU default: XLA operator + blocked triangular solver)
beside the PyTorch port (CPU, plain twins).

They anchor the window chip_smoke.py holds the port's 1M-row solve
(R = 10000) to, 80 ± 30: run as a script, for larger R,

    PYTHONPATH=. python tests/test_torch_ilu_scan.py 500 1000 2000 5000

prints the counts (R = 5000, 500k rows, takes a few minutes and ~3 GB of
host memory).  They do not grow with R, and part by up to ~15 iterations
between the packages and the dtypes: the trajectory is sensitive to the
order of sums.  The test checks the smallest of them.  (BASELINE.md's 118
iterations at R = 10000 came from another RHS/tolerance protocol,
BASELINE.md:123.)
"""

import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cuda_mat_tpu as cm
import cuda_mat_tpu.models.problems as jprob

import cuda_mat_tpu_torch as ct

WINDOW = (50, 110)   # chip_smoke.py's ONE_M_ITERS


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's block inverses in ILU(0) setups: with
    the test workers sharing the cores, OpenBLAS's spinning threads slow
    them a hundredfold."""
    with threadpool_limits(1):
        yield


def _solves(rows, dtype):
    a_j, a_t = jprob.grid_laplacian(rows, 100), ct.grid_laplacian(rows, 100)
    b = np.ones(a_t.n)
    kw = dict(maxit=2000, tol=1e-4, dtype=dtype, trisolve_block=128)
    return (cm.bicgstab_lu_precond(a_j, b, cm.SolverConfig(**kw)),
            ct.bicgstab_lu_precond(a_t, b, ct.SolverConfig(**kw),
                                   device="cpu"))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grid_family_lands_in_the_1m_window(dtype):
    torch.set_num_threads(1)
    rj, rt = _solves(500, dtype)
    assert rj.converged and rt.converged
    assert WINDOW[0] <= rj.iters <= WINDOW[1]
    assert WINDOW[0] <= rt.iters <= WINDOW[1]
    assert abs(rt.iters - rj.iters) <= 15


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for r in [int(a) for a in sys.argv[1:]] or [500, 1000, 2000]:
        for dt in ("float32", "float64"):
            rj, rt = _solves(r, dt)
            print(f"rows {r * 100} {dt}: jax {rj.status.name} {rj.iters} it,"
                  f" port {rt.status.name} {rt.iters} it", flush=True)
