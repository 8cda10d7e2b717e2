"""Iteration counts of the CLI's exact-ILU(0) solves with the CLI's own
right-hand side (random, P(zero) = 0.2, seed 1; tol 1e-6, f64, trisolve
block 128): the JAX package beside the port, both on the CPU.  They set the
windows chip_smoke.py's path 6 holds the card to; the goldens (b = ones)
do not apply to this b.

    PYTHONPATH=. python tests/test_torch_cli_scan.py ulp 24
        mat10000, each of 24 entries of b (chosen by seed 0) moved one ulp
        up and down: the spread of each package's count (the trajectory
        parts from the last bit in the stagnating tail), ~1 min;
    PYTHONPATH=. python tests/test_torch_cli_scan.py family 500 1000 2000
        grid_laplacian(R, 100), the 1M-row file's family (R = 10000), at
        50k-200k rows, ~2 min; larger R take minutes and GBs each.

Read so far: mat10000 JAX 48..55, port 48..59 (as drawn 51 and 48); the
family JAX 102 / 115 / 114 / 107 and port 102 / 119 / 130 / 121 at R = 500
/ 1000 / 2000 / 5000.  The test checks R = 500 against the 1M window.
"""

import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cuda_mat_tpu as cm
import cuda_mat_tpu.models.problems as jprob

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.models.problems as tprob

ONE_M_WINDOW = (70, 160)      # chip_smoke.py's CLI_1M_ITERS


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's block inverses in ILU(0) setups."""
    with threadpool_limits(1):
        yield


def _cli_b(n):
    return tprob.gen_rand_vector(n, 0.2, 1.0, 5.0, seed=1)


def _solvers(a_j, a_t):
    kw = dict(precond="ilu0", dtype="float64", tol=1e-6, trisolve_block=128)
    return (cm.make_solver(a_j, cm.SolverConfig(**kw)),
            ct.make_solver(a_t, ct.SolverConfig(**kw), device="cpu"))


def family(rows):
    """(jax, port) iterations on grid_laplacian(rows, 100) with the CLI's
    b."""
    pj, pt = _solvers(jprob.grid_laplacian(rows, 100),
                      ct.grid_laplacian(rows, 100))
    b = _cli_b(rows * 100)
    rj, rt = pj.solve(b), pt.solve(b)
    assert rj.converged and rt.converged
    return rj.iters, rt.iters


def ulp(entries):
    """Each package's counts on mat10000 with ``entries`` entries of the
    CLI's b moved one ulp up and down."""
    path = tprob.fixture_path("mat10000")
    pj, pt = _solvers(cm.load_mm_sparse_matrix(path),
                      ct.load_mm_sparse_matrix(path))
    b = _cli_b(10000)
    its = {"jax": [pj.solve(b).iters], "port": [pt.solve(b).iters]}
    for k in np.random.default_rng(0).choice(b.size, entries, replace=False):
        for to in (np.inf, -np.inf):
            bk = b.copy()
            bk[k] = np.nextafter(bk[k], to)
            its["jax"].append(pj.solve(bk).iters)
            its["port"].append(pt.solve(bk).iters)
    return its


def test_cli_rhs_family_lands_in_the_1m_window():
    torch.set_num_threads(1)
    it_j, it_t = family(500)
    assert ONE_M_WINDOW[0] <= it_j <= ONE_M_WINDOW[1]
    assert ONE_M_WINDOW[0] <= it_t <= ONE_M_WINDOW[1]


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if sys.argv[1] == "ulp":
        its = ulp(int(sys.argv[2]))
        for k, v in its.items():
            print(f"mat10000 {k}: as drawn {v[0]}, over one-ulp changes"
                  f" {min(v)}..{max(v)} {sorted(set(v))}", flush=True)
    else:
        for r in [int(a) for a in sys.argv[2:]]:
            it_j, it_t = family(r)
            print(f"rows {r * 100}: jax {it_j} it, port {it_t} it",
                  flush=True)
