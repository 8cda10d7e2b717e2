"""The generic blocked triangular solver (``ops/trisolve.py``) of the port
against the JAX package's ``BlockTriangularSolver``, on the cases of
``tests/test_trisolve.py``, and the ILU(0) engine rule.

Both packages get the same factor (the numpy ILU(0) of the same matrix).
The host arrays are compared exactly; ``msolve`` and both sweeps within
1e-12 of max|x| of the JAX result (the two sum the gathered products in
other orders), in f64.  The JAX package runs exact ILU(0) on its blocked
engine where the band is wider than the block; the port runs it level by
level there (``ops/level_trisolve.py``), lands on the goldens
``mat900_ilu`` and ``mat10000_ilu`` within ±2 iterations, and keeps the
blocked solver for the distributed block-Jacobi ILU(0).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cuda_mat_tpu.models.problems as jprob
from cuda_mat_tpu.formats.csr import CSRMatrix as JCSRMatrix
from cuda_mat_tpu.io.mmio import load_mm_sparse_matrix as jload
from cuda_mat_tpu.ops import trisolve as jtri
from cuda_mat_tpu.precond import preconditioners as jpre
from cuda_mat_tpu.reference.cpu_solvers import ilu0_factorize

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.ops import trisolve as ttri
from cuda_mat_tpu_torch.ops.banded_trisolve import DiagTriSolver
from cuda_mat_tpu_torch.ops.level_trisolve import LevelTriSolver
from cuda_mat_tpu_torch.precond import preconditioners as tpre

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for the block inverses (see test_torch_ilu0.py)."""
    with threadpool_limits(1):
        yield


def _port(a):
    return ct.CSRMatrix(a.n, a.m, a.data, a.indices, a.indptr)


def _dominant(n, p0, lo, hi, seed, shift):
    a = jprob.gen_rand_csr_matrix(n, n, p0, lo, hi, seed=seed)
    return JCSRMatrix.from_dense(a.to_dense() + shift * np.eye(n))


CASES = {
    "banded B8": (lambda: jprob.banded_laplacian(12), 8),
    "banded B32": (lambda: jprob.banded_laplacian(12), 32),
    "banded B64": (lambda: jprob.banded_laplacian(12), 64),
    "block not dividing n": (lambda: jprob.banded_laplacian(11), 32),
    "block larger than n": (lambda: _dominant(20, 0.5, 1.0, 3.0, 5, 30), 64),
    "general sparse": (lambda: _dominant(100, 0.9, 0.5, 2.0, 9, 50), 16),
    "mat900": (lambda: jload(os.path.join(ROOT, "data", "mat900.mtx")), 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_msolve_matches_jax(case):
    make, block = CASES[case]
    a = make()
    m = ilu0_factorize(a)
    tri_j = jtri.BlockTriangularSolver.from_factor(a, m, block=block)
    tri_t = ttri.BlockTriangularSolver.from_factor(_port(a), m, block=block,
                                                   device="cpu")
    for f in ("w_lo", "vals_lo", "cols_lo", "w_up", "vals_up", "cols_up"):
        np.testing.assert_array_equal(getattr(tri_t, f).numpy(),
                                      np.asarray(getattr(tri_j, f)))
    f = np.random.default_rng(0).standard_normal(a.n)
    for what in ("solve_lower", "solve_upper", "msolve"):
        xj = np.asarray(getattr(tri_j, what)(jnp.asarray(f)))
        xt = getattr(tri_t, what)(torch.from_numpy(f)).numpy()
        assert xt.shape == (a.n,)
        assert np.abs(xt - xj).max() <= 1e-12 * np.abs(xj).max(), what


def test_f32_arrays_are_the_f64_arrays_rounded():
    a = _port(jprob.banded_laplacian(11))
    m = ilu0_factorize(a)
    t64 = ttri.BlockTriangularSolver.from_factor(a, m, block=32,
                                                 device="cpu")
    t32 = ttri.BlockTriangularSolver.from_factor(a, m, block=32,
                                                 dtype=torch.float32,
                                                 device="cpu")
    assert torch.equal(t32.w_lo, t64.w_lo.float())
    assert t32.cols_up.dtype == torch.int32
    f = torch.from_numpy(np.random.default_rng(1).standard_normal(a.n))
    x32 = t32.msolve(f.float())
    assert x32.dtype == torch.float32
    assert float((x32.double() - t64.msolve(f)).abs().max()) <= \
        1e-5 * float(t64.msolve(f).abs().max())


@pytest.mark.parametrize("block,engine", [(64, DiagTriSolver),
                                          (16, LevelTriSolver)])
def test_ilu0_engine_rule(block, engine):
    """Bandwidth 31 (mat900): the banded engine when it fits the block (its
    diagonal-form route: four offsets a triangle), the level-scheduled one
    when it does not; either against the blocked solver's msolve."""
    a = ct.load_mm_sparse_matrix(os.path.join(ROOT, "data", "mat900.mtx"))
    pre = tpre.ILU0Preconditioner.from_csr(a, block=block, device="cpu")
    assert type(pre.tri) is engine
    f = torch.from_numpy(np.random.default_rng(2).standard_normal(a.n))
    ref = ttri.BlockTriangularSolver.from_factor(
        a, ilu0_factorize(a), block=block, device="cpu").msolve(f)
    assert float((pre.msolve(f) - ref).abs().max()) <= \
        1e-12 * float(ref.abs().max())


def test_block_inverse_guard_matches_jax_for_a_wide_band():
    """Each package's behaviour on a band wider than the block past the
    2 GiB guard (ROADMAP C13): the JAX package applies the guard before it
    picks its engine and raises; the port builds no block inverses there
    and takes the "levels" route."""
    a_j = jprob.grid_laplacian(300, 1400)       # bandwidth 1400 > 1024
    with pytest.raises(ValueError, match="GiB of block inverses"):
        jpre.ILU0Preconditioner.from_csr(a_j, block=1024)
    pre = tpre.ILU0Preconditioner.from_csr(_port(a_j), block=1024,
                                           device="cpu")
    assert pre.route == "levels"
    assert pre.tri.lower.levels == pre.tri.upper.levels == 300 + 1400 - 1


@pytest.mark.parametrize("name,block", [("mat900", 16), ("mat10000", 64)])
def test_blocked_ilu0_lands_on_the_golden(name, block):
    a = ct.load_mm_sparse_matrix(os.path.join(ROOT, "data", f"{name}.mtx"))
    g = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}_ilu.npz"))
    ps = ct.make_solver(a, ct.SolverConfig(maxit=2000, tol=1e-6,
                                           precond="ilu0",
                                           trisolve_block=block),
                        device="cpu")
    assert isinstance(ps.pre.inner.tri, LevelTriSolver)
    r = ps.solve(np.ones(a.n))
    assert r.converged and abs(r.iters - int(g["iters"])) <= 2
    np.testing.assert_allclose(r.x, g["x"], rtol=1e-5, atol=1e-7)
