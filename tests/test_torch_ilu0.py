"""The exact-ILU(0) slice — load_mm_sparse_matrix → bicgstab_lu_precond /
make_solver(precond="ilu0") → PreparedSolver.solve → solve_refined — of the
PyTorch port against the JAX package and the checked-in goldens.

The JAX side runs its CPU default (XLA operator + blocked triangular
solver), the port its stencil operator + banded trisolve twins: both are
exact ILU(0) of the same factor, so the windows are tests/test_goldens.py's
for the JAX solver: ±2 iterations (mat900) and ±6 (mat10000) in f64, ±10
and ±15 in f32, and x within rtol 1e-5 of the JAX solution.
"""

import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cuda_mat_tpu as cm
from cuda_mat_tpu.precond import preconditioners as jpre

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.precond import preconditioners as tpre

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's block inverses in ILU(0) setups: with
    the test workers sharing the cores, OpenBLAS's spinning threads slow
    them a hundredfold."""
    with threadpool_limits(1):
        yield


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_SLACK = {"mat900": 2, "mat10000": 6}
F32_SLACK = {"mat900": 10, "mat10000": 15}


def _load(name):
    path = os.path.join(ROOT, "data", f"{name}.mtx")
    return cm.load_mm_sparse_matrix(path), ct.load_mm_sparse_matrix(path)


def _golden(name):
    return np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npz"))


def _cfg(mod, dtype, **kw):
    return mod.SolverConfig(**{"maxit": 2000, "tol": 1e-6, "dtype": dtype,
                               "trisolve_block": 128, **kw})


@pytest.mark.parametrize("name", ["mat900", "mat10000"])
def test_f64_matches_jax_and_golden(name):
    a_j, a_t = _load(name)
    b = np.ones(a_t.n)
    rj = cm.bicgstab_lu_precond(a_j, b, _cfg(cm, "float64"))
    rt = ct.bicgstab_lu_precond(a_t, b, _cfg(ct, "float64"), device="cpu")
    g = int(_golden(f"{name}_ilu")["iters"])
    assert rt.status == ct.SolverStatus.CONVERGED and rj.converged
    assert abs(rt.iters - rj.iters) <= F64_SLACK[name]
    assert abs(rt.iters - g) <= F64_SLACK[name]
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(rt.x, _golden(f"{name}_ilu")["x"], rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["mat900", "mat10000"])
def test_f32_band(name):
    a_j, a_t = _load(name)
    b = np.ones(a_t.n)
    rj = cm.bicgstab_lu_precond(a_j, b, _cfg(cm, "float32"))
    rt = ct.bicgstab_lu_precond(a_t, b, _cfg(ct, "float32"), device="cpu")
    g = int(_golden(f"{name}_ilu")["iters"])
    assert rt.converged and rj.converged
    assert abs(rt.iters - g) <= F32_SLACK[name]
    assert abs(rt.iters - rj.iters) <= F32_SLACK[name]
    assert rt.x.dtype == np.float32
    # the f32 recursive residual drifts from the true one (test_goldens.py)
    assert rt.residual_true / np.linalg.norm(b) < 1e-3


def test_milu_golden_mat900():
    _, a_t = _load("mat900")
    g = _golden("mat900_milu097")
    rt = ct.make_solver(a_t, _cfg(ct, "float64", precond="ilu0",
                                  milu_omega=0.97),
                        device="cpu").solve(np.ones(900))
    assert rt.converged and abs(rt.iters - int(g["iters"])) <= 2
    np.testing.assert_allclose(rt.x, g["x"], rtol=1e-5, atol=1e-7)


def test_refined_through_an_ilu0_solver_reaches_1e6():
    _, a = _load("mat10000")
    b = np.random.default_rng(0).uniform(1.0, 5.0, a.n)
    cfg = _cfg(ct, "float32", precond="ilu0")
    ps = ct.make_solver(a, cfg.replace(tol=1e-4, true_residual=False),
                        device="cpu")
    assert isinstance(ps.pre, tpre.PaddedPreconditioner)
    rr = ct.solve_refined(a, b, cfg, 1e-4, solver=ps)
    true_rel = (np.linalg.norm(b - a.matvec(rr.x))
                / np.linalg.norm(b - a.matvec(np.ones(a.n))))
    assert rr.status == ct.SolverStatus.CONVERGED and true_rel <= 1e-6


def test_ilu0_limits_match_jax():
    """Past the 2 GiB guard on block inverses the JAX package raises
    whatever its engine; the port keeps the guard for its dense route only
    (ROADMAP C13), so this band within the block takes the diagonal form
    and builds no block inverses.  A band wider than the block: mat900
    (bandwidth 31) at block 16 on the port's "levels" route solves as the
    JAX package's blocked solve does (f64, ±2 iterations, x to rtol
    1e-5)."""
    a_t = ct.grid_laplacian(1400, 100)
    with pytest.raises(ValueError, match="GiB of block inverses"):
        jpre.ILU0Preconditioner.from_csr(a_t, block=1024)
    assert tpre.ILU0Preconditioner.from_csr(
        a_t, block=1024, device="cpu").route == "diag"
    j900, mat900 = _load("mat900")
    ps = ct.make_solver(mat900, _cfg(ct, "float64", precond="ilu0",
                                     trisolve_block=16), device="cpu")
    assert ps.pre.inner.route == "levels"
    rt = ps.solve(np.ones(mat900.n))
    rj = cm.solve(j900, np.ones(mat900.n), _cfg(cm, "float64",
                                                precond="ilu0",
                                                trisolve_block=16))
    assert rt.converged and rj.converged and abs(rt.iters - rj.iters) <= 2
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-5)


def test_dense_route_keeps_the_jax_guard(monkeypatch):
    """The dense route (a band within the block, more than
    DIAG_MAX_OFFSETS offsets a triangle) past 2 GiB of block inverses
    raises the JAX package's error word for word, before it factorizes:
    HPCG's 27-point 30 x 30 x 156 grid (bandwidth 931, 13 offsets a
    triangle) at block 1024 would take 2 * 138 * 1024^2 * 8 bytes in f64
    (ROADMAP C13)."""
    from cuda_mat_tpu.formats.csr import CSRMatrix as JCSRMatrix
    from cuda_mat_tpu_torch.formats.reorder import bandwidth
    from cuda_mat_tpu_torch.models.problems import hpcg27
    from cuda_mat_tpu_torch.ops.banded_trisolve import diag_route_fits

    a = hpcg27(30, 30, 156)
    assert bandwidth(a) == 931 and not diag_route_fits(a, 1024)

    def no_factorization(*args, **kwargs):
        raise AssertionError("factorized before the guard")

    monkeypatch.setattr(tpre, "_factorize", no_factorization)
    with pytest.raises(ValueError) as e_j:
        jpre.ILU0Preconditioner.from_csr(
            JCSRMatrix(a.n, a.m, a.data, a.indices, a.indptr), block=1024)
    with pytest.raises(ValueError) as e_t:
        tpre.ILU0Preconditioner.from_csr(a, block=1024, device="cpu")
    assert str(e_t.value) == str(e_j.value)
    assert "2.2 GiB of block inverses (n=140400, block=1024)" in \
        str(e_t.value)
