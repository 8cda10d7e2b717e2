"""The slice as a whole: a matrix that is not banded through the port's
``solve`` / ``make_solver`` → ``PreparedSolver.solve`` → ``solve_refined``
on the unpadded operators, against the JAX package on the same input.

The system is the CLI's random one at n = 128 (``random_diag_nonzero_system
(128, 0.95, seed=21)``) made diagonally dominant (+100·I), as
``tests/test_bicgstab.py`` builds it, solved in f64 to 1e-8 with each
preconditioner in each forced format.  Tolerances: the same status,
iterations within ±2 (±6 for the unpreconditioned h-form, whose
trajectories part faster between summation orders), x within 1e-8
(relative).  The raw system (no +100·I) breaks down on both packages, the
reference's own behaviour (BASELINE.md:50); where is a matter of summation
order, so only the status is compared.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cuda_mat_tpu as cm
import cuda_mat_tpu.models.problems as jprob
from cuda_mat_tpu.formats.csr import CSRMatrix as JCSRMatrix

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.models.problems as tprob
from cuda_mat_tpu_torch.ops import operators as tops
from cuda_mat_tpu_torch.ops.level_trisolve import LevelTriSolver
from cuda_mat_tpu_torch.precond import preconditioners as tpre

torch.set_num_threads(1)

FORMATS = ("ell", "csr", "dia", "bell", "dense")
OPERATORS = {"ell": tops.ELLOperator, "csr": tops.CSROperator,
             "dia": tops.DIAOperator, "bell": tops.BELLOperator,
             "dense": tops.DenseOperator}
PRECONDS = ("none", "jacobi", "ilu0", "ilu0_neumann")


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    with threadpool_limits(1):
        yield


def _system():
    a0, b = jprob.random_diag_nonzero_system(128, prob_of_zero=0.95, seed=21)
    a = JCSRMatrix.from_dense(a0.to_dense() + 100.0 * np.eye(128))
    return a, ct.CSRMatrix(a.n, a.m, a.data, a.indices, a.indptr), b


def _cfg(mod, precond, **kw):
    return mod.SolverConfig(**{"maxit": 2000, "tol": 1e-8,
                               "precond": precond, "trisolve_block": 32,
                               **kw})


@pytest.mark.parametrize("precond", PRECONDS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_solve_matches_jax(fmt, precond):
    a_j, a_t, b = _system()
    rj = cm.solve(a_j, b, _cfg(cm, precond), format=fmt)
    ps = ct.make_solver(a_t, _cfg(ct, precond), format=fmt, device="cpu")
    assert type(ps.op) is OPERATORS[fmt]
    if precond == "ilu0":
        assert isinstance(ps.pre.tri, LevelTriSolver)  # band 127 > 32
    rt = ps.solve(b)
    assert rt.status == rj.status == ct.SolverStatus.CONVERGED
    assert abs(rt.iters - rj.iters) <= (6 if precond == "none" else 2)
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8
    assert rt.residual_true / rt.residual0 <= 1e-7


def test_default_format_is_ell_and_matches_jax():
    a_j, a_t, b = _system()
    ps = ct.make_solver(a_t, _cfg(ct, "ilu0_neumann"), device="cpu")
    ps_j = cm.make_solver(a_j, _cfg(cm, "ilu0_neumann"))
    assert isinstance(ps.op, tops.ELLOperator)
    for f in ("op", "pre.nl", "pre.nu"):
        ot, oj = ps, ps_j
        for k in f.split("."):
            ot, oj = getattr(ot, k), getattr(oj, k)
        assert type(ot).__name__ == type(oj).__name__
        assert ot.vec_dtype == torch.float64
    rj = ps_j.solve(b)
    rt = ps.solve(b)
    assert rt.status == rj.status and abs(rt.iters - rj.iters) <= 2
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8


@pytest.mark.parametrize("precond", ["ilu0", "ilu0_neumann"])
def test_refined_through_an_unpadded_solver(precond):
    """f32 inner solves on the ELL operator, refined in f64 to 1e-10."""
    a_j, a_t, b = _system()
    cfg = _cfg(ct, precond, dtype="float32", tol=1e-10)
    ps = ct.make_solver(a_t, cfg.replace(tol=1e-4, true_residual=False),
                        device="cpu")
    assert not tops.is_padded(ps.op) and ps.op.vec_dtype == torch.float32
    rt = ct.solve_refined(a_t, b, cfg, 1e-4, solver=ps)
    rj = cm.solve_refined(a_j, b, cm.SolverConfig(**vars(cfg)), 1e-4)
    assert rt.status == rj.status == ct.SolverStatus.CONVERGED
    true_rel = np.linalg.norm(b - a_t.matvec(rt.x)) / np.linalg.norm(
        b - a_t.matvec(np.ones(a_t.n)))
    assert true_rel <= 1e-10
    assert abs(rt.iters - rj.iters) <= 15


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_raw_random_system_breaks_down_on_both(dtype):
    a_j, b = jprob.random_diag_nonzero_system(1000, 0.99, seed=0)
    a_t, b_t = tprob.random_diag_nonzero_system(1000, 0.99, seed=0)
    np.testing.assert_array_equal(b_t, b)
    cfg = dict(maxit=2000, tol=1e-4 if dtype == "float32" else 1e-6,
               dtype=dtype)
    rj = cm.solve(a_j, np.ones(a_j.n), cm.SolverConfig(**cfg))
    rt = ct.solve(a_t, np.ones(a_t.n), ct.SolverConfig(**cfg), device="cpu")
    assert rj.status == rt.status == ct.SolverStatus.BREAKDOWN


def test_split_form_on_an_unpadded_a0():
    a_j, a_t, b = _system()
    a0_j, d = jprob.split_form(a_j)
    a0_t, d_t = tprob.split_form(a_t)
    np.testing.assert_array_equal(d_t, d)
    x0 = np.ones(a_t.n)
    cfg = dict(maxit=2000, tol=1e-8)
    rj = cm.bicgstab_split(a0_j, d, x0, b, cm.SolverConfig(**cfg),
                           format="csr")
    rt = ct.bicgstab_split(a0_t, d_t, x0, b, ct.SolverConfig(**cfg),
                           format="csr", device="cpu")
    assert rt.status == rj.status == ct.SolverStatus.CONVERGED
    assert abs(rt.iters - rj.iters) <= 6
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8


def test_an_unpadded_operator_in_place_of_the_matrix():
    """Taken as a device operator, as the JAX package takes one: any
    preconditioner runs M = I (ROADMAP C7), no true residual."""
    a_j, a_t, b = _system()
    op = tops.make_operator(a_t, format="csr", device="cpu")
    r = ct.solve(op, b, _cfg(ct, "jacobi"), device="cpu")
    rn = ct.solve(a_t, b, _cfg(ct, "none"), format="csr", device="cpu")
    ps = ct.make_solver(op, _cfg(ct, "jacobi"), device="cpu")
    assert ps.op is op and isinstance(ps.pre, tpre.IdentityPreconditioner)
    assert r.converged and r.residual_true is None
    assert abs(r.iters - cm.solve(a_j, b, _cfg(cm, "none"),
                                  format="csr").iters) <= 6
    assert rn.converged
