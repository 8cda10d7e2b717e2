"""State carried across: the JAX package's prepared operator and
preconditioner, rebuilt in the port by ``cuda_mat_tpu_torch.convert``.

Fed the same factors, the port's matvec equals the JAX Pallas kernel
(interpret mode) bitwise and its msolve agrees to 1e-14 of max|y| (the
reason is in test_torch_msolve.py: XLA contracts the interpret-mode body
into FMAs), and the solver loop can be compared apart from the
factorization.
"""

import numpy as np
import pytest
import torch

import cuda_mat_tpu as cm
import cuda_mat_tpu.models.problems as jprob

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.convert import (operator_from_numpy,
                                        preconditioner_from_numpy)
from cuda_mat_tpu_torch.solvers.bicgstab import PreparedSolver

torch.set_num_threads(1)

# (grid rows, cols, k, omega): "kernel" mode twice, the sequential series
# (C=126 leaves too narrow a gap for k=4) once
CASES = [(64, 64, 4, 0.96), (24, 126, 3, 0.0), (40, 126, 4, 0.96)]


def _carry(ps_j):
    op, pre = ps_j.op, ps_j.pre
    op_fields = {f: getattr(op, f) for f in (
        "terms", "strided_terms", "c_grid", "stride", "n", "np_true", "npad",
        "block", "sub", "vec_dtype")}
    op_fields["gapmask"] = np.asarray(op.gapmask)
    pre_fields = dict(
        inv_d=np.asarray(pre.inv_d),
        gap_ext=None if pre.gap_ext is None else np.asarray(pre.gap_ext),
        nl_terms=pre.nl.terms, nl_strided_terms=pre.nl.strided_terms,
        nu_terms=pre.nu.terms, nu_strided_terms=pre.nu.strided_terms,
        terms=pre.terms, fused=pre.fused)
    op_t = operator_from_numpy(op_fields, "cpu")
    return op_t, preconditioner_from_numpy(pre_fields, op_t, "cpu")


def _jax_solver(r, c, k, omega):
    cfg = dict(maxit=2000, tol=1e-8, dtype="float64", precond="ilu0_neumann",
               neumann_terms=k, milu_omega=omega)
    return cm.make_solver(jprob.grid_laplacian(r, c), cm.SolverConfig(**cfg),
                          format="stencil"), cfg


@pytest.mark.parametrize("r,c,k,omega", CASES)
def test_carried_state_matches_bitwise(r, c, k, omega):
    ps_j, _ = _jax_solver(r, c, k, omega)
    op_t, pre_t = _carry(ps_j)
    assert pre_t.fused == ps_j.pre.fused
    x = np.random.default_rng(9).standard_normal(r * c)
    xp_j, xp_t = ps_j.op.pad_vec(x), op_t.pad_vec(x)
    assert np.array_equal(np.asarray(xp_j), xp_t.numpy())
    assert np.array_equal(np.asarray(ps_j.op.matvec(xp_j)),
                          op_t.matvec(xp_t).numpy())
    y_j = np.asarray(ps_j.pre.msolve(xp_j))
    y_t = pre_t.msolve(xp_t).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=0,
                               atol=1e-14 * np.abs(y_j).max())
    assert np.array_equal(y_t == 0, y_j == 0)


@pytest.mark.parametrize("r,c,k,omega", CASES[:2])
def test_loop_parity_on_carried_state(r, c, k, omega):
    """The same operator and factors in both packages: the loops alone
    differ, by the order torch.dot and XLA sum in (see
    test_torch_solver.py for the slack)."""
    ps_j, cfg = _jax_solver(r, c, k, omega)
    op_t, pre_t = _carry(ps_j)
    ps_t = PreparedSolver(ct.grid_laplacian(r, c), op_t, pre_t,
                          ct.SolverConfig(**cfg), 0.0)
    b = np.random.default_rng(0).uniform(1.0, 5.0, r * c)
    rj, rt = ps_j.solve(b), ps_t.solve(b)
    assert rt.status == rj.status == ct.SolverStatus.CONVERGED
    assert abs(rt.iters - rj.iters) <= 2
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8
    np.testing.assert_allclose(rt.residual_history[:10],
                               rj.residual_history[:10], rtol=1e-10)
