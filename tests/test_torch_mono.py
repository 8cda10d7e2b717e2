"""The Neumann-ILU preconditioner's "mono" mode in the PyTorch port against
the JAX package: ``from_csr(prefer_mono=True)`` composes the whole M⁻¹ ≈
P_u·d*·P_l into one stencil, applied by one launch of kernel B1.

Tolerances: the composed coefficients come from factor values that two
builds of the native factorizer give to ~1e-15 (test_torch_msolve.py), so
they are compared to 1e-13 relative; the msolve to 1e-12 of max|y| (the
products of general coefficients round, and XLA's CPU compile contracts
the interpret-mode body into FMAs).  Whole f64 solves: ±2 iterations and x
within 1e-8 on the right-hand side of seed 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cuda_mat_tpu as cm
import cuda_mat_tpu.models.problems as jprob
from cuda_mat_tpu.ops import pallas_stencil as jst
from cuda_mat_tpu.precond import preconditioners as jpre

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.models.problems as tprob
from cuda_mat_tpu_torch.convert import (operator_from_numpy,
                                        preconditioner_from_numpy)
from cuda_mat_tpu_torch.ops import _kernels
from cuda_mat_tpu_torch.ops import stencil as tst
from cuda_mat_tpu_torch.precond import preconditioners as tpre
from cuda_mat_tpu_torch.solvers.bicgstab import PreparedSolver

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread while the factors are built: the test workers share
    the cores."""
    with threadpool_limits(1):
        yield


def _mono(r, c, k, omega=0.96):
    a_j, a_t = jprob.grid_laplacian(r, c), tprob.grid_laplacian(r, c)
    dia = a_j.to_dia(max_diags=16)
    op0 = jst.ConstStencilOperator.from_dia(dia, dtype=jnp.float64,
                                            interpret=True)
    plan = jst.plan_const_neumann_layout(op0.terms, k, op0.c_grid, op0.stride,
                                         prefer_mono=True)
    assert plan == tst.plan_const_neumann_layout(
        op0.terms, k, op0.c_grid, op0.stride, prefer_mono=True)
    kw = dict(min_sub=plan[0], block_target=plan[1])
    op_j = jst.ConstStencilOperator.from_dia(dia, dtype=jnp.float64,
                                             interpret=True, **kw)
    op_t = tst.ConstStencilOperator.from_dia(a_t.to_dia(max_diags=16),
                                             dtype=torch.float64, **kw)
    pre_j = jpre.NeumannILUPreconditioner.from_csr(
        a_j, dtype=jnp.float64, terms=k, pad_like=op_j, prefer_mono=True,
        milu_omega=omega)
    pre_t = tpre.NeumannILUPreconditioner.from_csr(
        a_t, terms=k, pad_like=op_t, prefer_mono=True, milu_omega=omega)
    return a_j, a_t, op_j, op_t, pre_j, pre_t


@pytest.mark.parametrize("r,c,k", [(100, 100, 4), (24, 126, 3), (40, 12, 4),
                                   (30, 30, 5)])
def test_mono_terms_and_msolve_match_jax(r, c, k):
    _, _, op_j, op_t, pre_j, pre_t = _mono(r, c, k)
    assert pre_j.fused == pre_t.fused == "mono"
    assert pre_t.nu is None and pre_t.inv_d.numel() == 0
    assert len(pre_t.nl.terms) <= _kernels.MAX_TERMS
    assert [t[:2] for t in pre_t.nl.terms] == [t[:2] for t in pre_j.nl.terms]
    assert [t[0] for t in pre_t.nl.strided_terms] == \
        [t[0] for t in pre_j.nl.strided_terms]
    np.testing.assert_allclose([t[2] for t in pre_t.nl.terms],
                               [t[2] for t in pre_j.nl.terms], rtol=1e-13)
    x = np.random.default_rng(6).standard_normal(op_t.n)
    y_j = np.asarray(pre_j.msolve(op_j.pad_vec(x)))
    y_t = pre_t.msolve(op_t.pad_vec(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=0,
                               atol=1e-12 * np.abs(y_j).max())
    assert np.array_equal(y_t == 0, y_j == 0)


def test_mono_past_kernel_b1_takes_the_kernel_mode():
    """k=6 composes 91 terms: the JAX package's interpret-mode fit takes
    them, kernel B1 takes at most 64, so the port falls back to its next
    mode, the one-launch fused msolve (B2)."""
    *_, pre_j, pre_t = _mono(30, 30, 6)
    assert pre_j.fused == "mono" and len(pre_j.nl.terms) > _kernels.MAX_TERMS
    assert pre_t.fused == "kernel"


def test_carried_mono_state_matches_jax():
    _, _, op_j, _, pre_j, _ = _mono(40, 12, 4)
    fields = {f: getattr(op_j, f) for f in (
        "terms", "strided_terms", "c_grid", "stride", "n", "np_true", "npad",
        "block", "sub", "vec_dtype")}
    fields["gapmask"] = np.asarray(op_j.gapmask)
    op_t = operator_from_numpy(fields, "cpu")
    pre_t = preconditioner_from_numpy(dict(
        inv_d=np.asarray(pre_j.inv_d), gap_ext=None, nl_terms=pre_j.nl.terms,
        nl_strided_terms=pre_j.nl.strided_terms, nu_terms=None,
        nu_strided_terms=None, terms=4, fused="mono"), op_t, "cpu")
    assert pre_t.fused == "mono" and pre_t.nu is None and not pre_t.fma_fits
    x = np.random.default_rng(7).standard_normal(op_t.n)
    y_j = np.asarray(pre_j.msolve(op_j.pad_vec(x)))
    y_t = pre_t.msolve(op_t.pad_vec(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=0,
                               atol=1e-12 * np.abs(y_j).max())


def test_mono_solve_matches_jax():
    a_j, a_t, op_j, op_t, pre_j, pre_t = _mono(40, 12, 4)
    cfg = dict(maxit=2000, tol=1e-8, dtype="float64", precond="ilu0_neumann",
               neumann_terms=4, milu_omega=0.96)
    ps_j = cm.PreparedSolver(a_j, op_j, pre_j, True, jnp.float64,
                             cm.SolverConfig(**cfg), 0.0)
    ps_t = PreparedSolver(a_t, op_t, pre_t, ct.SolverConfig(**cfg), 0.0)
    b = np.random.default_rng(0).uniform(1.0, 5.0, a_t.n)
    rj, rt = ps_j.solve(b), ps_t.solve(b)
    assert rt.status == rj.status == ct.SolverStatus.CONVERGED
    assert abs(rt.iters - rj.iters) <= 2
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8
    assert rt.residual_true / np.linalg.norm(b) < 1e-7
