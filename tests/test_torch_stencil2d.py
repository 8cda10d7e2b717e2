"""Kernel B7's twin and ``StencilOperator2D`` in the PyTorch port against
the JAX package's 2-D tile stencil (Pallas in interpret mode), on the
shapes of test_pallas_stencil.py, and the operator in place of a matrix in
``solve``.

Tolerances: on the Laplacian every product (by 4 or −1) is exact, so an FMA
that XLA's CPU compile may form rounds as the twin's product and sum do,
and y is compared bitwise; with random variable coefficients the products
round, so to 1e-15 of max|y|.  Whole f64 solves part at the last bits
between the packages' dot orders: ±2 iterations and x within 1e-8 on these
inputs; the mat10000 grid lands on the golden ``mat10000_hform`` (115)
within the goldens' h-form slack of 6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_mat_tpu as cm
from cuda_mat_tpu.ops import pallas_stencil as jst

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.models.problems as tprob
from cuda_mat_tpu_torch.convert import stencil2d_operator_from_numpy
from cuda_mat_tpu_torch.ops import stencil2d as t2d
from cuda_mat_tpu_torch.precond.preconditioners import IdentityPreconditioner

torch.set_num_threads(1)

SHAPES = [(30, 30, 16, 16), (32, 32, 16, 16), (20, 50, 8, 32)]


def _ops(r, c, tr, tc, constant):
    op_j = jst.StencilOperator2D.laplacian(r, c, dtype=jnp.float64, tr=tr,
                                           tc=tc, constant=constant,
                                           interpret=True)
    op_t = t2d.StencilOperator2D.laplacian(r, c, dtype=torch.float64, tr=tr,
                                           tc=tc, constant=constant,
                                           device="cpu")
    return op_j, op_t


@pytest.mark.parametrize("constant", [True, False])
@pytest.mark.parametrize("r,c,tr,tc", SHAPES)
def test_twin_matches_pallas(r, c, tr, tc, constant):
    op_j, op_t = _ops(r, c, tr, tc, constant)
    assert (op_t.rp, op_t.cp) == (op_j.rp, op_j.cp)
    x = np.random.default_rng(0).standard_normal(r * c)
    xp_t = op_t.pad_vec(x)
    assert np.array_equal(xp_t.numpy(), np.asarray(op_j.pad_vec(x)))
    y_t = op_t.matvec(xp_t)
    y_j = np.asarray(op_j.matvec(op_j.pad_vec(x)))
    assert np.array_equal(y_t.numpy(), y_j)
    np.testing.assert_allclose(op_t.unpad_vec(y_t).numpy(),
                               tprob.grid_laplacian(r, c).matvec(x),
                               rtol=1e-12, atol=1e-12)
    # the padding is a fixed point: every cell off the true grid is 0
    g = y_t.view(op_t.rp + 2 * tr, op_t.cp + 2 * tc).clone()
    g[tr:tr + r, tc:tc + c] = 0
    assert not g.any()


@pytest.mark.parametrize("r,c,tr,tc", SHAPES)
def test_twin_matches_pallas_random_coefficients(r, c, tr, tc):
    """A 9-point stencil, four terms scalar and five variable grids of
    random values: the mask past (r, c) and the grid order both count."""
    rng = np.random.default_rng(1)
    rp, cp = -(-r // tr) * tr, -(-c // tc) * tc
    offsets = tuple((dr, dc, None if (dr + dc) % 2 == 0
                     else float(rng.uniform(-2, 2)))
                    for dr in (-1, 0, 1) for dc in (-1, 0, 1))
    n_var = sum(o[2] is None for o in offsets)
    grids = rng.standard_normal((n_var, rp, cp))
    x = rng.standard_normal((rp + 2 * tr) * (cp + 2 * tc))
    y_j = np.asarray(jst.stencil_spmv_padded(
        tuple(jnp.asarray(g) for g in grids), jnp.asarray(x), offsets, tr, tc,
        rp, cp, r, c, interpret=True))
    y_t = t2d.stencil_spmv_padded(torch.from_numpy(grids),
                                  torch.from_numpy(x), offsets, tr, tc, rp,
                                  cp, r, c).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=0,
                               atol=1e-15 * np.abs(y_j).max())
    assert np.array_equal(y_t == 0, y_j == 0)


def test_front_end_checks_its_arguments():
    op = t2d.StencilOperator2D.laplacian(20, 50, torch.float64, tr=8, tc=32,
                                         device="cpu")
    x = op.pad_vec(np.ones(op.n))
    with pytest.raises(ValueError, match="length"):
        op.matvec(x[:-1])
    with pytest.raises(ValueError, match="within one tile"):
        t2d.stencil_spmv_padded(op.coeffs, x, ((9, 0, 1.0),), 8, 32, op.rp,
                                op.cp, op.r, op.c)
    with pytest.raises(ValueError, match="coeffs"):
        t2d.stencil_spmv_padded(op.coeffs, x, ((0, 0, None),), 8, 32, op.rp,
                                op.cp, op.r, op.c)


CFG = dict(maxit=2000, tol=1e-8, dtype="float64")


@pytest.mark.parametrize("precond", ["none", "ilu0_neumann"])
@pytest.mark.parametrize("constant", [True, False])
def test_solve_takes_the_operator_as_jax_does(constant, precond):
    """``solve(op, b)`` with a device operator: the h-form loop for
    precond "none", and for any other precond the preconditioned loop with
    the identity (the JAX package's _build_setup, ROADMAP C7)."""
    op_j, op_t = _ops(30, 30, 16, 16, constant)
    cfg = dict(CFG, precond=precond)
    b = np.random.default_rng(0).uniform(1.0, 5.0, 900)
    ps = ct.make_solver(op_t, ct.SolverConfig(**cfg), device="cpu")
    assert ps.op is op_t
    assert (ps.pre is None) == (precond == "none")
    if precond != "none":
        assert isinstance(ps.pre, IdentityPreconditioner)
    rt = ps.solve(b)
    rj = cm.solve(op_j, b, cm.SolverConfig(**cfg))
    assert rt.status == rj.status == ct.SolverStatus.CONVERGED
    assert abs(rt.iters - rj.iters) <= 2
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8
    assert rt.residual_true is None
    rel = np.linalg.norm(b - tprob.grid_laplacian(30, 30).matvec(rt.x))
    assert rel / np.linalg.norm(b) < 1e-7


@pytest.mark.parametrize("constant", [True, False])
def test_mat10000_grid_lands_on_the_golden(constant):
    """data/mat10000.mtx is grid_laplacian(100, 100); its h-form golden is
    115 iterations (tests/goldens, slack 6)."""
    op = ct.StencilOperator2D.laplacian(100, 100, torch.float64, tr=32,
                                        tc=128, constant=constant,
                                        device="cpu")
    r = ct.solve(op, np.ones(op.n), ct.SolverConfig(tol=1e-6), device="cpu")
    assert r.status == ct.SolverStatus.CONVERGED
    assert abs(r.iters - 115) <= 6


def test_operator_on_another_device_is_refused():
    op = ct.StencilOperator2D.laplacian(20, 50, torch.float64, tr=8, tc=32,
                                        device="cpu")
    with pytest.raises(ValueError, match="lives on cpu"):
        ct.make_solver(op, ct.SolverConfig(), device="meta")
    with pytest.raises(TypeError, match="padded device operator"):
        ct.make_solver(np.eye(3), ct.SolverConfig(), device="cpu")


@pytest.mark.parametrize("constant", [True, False])
def test_carried_operator_matches(constant):
    op_j, _ = _ops(20, 50, 8, 32, constant)
    op_t = stencil2d_operator_from_numpy(dict(
        coeffs=tuple(np.asarray(g) for g in op_j.coeffs),
        offsets=op_j.offsets, r=op_j.r, c=op_j.c, rp=op_j.rp, cp=op_j.cp,
        tr=op_j.tr, tc=op_j.tc, vec_dtype=op_j.vec_dtype), "cpu")
    assert op_t.vec_dtype == torch.float64 and op_t.offsets == op_j.offsets
    x = np.random.default_rng(4).standard_normal(op_t.n)
    assert np.array_equal(op_t.matvec(op_t.pad_vec(x)).numpy(),
                          np.asarray(op_j.matvec(op_j.pad_vec(x))))
