"""The reference's plain and split entry points — ``bicgstab`` (the h-form
loop) and ``bicgstab_split`` — and Jacobi and exact ILU(0) on the banded
DIA operator, on the port's CPU path, against the checked-in goldens
(``tests/goldens/*.npz``, the reference's f64 trajectories) and the JAX
package.

Tolerances are the goldens' (``tests/test_goldens.py``): the demo system
mat3 exactly (3 iterations, x = [7/6, 17/3, −23/6] to 1e-9), h-form and
split within ±6 iterations, ILU(0) within ±2; the port against the JAX
package within ±2 iterations in f64 (the trajectories part at the last
bits, as in ``tests/test_torch_solver.py``).
"""

import os

import numpy as np
import pytest
import torch

import cuda_mat_tpu as cm
from cuda_mat_tpu.precond import preconditioners as jpre

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.ops import dia_spmv as tds
from cuda_mat_tpu_torch.ops import stencil as tst
from cuda_mat_tpu_torch.precond import preconditioners as tpre

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
GOLDENS = os.path.join(REPO, "tests", "goldens")
DEMO_X = [7 / 6, 17 / 3, -23 / 6]


def _golden(name):
    return np.load(os.path.join(GOLDENS, f"{name}.npz"))


def _load(name):
    return ct.load_mm_sparse_matrix(os.path.join(DATA, f"{name}.mtx"))


def _vec(name):
    return ct.to_dense_vector(_load(name))


def _op_kind(a, fmt):
    from cuda_mat_tpu_torch.solvers.bicgstab import _as_op

    return type(_as_op(a, torch.float64, torch.device("cpu"), fmt))


def test_mat3_demo():
    """mat3 is banded (offsets −2..2) and no stencil: the DIA operator."""
    a, b = _load("mat3"), _vec("vec3")
    assert _op_kind(a, None) is tds.PallasDIAOperator
    g = _golden("mat3_hform")
    r = ct.bicgstab(a, b, ct.SolverConfig(maxit=200, tol=1e-5), device="cpu")
    assert r.converged and r.iters == int(g["iters"]) == 3
    np.testing.assert_allclose(r.x, g["x"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(r.x, DEMO_X, rtol=1e-9)
    assert r.residual_true < 1e-10
    assert r.residual_history.shape == (200,)


def test_mat3_split_demo():
    a0, d, b = _load("mat3_A0"), _vec("vec3_d"), _vec("vec3")
    assert _op_kind(a0, None) is tds.PallasDIAOperator
    g = _golden("mat3_split")
    r = ct.bicgstab_split(a0, d, np.ones(3), b,
                          ct.SolverConfig(maxit=2000, tol=1e-5), device="cpu")
    assert r.converged and r.iters == int(g["iters"]) == 3
    np.testing.assert_allclose(r.x, DEMO_X, rtol=1e-9)
    assert r.residual_true < 1e-10


@pytest.mark.parametrize("fmt", [None, "pallas_dia"])
@pytest.mark.parametrize("name", ["mat900", "mat10000"])
def test_hform_goldens(name, fmt):
    a = _load(name)
    want = tds.PallasDIAOperator if fmt else tst.ConstStencilOperator
    assert _op_kind(a, fmt) is want
    g = _golden(f"{name}_hform")
    r = ct.bicgstab(a, np.ones(a.n), ct.SolverConfig(), format=fmt,
                    device="cpu")
    assert r.converged and abs(r.iters - int(g["iters"])) <= 6
    assert np.linalg.norm(r.x - g["x"]) / np.linalg.norm(g["x"]) < 1e-4
    assert r.residual_true / np.sqrt(a.n) < 1e-4


def test_mat10000_split_golden():
    """split_form of mat10000: A0 is a constant stencil too (B1)."""
    a = _load("mat10000")
    a0, d = ct.split_form(a)
    assert _op_kind(a0, None) is tst.ConstStencilOperator
    np.testing.assert_array_equal(d, a.diagonal())
    g = _golden("mat10000_split")
    r = ct.bicgstab_split(a0, d, np.ones(a.n), np.ones(a.n),
                          ct.SolverConfig(), device="cpu")
    assert r.converged and abs(r.iters - int(g["iters"])) <= 6
    assert r.residual_true / np.sqrt(a.n) < 1e-4


def test_split_form_matches_jax():
    import cuda_mat_tpu.models.problems as jprob

    a = _load("mat900")
    a0, d = ct.split_form(a)
    j0, jd = jprob.split_form(cm.load_mm_sparse_matrix(
        os.path.join(DATA, "mat900.mtx")))
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(a0.indptr, j0.indptr)
    np.testing.assert_array_equal(a0.indices, j0.indices)
    np.testing.assert_array_equal(a0.data, j0.data)


def test_jacobi_matches_jax():
    """Right-hand side of seed 2.  The f64 trajectories part at the last
    bits from the first step (1e-15 relative) and by 1e-10 some 17
    iterations on; with seeds 0 and 1 the stopping iteration then moves by
    up to 4 (45 vs 41, 42 vs 40), as much as between the JAX package's own
    stencil and DIA operators."""
    a = _load("mat900")
    b = np.random.default_rng(2).uniform(1.0, 5.0, a.n)
    kw = dict(maxit=2000, tol=1e-6, precond="jacobi")
    rj = cm.solve(cm.load_mm_sparse_matrix(os.path.join(DATA, "mat900.mtx")),
                  b, cm.SolverConfig(**kw), format="pallas_dia")
    ps = ct.make_solver(a, ct.SolverConfig(**kw), format="pallas_dia",
                        device="cpu")
    assert isinstance(ps.pre, tpre.JacobiPreconditioner)
    rt = ps.solve(b)
    assert rt.converged and rj.converged
    assert abs(rt.iters - rj.iters) <= 2
    np.testing.assert_allclose(rt.residual_history[:20],
                               rj.residual_history[:20], rtol=1e-10)
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) < 1e-6


def test_ilu0_on_the_dia_operator():
    """B3 for A, the banded trisolve (B4a) through the pad adapter."""
    a = _load("mat900")
    cfg = ct.SolverConfig(maxit=2000, tol=1e-6, precond="ilu0",
                          trisolve_block=64)
    ps = ct.make_solver(a, cfg, format="pallas_dia", device="cpu")
    assert isinstance(ps.op, tds.PallasDIAOperator)
    assert isinstance(ps.pre, tpre.PaddedPreconditioner)
    r = ps.solve(np.ones(a.n))
    assert r.converged and abs(r.iters - int(_golden("mat900_ilu")["iters"])) <= 2


def test_make_preconditioner():
    a = _load("mat900")
    f = torch.from_numpy(np.random.default_rng(0).standard_normal(a.n))
    ident = tpre.make_preconditioner("none", a, device="cpu")
    assert torch.equal(ident.msolve(f), f)
    jac = tpre.make_preconditioner("jacobi", a, device="cpu")
    np.testing.assert_array_equal(jac.msolve(f).numpy(),
                                  f.numpy() / a.diagonal())
    ilu = tpre.make_preconditioner("ilu0", a, block=64, device="cpu")
    assert isinstance(ilu, tpre.ILU0Preconditioner)
    # the Neumann series on true-n vectors, its factors unpadded operators,
    # against the JAX package's on the same matrix (f64, 1e-13 of max|y|)
    neu = tpre.make_preconditioner("ilu0_neumann", a, device="cpu")
    assert isinstance(neu, tpre.NeumannILUPreconditioner)
    assert neu.fused is False and not neu.nl.padded
    neu_j = jpre.make_preconditioner(
        "ilu0_neumann", cm.load_mm_sparse_matrix(os.path.join(DATA,
                                                              "mat900.mtx")))
    y_j = np.asarray(neu_j.msolve(f.numpy()))
    assert np.abs(neu.msolve(f).numpy() - y_j).max() <= \
        1e-13 * np.abs(y_j).max()
    with pytest.raises(ValueError, match="unknown"):
        tpre.make_preconditioner("ssor", a, device="cpu")


def test_hform_breakdown_and_maxit():
    """A zero right-hand side from a zero start: 0/0 makes omega NaN in the
    first iteration, which the breakdown guard reports; a short maxit
    reports MAXIT."""
    a = _load("mat900")
    r = ct.bicgstab(a, np.zeros(a.n), ct.SolverConfig(), x0=np.zeros(a.n),
                    device="cpu")
    assert r.status == ct.SolverStatus.BREAKDOWN and r.iters == 1
    r = ct.bicgstab(a, np.ones(a.n), ct.SolverConfig(maxit=5), device="cpu")
    assert r.status == ct.SolverStatus.MAXIT and r.iters == 5
