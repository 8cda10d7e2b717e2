"""The whole ported slice — make_solver → PreparedSolver.solve → solve_refined
on the Neumann-ILU stencil path — against the JAX package's
``make_solver(..., format="stencil")`` (Pallas in interpret mode).

Tolerances: the loops take the same steps in the same order, but
``torch.dot`` and XLA sum the dots in different orders, so trajectories
part at the last bits and the stopping iteration may move.  The parting
grows fast: in f64 the residual histories differ by ~1e-15 relative at the
first step and by ~1e-1 forty iterations on — as much as the JAX solver
differs from itself when one entry of b moves by one ulp (50 vs 46
iterations on lap64 with the right-hand side of seed 1).  The windows are
the ROADMAP's trajectory-parity slack: ±2 iterations in f64, ±15 in f32,
on right-hand sides from seed 0.
"""

import numpy as np
import pytest
import torch

import cuda_mat_tpu as cm
import cuda_mat_tpu.models.problems as jprob

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.models.problems as tprob

torch.set_num_threads(1)

MATRICES = {"grid40x126": (40, 126), "lap64": (64, 64)}


def _solvers(name, dtype, tol, omega):
    r, c = MATRICES[name]
    kw = dict(maxit=2000, tol=tol, dtype=dtype, precond="ilu0_neumann",
              neumann_terms=4, milu_omega=omega)
    ps_j = cm.make_solver(jprob.grid_laplacian(r, c), cm.SolverConfig(**kw),
                          format="stencil")
    ps_t = ct.make_solver(tprob.grid_laplacian(r, c), ct.SolverConfig(**kw),
                          device="cpu")
    b = np.random.default_rng(0).uniform(1.0, 5.0, r * c)
    return ps_j, ps_t, b


@pytest.mark.parametrize("omega", [0.0, 0.96])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_f64_matches_jax(name, omega):
    ps_j, ps_t, b = _solvers(name, "float64", 1e-8, omega)
    assert ps_t.pre.fused == ps_j.pre.fused
    rj, rt = ps_j.solve(b), ps_t.solve(b)
    assert rt.status == rj.status == ct.SolverStatus.CONVERGED
    assert abs(rt.iters - rj.iters) <= 2
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8
    np.testing.assert_allclose(rt.residual_history[:10],
                               rj.residual_history[:10], rtol=1e-10)
    assert rt.residual_true / np.linalg.norm(b) < 1e-7


@pytest.mark.parametrize("omega", [0.0, 0.96])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_f32_iterations_match_jax(name, omega):
    ps_j, ps_t, b = _solvers(name, "float32", 1e-4, omega)
    rj, rt = ps_j.solve(b), ps_t.solve(b)
    assert rt.status == rj.status == ct.SolverStatus.CONVERGED
    assert abs(rt.iters - rj.iters) <= 15
    assert rt.x.dtype == np.float32 and np.isfinite(rt.x).all()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_refined_reaches_1e6(name):
    r, c = MATRICES[name]
    ps_j, ps_t, b = _solvers(name, "float32", 1e-4, 0.96)
    cfg = ct.SolverConfig(maxit=2000, tol=1e-6, dtype="float32",
                          precond="ilu0_neumann", neumann_terms=4,
                          milu_omega=0.96)
    rt = ct.solve_refined(ps_t.a, b, cfg, 1e-4, solver=ps_t)
    rj = cm.solve_refined(ps_j.a, b, cm.SolverConfig(**vars(cfg)), 1e-4,
                          solver=ps_j)
    a = tprob.grid_laplacian(r, c)
    true_rel = (np.linalg.norm(b - a.matvec(rt.x))
                / np.linalg.norm(b - a.matvec(np.ones(a.n))))
    assert rt.status == ct.SolverStatus.CONVERGED
    assert true_rel <= 1e-6
    assert abs(rt.iters - rj.iters) <= 15


def test_unported_configs_raise():
    """``debug=True`` (the in-loop residual print) is the one configuration
    still to port (ROADMAP A10)."""
    a = tprob.grid_laplacian(8, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        ct.make_solver(a, ct.SolverConfig(debug=True), device="cpu")


def _wide(mod, n=64):
    """A diagonal plus an anti-diagonal: 65 distinct diagonals, no band."""
    i = np.arange(n)
    return mod.CSRMatrix.from_coo(mod.COOMatrix(
        n, n, np.concatenate([i, i]), np.concatenate([i, n - 1 - i]),
        np.concatenate([np.full(n, 4.0), np.ones(n)])))


@pytest.mark.parametrize("case", ["reorder rcm", "format ell", "wide"])
def test_once_unported_configs_match_jax(case):
    """The three configurations that raised NotImplementedError before the
    unpadded operators were ported now solve as the JAX package does:
    Neumann-ILU on true-n vectors, f64, status equal, iterations ±2, x to
    1e-8."""
    kw = dict(precond="ilu0_neumann", tol=1e-8)
    fmt = "ell" if case == "format ell" else None
    if case == "reorder rcm":
        kw["reorder"] = "rcm"
    if case == "wide":
        a_j, a_t = _wide(jprob), _wide(tprob)
    else:
        a_j, a_t = jprob.grid_laplacian(8, 16), tprob.grid_laplacian(8, 16)
    b = np.random.default_rng(0).uniform(1.0, 5.0, a_t.n)
    ps = ct.make_solver(a_t, ct.SolverConfig(**kw), format=fmt, device="cpu")
    assert not ps.op.padded
    rt = ps.solve(b)
    rj = cm.make_solver(a_j, cm.SolverConfig(**kw), format=fmt).solve(b)
    assert rt.status == rj.status == ct.SolverStatus.CONVERGED
    assert abs(rt.iters - rj.iters) <= 2
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8


@pytest.mark.parametrize("flag", [{"fuse_blas1": True},
                                  {"fused_dots": True},
                                  {"check_halves": False}])
def test_opt_in_flags_build_and_solve(flag):
    """The loop's opt-in variants, which once raised here, build and solve
    (their parity with the JAX package: test_torch_fusions.py)."""
    a = tprob.grid_laplacian(8, 16)
    cfg = ct.SolverConfig(precond="ilu0_neumann", **flag)
    b = np.random.default_rng(0).uniform(1.0, 5.0, a.n)
    r = ct.make_solver(a, cfg, device="cpu").solve(b)
    assert r.status == ct.SolverStatus.CONVERGED
    assert r.residual_true / np.linalg.norm(b) < 1e-5
