"""Two places where the port and the JAX package part, recorded on the CPU
(ROADMAP Queue C).  Neither is a fault of the loop: both packages run the
same update order.

C10, ``maxit = 0``: on ``laplacian_2d(10)`` every JAX entry point raises
(IndexError from its ``(maxit,)`` history; ``bicgstab_lu_precond``
TypeError from ``dynamic_update_slice``); the port returns MAXIT after 0
iterations with the residual it started from — the initial norm ``|r0|``
in the BiCGSTAB loops and refinement, the initial relative residual
``|r0|/|b|`` in ``bicg``, whose check is relative.  Its x is the loop's
carry: x0 in the preconditioned loop and ``bicg``, zeros in the h-form,
whose carry starts at zero in both packages (the JAX hform_core's ``init``)
and becomes x0 + αp̂ + ωs in the first step.

C9, Jacobi on a random system: ``random_diag_nonzero_system(300, 0.9,
seed=1)``, ELL, f64, tol 1e-6, as numbered and under 3 symmetric
renumberings P·A·Pᵀ (the permutations of ``np.random.default_rng(seed)``).
The JAX package runs to MAXIT at 2000 every time; the port reports
BREAKDOWN well before, every time.  Neither converges: ρ = ⟨r̂, r⟩ decays
to ~1e-12 (a Lanczos breakdown), and torch's CPU f64 dot lands on an exact
0 of it, so the next β is NaN, which the loop reports.  The port's own loop
with ``np.dot`` in place of ``torch.dot`` runs to MAXIT as the JAX one does.
"""

import importlib

import numpy as np
import pytest
import torch

import cuda_mat_tpu as cm
import cuda_mat_tpu.formats.reorder as jreorder
from cuda_mat_tpu.models import problems as jprob

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.ops.operators import make_operator

tbs = importlib.import_module("cuda_mat_tpu_torch.solvers.bicgstab")

torch.set_num_threads(1)

# (entry point, config, the JAX error, the port's x: its loop's carry)
C10_CASES = [
    ("solve", {}, IndexError, 0.0),
    ("bicgstab", {}, IndexError, 0.0),
    ("bicgstab_lu_precond", {}, TypeError, 1.0),
    ("solve", {"precond": "ilu0"}, TypeError, 1.0),
    ("solve_refined", {}, IndexError, 1.0),
    ("bicg", {}, IndexError, 1.0),
]


def _port(a):
    return ct.CSRMatrix(a.n, a.m, a.data, a.indices, a.indptr)


@pytest.mark.parametrize("case", C10_CASES,
                         ids=[f"{c[0]} {c[1]}" for c in C10_CASES])
def test_maxit_zero(case):
    name, kw, jax_error, x_carry = case
    a = jprob.laplacian_2d(10)
    b = np.ones(a.n)
    with pytest.raises(jax_error):
        getattr(cm, name)(a, b, cm.SolverConfig(maxit=0, **kw))
    r = getattr(ct, name)(_port(a), b, ct.SolverConfig(maxit=0, **kw),
                          device="cpu")
    assert r.status == ct.SolverStatus.MAXIT and r.iters == 0
    r0 = np.linalg.norm(b - a.matvec(np.ones(a.n)))
    assert r0 == 16.0
    if name == "bicg":
        assert r.residual0 == np.linalg.norm(b) == 10.0
        assert r.residual == pytest.approx(r0 / np.linalg.norm(b),
                                           rel=1e-15)
    else:
        assert r.residual == pytest.approx(r0, rel=1e-15)
    np.testing.assert_array_equal(r.x, np.full(a.n, x_carry))


C9_SEEDS = (0, 1, 2, 3)        # 0: as numbered
C9_CFG = dict(maxit=2000, tol=1e-6, precond="jacobi")


def _renumbered(a, seed):
    if seed == 0:
        return a
    return jreorder.permute_csr(a, np.random.default_rng(seed).permutation(
        a.n).astype(np.int64))


@pytest.mark.parametrize("seed", C9_SEEDS)
def test_jacobi_on_the_random_system(seed):
    a = _renumbered(jprob.random_diag_nonzero_system(300, 0.9, seed=1)[0],
                    seed)
    b = np.ones(a.n)
    rj = cm.solve(a, b, cm.SolverConfig(**C9_CFG), format="ell")
    rt = ct.solve(_port(a), b, ct.SolverConfig(**C9_CFG), format="ell",
                  device="cpu")
    assert rj.status == cm.SolverStatus.MAXIT and rj.iters == 2000
    assert rt.status == ct.SolverStatus.BREAKDOWN and rt.iters < 200
    assert not np.isfinite(rt.residual)


def test_jacobi_breakdown_is_torch_dot_landing_on_zero():
    a = _port(jprob.random_diag_nonzero_system(300, 0.9, seed=1)[0])
    op = make_operator(a, torch.float64, "ell", device="cpu")
    inv_d = torch.from_numpy(1.0 / a.diagonal())
    b = torch.ones(a.n, dtype=torch.float64)

    def np_dot(u, v):
        return torch.tensor(np.dot(u.numpy(), v.numpy()))

    got = {}
    for name, dot in (("torch", torch.dot), ("numpy", np_dot)):
        _, status, iters, *_ = tbs.precond_core(
            op.matvec, lambda f: inv_d * f, dot, torch.ones_like(b), b,
            1e-6, 2000)
        got[name] = (int(status), int(iters))
    assert got["torch"][0] == 2 and got["torch"][1] < 200    # BREAKDOWN
    assert got["numpy"] == (0, 2000)                          # ran to maxit
