"""BiCG of the port (``solvers/bicg.py``) against the checked-in goldens
(``tests/goldens/mat*_bicg.npz``, the reference's f64 trajectories) and
the JAX package's ``bicg``.

Tolerances: the goldens' (``tests/test_goldens.py``): iterations within
±6, x within rtol 1e-4 (atol 1e-6); against the JAX ``bicg`` on the same
input, f64, within ±2 iterations and x within 1e-8 (relative).
"""

import os

import numpy as np
import pytest
import torch

import cuda_mat_tpu as cm

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.ops import operators as tops

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(maxit=2000, tol=1e-6)


def _load(mod, name):
    return mod.load_mm_sparse_matrix(os.path.join(ROOT, "data",
                                                  f"{name}.mtx"))


@pytest.mark.parametrize("name", ["mat900", "mat10000"])
def test_bicg_lands_on_the_golden(name):
    g = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}_bicg.npz"))
    a = _load(ct, name)
    r = ct.bicg(a, np.ones(a.n), ct.SolverConfig(**CFG), device="cpu")
    assert r.converged and abs(r.iters - int(g["iters"])) <= 6
    np.testing.assert_allclose(r.x, g["x"], rtol=1e-4, atol=1e-6)
    assert r.residual_true is not None and np.isfinite(r.residual_true)
    hist = r.residual_history
    assert hist.shape == (2000,) and (hist[:r.iters + 1] >= 0).all()
    assert (hist[r.iters + 1:] == -1).all()


@pytest.mark.parametrize("fmt", [None, "csr", "ell"])
def test_bicg_matches_jax(fmt):
    rj = cm.bicg(_load(cm, "mat900"), np.ones(900), cm.SolverConfig(**CFG),
                 format=fmt)
    rt = ct.bicg(_load(ct, "mat900"), np.ones(900), ct.SolverConfig(**CFG),
                 format=fmt, device="cpu")
    assert rt.status == rj.status == ct.SolverStatus.CONVERGED
    assert abs(rt.iters - rj.iters) <= 2
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8
    assert rt.residual == pytest.approx(rj.residual, rel=1e-6)
    assert rt.residual0 == pytest.approx(rj.residual0, rel=1e-12)


def test_bicg_takes_a_callers_operator_pair():
    a = _load(ct, "mat900")
    ops = tuple(tops.make_operator(m, format="csr", device="cpu")
                for m in (a, a.transpose()))
    r = ct.bicg(ops, np.ones(a.n), ct.SolverConfig(**CFG), device="cpu")
    rm = ct.bicg(a, np.ones(a.n), ct.SolverConfig(**CFG), format="csr",
                 device="cpu")
    assert r.converged and r.iters == rm.iters
    np.testing.assert_array_equal(r.x, rm.x)
    assert r.residual_true is None     # no host matrix to check against


def test_bicg_maxit_status():
    a = _load(ct, "mat900")
    r = ct.bicg(a, np.ones(a.n), ct.SolverConfig(maxit=3, tol=1e-14),
                device="cpu")
    rj = cm.bicg(_load(cm, "mat900"), np.ones(a.n),
                 cm.SolverConfig(maxit=3, tol=1e-14))
    assert r.status == rj.status == ct.SolverStatus.MAXIT
    assert r.iters == rj.iters == 3
    np.testing.assert_allclose(r.residual_history, rj.residual_history,
                               rtol=1e-12)
