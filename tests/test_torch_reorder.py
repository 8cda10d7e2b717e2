"""RCM reordering of the port (``formats/reorder.py`` and ``make_solver``'s
``reorder="rcm"``) against the JAX package's.

The permutation, the bandwidth and the permuted matrix are compared
exactly; a reordered solve, f64, within ±2 iterations of the JAX
``make_solver(reorder="rcm")`` with the same status and x within 1e-8
(relative).  Inputs: ``banded_laplacian(side)`` under
``np.random.default_rng(seed).permutation``, as ``tests/test_reorder.py``
builds them.
"""

import numpy as np
import pytest
import torch

import cuda_mat_tpu as cm
import cuda_mat_tpu.formats.reorder as jreorder
import cuda_mat_tpu.models.problems as jprob

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.formats.reorder as treorder
from cuda_mat_tpu_torch.ops import operators as tops

torch.set_num_threads(1)


def _port(a):
    return ct.CSRMatrix(a.n, a.m, a.data, a.indices, a.indptr)


def _shuffled(side, seed=0):
    a = jprob.banded_laplacian(side)
    p = np.random.default_rng(seed).permutation(a.n).astype(np.int64)
    return jreorder.permute_csr(a, p)


def _two_components():
    """Two shuffled Laplacians side by side, no coupling: RCM seeds each
    component at its own min-degree node."""
    a, b = _shuffled(12, 1), _shuffled(9, 2)
    d = np.zeros((a.n + b.n,) * 2)
    d[:a.n, :a.n], d[a.n:, a.n:] = a.to_dense(), b.to_dense()
    p = np.random.default_rng(3).permutation(d.shape[0])
    return jprob.CSRMatrix.from_dense(d[p][:, p])


MATS = {"shuffled side 40": lambda: _shuffled(40),
        "two components": _two_components}


@pytest.mark.parametrize("name", sorted(MATS))
def test_rcm_permutation_equals_jax(name):
    a = MATS[name]()
    pj = jreorder.rcm_permutation(a)
    pt = treorder.rcm_permutation(_port(a))
    assert pt.dtype == np.int64
    np.testing.assert_array_equal(pt, pj)
    rj, rt = jreorder.permute_csr(a, pj), treorder.permute_csr(_port(a), pt)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f))
    assert treorder.bandwidth(rt) == jreorder.bandwidth(rj)
    assert treorder.bandwidth(_port(a)) == jreorder.bandwidth(a)


def test_rcm_recovers_the_narrow_band():
    a = _port(_shuffled(40))               # n = 1600, true bandwidth 40
    assert treorder.bandwidth(a) > 400
    r = treorder.permute_csr(a, treorder.rcm_permutation(a))
    assert treorder.bandwidth(r) <= 3 * 40


def test_bandwidth_of_edge_cases():
    empty = ct.CSRMatrix(4, 4, np.zeros(0), np.zeros(0), np.zeros(5))
    diag = ct.CSRMatrix.from_dense(np.eye(5))
    lower = ct.CSRMatrix.from_dense(np.tril(np.ones((6, 6))))
    for a in (empty, diag, lower):
        j = jprob.CSRMatrix(a.n, a.m, a.data, a.indices, a.indptr)
        assert treorder.bandwidth(a) == jreorder.bandwidth(j)
    assert treorder.bandwidth(lower) == 5


def test_permutation_round_trip():
    rng = np.random.default_rng(1)
    v = rng.standard_normal(100)
    perm = rng.permutation(100).astype(np.int64)
    np.testing.assert_array_equal(
        treorder.unpermute_vector(treorder.permute_vector(v, perm), perm), v)
    np.testing.assert_array_equal(treorder.permute_vector(v, perm),
                                  jreorder.permute_vector(v, perm))


@pytest.mark.parametrize("precond", ["jacobi", "ilu0", "ilu0_neumann"])
def test_reordered_solve_matches_jax(precond):
    a = _shuffled(24)
    b = np.random.default_rng(0).uniform(1.0, 5.0, a.n)
    kw = dict(maxit=2000, tol=1e-8, precond=precond, reorder="rcm",
              trisolve_block=32)
    rj = cm.make_solver(a, cm.SolverConfig(**kw)).solve(b)
    ps = ct.make_solver(_port(a), ct.SolverConfig(**kw), device="cpu")
    assert not tops.is_padded(ps.op)
    rt = ps.solve(b)
    assert rt.status == rj.status == ct.SolverStatus.CONVERGED
    assert abs(rt.iters - rj.iters) <= 2
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8
    # the true residual is the caller's system's, in its own ordering
    assert rt.residual_true == pytest.approx(
        np.linalg.norm(b - a.matvec(rt.x)), rel=1e-6)
    assert rt.residual_true / np.linalg.norm(b) < 1e-7


def test_unknown_reorder_raises_the_jax_error():
    a = _shuffled(6)
    with pytest.raises(ValueError) as e_j:
        cm.make_solver(a, cm.SolverConfig(reorder="amd"))
    with pytest.raises(ValueError) as e_t:
        ct.make_solver(_port(a), ct.SolverConfig(reorder="amd"),
                       device="cpu")
    assert str(e_t.value) == str(e_j.value)
