"""The port's numpy CPU oracles (``cuda_mat_tpu_torch.reference.
cpu_solvers``): the JAX package's oracle tests run against them, and on the
same inputs each oracle returns the JAX package's arrays and counts exactly
(both are the same numpy code)."""

import dataclasses

import numpy as np
import pytest

from cuda_mat_tpu.reference import cpu_solvers as jcs

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.models.problems import fixture_path, laplacian_2d
from cuda_mat_tpu_torch.reference.cpu_solvers import (bicg_cpu,
                                                      bicgstab_hform_cpu,
                                                      bicgstab_ilu_cpu,
                                                      bicgstab_split_cpu,
                                                      ilu0_factorize,
                                                      solve_lower_unit,
                                                      solve_upper)


def _load(name):
    return ct.load_mm_sparse_matrix(fixture_path(name))


def _vec(name):
    _, coo = ct.read_mm(fixture_path(name))
    return ct.to_dense_vector(ct.CSRMatrix.from_coo(coo))


@pytest.fixture(scope="module")
def t_mat3():
    return _load("mat3")


@pytest.fixture(scope="module")
def t_vec3():
    return _vec("vec3")


@pytest.fixture(scope="module")
def t_mat900():
    return _load("mat900")


def _residual(a, x, b):
    return np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b)


def test_bicg_mat3(t_mat3, t_vec3):
    res = bicg_cpu(t_mat3, t_vec3, maxit=2000, eps=1e-6)
    assert res.converged
    assert _residual(t_mat3, res.x, t_vec3) < 1e-4
    np.testing.assert_allclose(t_mat3.to_dense() @ res.x, t_vec3, atol=1e-4)


def test_bicgstab_hform_mat3(t_mat3, t_vec3):
    res = bicgstab_hform_cpu(t_mat3, t_vec3, maxit=2000, tol=1e-6)
    assert res.converged and not res.breakdown
    assert _residual(t_mat3, res.x, t_vec3) < 1e-5


def test_bicgstab_split_mat3(t_mat3, t_vec3):
    """The demo path test_A0_d (reference example.cpp:33-106): maxit=2000,
    tol=1e-5, x0=ones."""
    res = bicgstab_split_cpu(_load("mat3_A0"), _vec("vec3_d"), np.ones(3),
                             t_vec3, maxit=2000, tol=1e-5)
    assert res.converged
    np.testing.assert_allclose(t_mat3.to_dense() @ res.x, t_vec3, atol=1e-4)


def test_split_equals_plain_trajectory(t_mat3, t_vec3):
    r1 = bicgstab_hform_cpu(t_mat3, t_vec3, maxit=50, tol=1e-12,
                            x0=np.ones(3))
    r2 = bicgstab_split_cpu(_load("mat3_A0"), _vec("vec3_d"), np.ones(3),
                            t_vec3, maxit=50, tol=1e-12)
    n = min(len(r1.residual_history), len(r2.residual_history))
    np.testing.assert_allclose(r1.residual_history[:n],
                               r2.residual_history[:n], rtol=1e-9, atol=1e-10)


def test_ilu0_exact_lu_on_dense_pattern():
    rng = np.random.default_rng(0)
    d = rng.standard_normal((6, 6)) + 6 * np.eye(6)
    a = ct.CSRMatrix.from_dense(d, eps=-1.0)
    m = ilu0_factorize(a)
    md = np.zeros((6, 6))
    for i in range(6):
        lo, hi = a.indptr[i], a.indptr[i + 1]
        md[i, a.indices[lo:hi]] = m[lo:hi]
    np.testing.assert_allclose((np.tril(md, -1) + np.eye(6)) @ np.triu(md),
                               d, rtol=1e-10, atol=1e-12)


def test_ilu0_triangular_solves(t_mat900, rng):
    m = ilu0_factorize(t_mat900)
    b = rng.standard_normal(900)
    y = solve_lower_unit(t_mat900, m, b)
    x = solve_upper(t_mat900, m, y)
    md = np.zeros((900, 900))
    for i in range(900):
        lo, hi = t_mat900.indptr[i], t_mat900.indptr[i + 1]
        md[i, t_mat900.indices[lo:hi]] = m[lo:hi]
    np.testing.assert_allclose((np.tril(md, -1) + np.eye(900)) @ y, b,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.triu(md) @ x, y, rtol=1e-8, atol=1e-10)


def test_ilu0_requires_diagonal():
    a = ct.CSRMatrix.from_dense(np.array([[0.0, 1.0], [1.0, 0.0]]))
    with pytest.raises(ValueError):
        ilu0_factorize(a)


def test_bicgstab_ilu_mat3_violates_contract(t_mat3, t_vec3):
    with pytest.raises(ValueError):
        bicgstab_ilu_cpu(t_mat3, t_vec3, maxit=200, tol=1e-5)


def test_bicgstab_ilu_small_dense_pattern(rng):
    d = rng.standard_normal((8, 8)) + 8 * np.eye(8)
    a = ct.CSRMatrix.from_dense(d, eps=-1.0)
    b = rng.uniform(1.0, 5.0, 8)
    res = bicgstab_ilu_cpu(a, b, maxit=200, tol=1e-8)
    assert res.converged and res.iters <= 1
    np.testing.assert_allclose(d @ res.x, b, rtol=1e-6)


def test_bicgstab_ilu_mat900(t_mat900, rng):
    b = rng.uniform(1.0, 5.0, 900)
    res = bicgstab_ilu_cpu(t_mat900, b, maxit=2000, tol=1e-6)
    assert res.converged and res.iters < 100
    assert _residual(t_mat900, res.x, b) < 1e-5


def test_bicgstab_hform_mat900(t_mat900, rng):
    b = rng.uniform(1.0, 5.0, 900)
    res = bicgstab_hform_cpu(t_mat900, b, maxit=2000, tol=1e-6)
    assert res.converged
    assert _residual(t_mat900, res.x, b) < 1e-5


def test_bicg_matches_omp_semantics_small():
    a = ct.CSRMatrix.from_dense(np.eye(4) * 2.0)
    res = bicg_cpu(a, np.full(4, 2.0), maxit=10, eps=1e-6)
    assert res.converged and res.iters == 0
    np.testing.assert_array_equal(res.x, np.ones(4))


def _same(r_t, r_j):
    a, b = dataclasses.asdict(r_t), dataclasses.asdict(r_j)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("name", ["mat3", "mat900", "lap12"])
def test_oracles_equal_jax(name, mat3, mat900, rng):
    """Every oracle on the same matrix and b: equal x, histories, flags and
    counts (the ILU(0) oracles on matrices ILU(0) takes)."""
    import cuda_mat_tpu.models.problems as jprob

    a_t = laplacian_2d(12) if name == "lap12" else _load(name)
    a_j = {"mat3": mat3, "mat900": mat900}.get(name) or jprob.laplacian_2d(12)
    b = rng.uniform(1.0, 5.0, a_t.n)
    _same(bicg_cpu(a_t, b, maxit=300), jcs.bicg_cpu(a_j, b, maxit=300))
    _same(bicgstab_hform_cpu(a_t, b, maxit=300, tol=1e-9),
          jcs.bicgstab_hform_cpu(a_j, b, maxit=300, tol=1e-9))
    d = np.arange(1.0, a_t.n + 1.0)
    _same(bicgstab_split_cpu(a_t, d, np.ones(a_t.n), b, maxit=300),
          jcs.bicgstab_split_cpu(a_j, d, np.ones(a_t.n), b, maxit=300))
    if name == "mat3":
        return
    m = ilu0_factorize(a_t)
    assert np.array_equal(m, jcs.ilu0_factorize(a_j))
    y = solve_lower_unit(a_t, m, b)
    assert np.array_equal(y, jcs.solve_lower_unit(a_j, m, b))
    assert np.array_equal(solve_upper(a_t, m, y), jcs.solve_upper(a_j, m, y))
    _same(bicgstab_ilu_cpu(a_t, b, maxit=300, tol=1e-9),
          jcs.bicgstab_ilu_cpu(a_j, b, maxit=300, tol=1e-9))
