"""The port's host utilities — inf-norms, checkpoints, dense Givens QR, the
phase timer, ``dump_vector`` and the OMP text formats — against the JAX
package's: the JAX package's utility tests run against the port's modules,
and on the same inputs both give equal numbers, arrays and bytes.  A
checkpoint written by either package loads in the other."""

import io
import os
import time

import numpy as np
import pytest

import cuda_mat_tpu as cm
from cuda_mat_tpu.io import omp_format as j_omp
from cuda_mat_tpu.io.vectors import dump_vector as j_dump
from cuda_mat_tpu.utils import checkpoint as j_ck
from cuda_mat_tpu.utils import dense_qr as j_qr
from cuda_mat_tpu.utils import norms as j_norms
from cuda_mat_tpu.utils.timing import PhaseTimer as JPhaseTimer

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.utils as tutils
from cuda_mat_tpu_torch.io import omp_format
from cuda_mat_tpu_torch.io.vectors import dump_vector
from cuda_mat_tpu_torch.models.problems import banded_laplacian, fixture_path
from cuda_mat_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
from cuda_mat_tpu_torch.utils.dense_qr import (back_substitution,
                                               givens_rotation, is_consistent,
                                               qr_givens, rank_row_echelon,
                                               solve_qr)
from cuda_mat_tpu_torch.utils.norms import (csr_mat_norminf, display_matrix,
                                            mat_norminf, vec_norminf)
from cuda_mat_tpu_torch.utils.timing import PhaseTimer, second


@pytest.fixture(scope="module")
def mat3_t():
    return ct.load_mm_sparse_matrix(fixture_path("mat3"))


@pytest.fixture(scope="module")
def mat900_t():
    return ct.load_mm_sparse_matrix(fixture_path("mat900"))


def test_norms(mat3_t, rng):
    v = rng.standard_normal(10)
    assert vec_norminf(v) == np.abs(v).max()
    d = mat3_t.to_dense()
    assert mat_norminf(d) == np.abs(d).sum(axis=1).max()
    assert csr_mat_norminf(mat3_t) == mat_norminf(d)
    assert vec_norminf([]) == 0.0


@pytest.mark.parametrize("name", ["mat3", "mat900", "mat10000"])
def test_norms_equal_jax(name, rng):
    a_t = ct.load_mm_sparse_matrix(fixture_path(name))
    a_j = cm.load_mm_sparse_matrix(fixture_path(name))
    v = rng.standard_normal(a_t.n)
    assert vec_norminf(v) == j_norms.vec_norminf(v)
    assert csr_mat_norminf(a_t) == j_norms.csr_mat_norminf(a_j)
    if a_t.n <= 900:
        assert mat_norminf(a_t.to_dense()) == \
            j_norms.mat_norminf(a_j.to_dense())


def test_display_matrix_equals_jax(mat3_t, mat3):
    s_t, s_j = io.StringIO(), io.StringIO()
    assert display_matrix(mat3_t, s_t) == j_norms.display_matrix(mat3, s_j)
    assert s_t.getvalue() == s_j.getvalue()
    d = np.arange(6.0).reshape(2, 3) / 7
    assert display_matrix(d) == j_norms.display_matrix(d)


def test_checkpoint_roundtrip(tmp_path, mat900_t, rng):
    b = rng.uniform(1.0, 5.0, 900)
    res = ct.bicgstab(mat900_t, b, ct.SolverConfig(maxit=5, tol=1e-14),
                      device="cpu")
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, res, matrix="mat900")
    ck = load_checkpoint(p)
    np.testing.assert_array_equal(ck.x, res.x)
    assert ck.iters == res.iters
    assert str(ck.meta["matrix"]) == "mat900"


def test_checkpoint_resume_converges(tmp_path, mat900_t, rng):
    """Restarting from a checkpointed iterate continues to convergence."""
    b = rng.uniform(1.0, 5.0, 900)
    partial = ct.bicgstab(mat900_t, b, ct.SolverConfig(maxit=10, tol=1e-14),
                          device="cpu")
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, partial)
    ck = load_checkpoint(p)
    res = ct.bicgstab(mat900_t, b, ct.SolverConfig(maxit=2000, tol=1e-6),
                      x0=ck.x, device="cpu")
    assert res.converged
    r = np.linalg.norm(b - mat900_t.matvec(res.x)) / np.linalg.norm(b)
    assert r < 1e-5


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_in_the_other_package(writer, tmp_path, rng):
    x = rng.standard_normal(17)
    p = str(tmp_path / "ck.npz")
    save, load = ((j_ck.save_checkpoint, load_checkpoint) if writer == "jax"
                  else (save_checkpoint, j_ck.load_checkpoint))
    save(p, x, iters=12, residual=0.25, matrix="mat900", omega=0.97)
    ck = load(p)
    np.testing.assert_array_equal(ck.x, x)
    assert (ck.iters, ck.residual) == (12, 0.25)
    assert str(ck.meta["matrix"]) == "mat900"
    assert float(ck.meta["omega"]) == 0.97
    # and the same file bytes from both writers
    q = str(tmp_path / "other.npz")
    (save_checkpoint if writer == "jax" else j_ck.save_checkpoint)(
        q, x, iters=12, residual=0.25, matrix="mat900", omega=0.97)
    with np.load(p) as zp, np.load(q) as zq:
        assert zp.files == zq.files
        for k in zp.files:
            assert zp[k].dtype == zq[k].dtype and np.array_equal(zp[k],
                                                                 zq[k])


def test_qr_givens(rng):
    a = rng.standard_normal((6, 6))
    q, r = qr_givens(a)
    np.testing.assert_allclose(q @ r, a, atol=1e-10)
    np.testing.assert_allclose(q @ q.T, np.eye(6), atol=1e-10)
    np.testing.assert_allclose(np.tril(r, -1), 0.0, atol=1e-10)


def test_rank_and_consistency():
    a = np.array([[1.0, 2.0], [2.0, 4.0]])  # rank 1
    assert rank_row_echelon(a) == 1
    assert is_consistent(a, np.array([1.0, 2.0]))       # b in range
    assert not is_consistent(a, np.array([1.0, 3.0]))   # b not in range


def test_back_substitution(rng):
    r = np.triu(rng.standard_normal((5, 5))) + 5 * np.eye(5)
    y = rng.standard_normal(5)
    np.testing.assert_allclose(r @ back_substitution(r, y), y, atol=1e-10)


def test_solve_qr(rng):
    a = rng.standard_normal((5, 5)) + 5 * np.eye(5)
    b = rng.standard_normal(5)
    x = solve_qr(a, b)
    np.testing.assert_allclose(a @ x, b, atol=1e-9)
    assert solve_qr(np.array([[1.0, 2.0], [2.0, 4.0]]),
                    np.array([1.0, 3.0])) is None


@pytest.mark.parametrize("shape", [(6, 6), (7, 4), (4, 7)])
def test_dense_qr_equals_jax(shape, rng):
    a = rng.standard_normal(shape)
    a[1, 0] = 0.0
    q_t, r_t = qr_givens(a)
    q_j, r_j = j_qr.qr_givens(a)
    assert np.array_equal(q_t, q_j) and np.array_equal(r_t, r_j)
    assert rank_row_echelon(a) == j_qr.rank_row_echelon(a)
    b = rng.standard_normal(shape[0])
    assert is_consistent(a, b) == j_qr.is_consistent(a, b)
    if shape[0] == shape[1]:
        assert np.array_equal(solve_qr(a, b), j_qr.solve_qr(a, b))
        assert np.array_equal(back_substitution(r_t, b),
                              j_qr.back_substitution(r_j, b))
    assert np.array_equal(givens_rotation(5, 1, 3, 0.3, -0.4),
                          j_qr.givens_rotation(5, 1, 3, 0.3, -0.4))


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("load"):
        time.sleep(0.01)
    assert t.times["load"] >= 0.01
    assert "load" in t.report()
    assert second() <= time.perf_counter()


def test_phase_timer_report_reads_as_jax():
    t, j = PhaseTimer(), JPhaseTimer()
    for timer in (t, j):
        timer.times.update({"load": 0.25, "solve": 1.5})
    assert t.report() == j.report() == "load: 0.250000 s\nsolve: 1.500000 s"


def test_utils_exports_as_jax():
    import cuda_mat_tpu.utils as jutils

    assert tutils.__all__ == jutils.__all__


@pytest.mark.parametrize("v", [[7 / 6, 17 / 3, -23 / 6], [], [1e-7, -0.0]])
def test_dump_vector_equals_jax(v):
    assert dump_vector(np.array(v)) == j_dump(np.array(v))
    assert dump_vector(np.array(v, np.float32)) == \
        j_dump(np.array(v, np.float32))


def test_omp_format_bytes_and_roundtrip_equal_jax(tmp_path, rng):
    a = banded_laplacian(8)
    v = rng.uniform(-10.0, 10.0, 64)
    for kind, write_t, write_j, read_t in (
            ("mat", omp_format.write_matrix, j_omp.write_matrix,
             omp_format.read_matrix),
            ("vec", omp_format.write_vector, j_omp.write_vector,
             omp_format.read_vector)):
        obj = a if kind == "mat" else v
        pt, pj = tmp_path / f"{kind}_t.txt", tmp_path / f"{kind}_j.txt"
        write_t(str(pt), obj)
        write_j(str(pj), obj)
        assert pt.read_bytes() == pj.read_bytes()
        back = read_t(str(pt))
        if kind == "mat":
            for f in ("indptr", "indices", "data"):
                assert np.array_equal(getattr(back, f), getattr(a, f))
            m_j = j_omp.read_matrix(str(pj))
            assert np.array_equal(back.data, m_j.data)
        else:
            assert np.array_equal(back, v)
            assert np.array_equal(back, j_omp.read_vector(str(pj)))
