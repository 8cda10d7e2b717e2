"""Matrix Market ingestion of the PyTorch port against the JAX package:
every fixture under data/ loads to the same CSR arrays through the port's
numpy reader and its native parser, and malformed files raise the same
errors."""

import io
import os

import numpy as np
import pytest

import cuda_mat_tpu.io.mmio as jmm

import cuda_mat_tpu_torch.io.mmio as tmm
from cuda_mat_tpu_torch.native import loader as tnative

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
FIXTURES = sorted(f for f in os.listdir(DATA) if f.endswith(".mtx"))

BAD = [
    "%%MatrixMarket matrix coordinate real\n1 1 1\n1 1 1.0\n",
    "%MatrixMarket matrix coordinate real general\n1 1 1\n1 1 1.0\n",
    "%%MatrixMarket vector coordinate real general\n1 1 1\n1 1 1.0\n",
    "%%MatrixMarket matrix array real general\n1 1\n1.0\n",
    "%%MatrixMarket matrix coordinate pattern general\n1 1 1\n1 1\n",
    "%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1.0 0.0\n",
    "%%MatrixMarket matrix coordinate real weird\n1 1 1\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 1\n0 1 1.0\n",
]


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_loads_as_in_jax(name, native):
    if native:
        assert tnative.available()
    path = os.path.join(DATA, name)
    a_j = jmm.load_mm_sparse_matrix(path, prefer_native=False)
    a_t = tmm.load_mm_sparse_matrix(path, prefer_native=native)
    assert (a_t.n, a_t.m, a_t.nnz) == (a_j.n, a_j.m, a_j.nnz)
    for f in ("indptr", "indices", "data"):
        got, want = getattr(a_t, f), getattr(a_j, f)
        assert got.dtype == want.dtype and np.array_equal(got, want), f


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_diagonal_as_in_jax(name):
    path = os.path.join(DATA, name)
    d_j = jmm.load_mm_sparse_matrix(path, prefer_native=False).diagonal()
    d_t = tmm.load_mm_sparse_matrix(path).diagonal()
    assert d_t.dtype == d_j.dtype and np.array_equal(d_t, d_j)


@pytest.mark.parametrize("text", BAD)
def test_bad_files_raise_the_same_errors(text):
    with pytest.raises(ValueError) as e_j:
        jmm.read_mm(io.StringIO(text))
    with pytest.raises(ValueError) as e_t:
        tmm.read_mm(io.StringIO(text))
    assert str(e_t.value) == str(e_j.value)


def test_native_parse_error_names_the_file(tmp_path):
    path = tmp_path / "bad.mtx"
    path.write_text(BAD[0])
    with pytest.raises(ValueError, match="native MM parse failed .*bad.mtx"
                                         ".* \\(code -2\\)"):
        tmm.load_mm_sparse_matrix(path)


def test_symmetrize_flag():
    """``symmetrize=False`` keeps the stored triangle only (mat900.mtx
    stores 4322 of its 7744 entries)."""
    path = os.path.join(DATA, "mat900.mtx")
    for native in (False, True):
        a = tmm.load_mm_sparse_matrix(path, symmetrize=False,
                                      prefer_native=native)
        assert a.nnz == 4322


def _written(write, *args, **kw):
    f = io.StringIO()
    write(f, *args, **kw)
    return f.getvalue()


@pytest.mark.parametrize("name", ["mat3.mtx", "mat900.mtx", "mat10000.mtx",
                                  "vec3.mtx"])
def test_write_mm_bytes_equal_jax_and_round_trip(name, tmp_path):
    """``write_mm`` formats a chunk of lines at a time; its bytes are the
    JAX writer's line by line, for a CSR matrix and for its COO, and the
    file loads back to the same CSR arrays."""
    path = os.path.join(DATA, name)
    a_t = tmm.load_mm_sparse_matrix(path)
    a_j = jmm.load_mm_sparse_matrix(path, prefer_native=False)
    for kw in ({}, {"symmetry": "general", "comment": "one\ntwo"}):
        text = _written(tmm.write_mm, a_t, **kw)
        assert text == _written(jmm.write_mm, a_j, **kw)
        assert _written(tmm.write_mm, a_t.to_coo(), **kw) == text
    out = tmp_path / name
    tmm.write_mm(str(out), a_t)
    assert out.read_text() == _written(jmm.write_mm, a_j)
    back = tmm.load_mm_sparse_matrix(str(out))
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(back, f), getattr(a_t, f)), f


def test_write_mm_past_one_chunk_equals_jax():
    """More entries than one formatting chunk (65,536 lines), with values
    that test the %.16e format's edges."""
    from cuda_mat_tpu.formats.coo import COOMatrix as JCOO

    from cuda_mat_tpu_torch.formats.coo import COOMatrix as TCOO

    rng = np.random.default_rng(0)
    nnz = 3 * (1 << 16) + 5
    rows = rng.integers(0, 50000, nnz)
    cols = rng.integers(0, 50000, nnz)
    vals = rng.standard_normal(nnz) * 10.0 ** rng.integers(-300, 300, nnz)
    vals[:6] = [0.0, -0.0, 1.0, -1.0, 5e-324, 1.7976931348623157e308]
    text = _written(tmm.write_mm, TCOO(50000, 50000, rows, cols, vals))
    assert text == _written(jmm.write_mm, JCOO(50000, 50000, rows, cols,
                                               vals))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_write_mm_dense_vector_equals_jax(dtype, tmp_path):
    v = np.random.default_rng(1).standard_normal(37).astype(dtype)
    text = _written(tmm.write_mm_dense_vector, v)
    assert text == _written(jmm.write_mm_dense_vector, v)
    p = tmp_path / "v.mtx"
    tmm.write_mm_dense_vector(str(p), v)
    _, coo = tmm.read_mm(str(p))
    from cuda_mat_tpu_torch import CSRMatrix, to_dense_vector

    assert np.array_equal(to_dense_vector(CSRMatrix.from_coo(coo)),
                          v.astype(np.float64))
