"""Kernel B3's module — the banded DIA SpMV twin, ``PallasDIAOperator``,
``restride_dia`` and ``dia_operator_from_numpy`` — against the JAX
package's ``cuda_mat_tpu.ops.pallas_spmv`` (Pallas in interpret mode) on
the same numpy inputs.

Tolerances: the twin takes the JAX kernel's products and sums in the same
order, but XLA's CPU compile of the interpret-mode body may contract a
product and a sum into one FMA, so the two agree to rounding: max|Δ| ≤ 1e-6
(f32) and ≤ 1e-13 (f64) of max|y|.  Host layouts and restrided data are
plain numpy in both packages and must be equal bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_mat_tpu.models.problems as jprob
import cuda_mat_tpu.precond.preconditioners as jpre
from cuda_mat_tpu.formats.dia import DIAMatrix as JDIAMatrix
from cuda_mat_tpu.io.mmio import load_mm_sparse_matrix as jload
from cuda_mat_tpu.ops.pallas_spmv import PallasDIAOperator as JOperator
from cuda_mat_tpu.ops.pallas_stencil import restride_dia as jrestride

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.models.problems as tprob
from cuda_mat_tpu_torch import convert
from cuda_mat_tpu_torch.formats.dia import DIAMatrix
from cuda_mat_tpu_torch.ops import dia_spmv as tds
from cuda_mat_tpu_torch.ops.stencil import restride_dia
from cuda_mat_tpu_torch.precond.preconditioners import neumann_factors

torch.set_num_threads(1)

TOL = {"float32": 1e-6, "float64": 1e-13}


def _random_band(n=5000, offsets=(-1500, -300, -7, -1, 0, 2, 50, 1023),
                 seed=0):
    """A banded matrix with random values on every in-range slot."""
    rng = np.random.default_rng(seed)
    offs = np.asarray(offsets, np.int32)
    data = rng.uniform(-2.0, 2.0, (offs.shape[0], n))
    i = np.arange(n)
    for d, off in enumerate(offs):
        data[d, (i + off < 0) | (i + off >= n)] = 0.0
    return offs, data


def _pair(name):
    """(port DIAMatrix, JAX DIAMatrix) of the same matrix, float64."""
    if name == "laplacian20":
        j = jprob.banded_laplacian_dia(20, dtype=np.float64)
        offs, data = j.offsets, j.data
    elif name == "mat3":
        j = jload(jprob.fixture_path("mat3")).to_dia(max_diags=16)
        offs, data = j.offsets, j.data
    else:
        offs, data = _random_band()
    n = data.shape[1]
    nnz = int(np.count_nonzero(data))
    return (DIAMatrix(n, n, np.array(offs), np.array(data), nnz),
            JDIAMatrix(n, n, np.array(offs), np.array(data), nnz))


@pytest.mark.parametrize("block", [2048, 32768])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["laplacian20", "mat3", "random"])
def test_twin_matches_jax_kernel(name, dtype, block):
    dt, dj = _pair(name)
    op_t = tds.PallasDIAOperator.from_dia(dt, dtype=getattr(torch, dtype),
                                          block=block, device="cpu")
    op_j = JOperator.from_dia(dj, dtype=getattr(jnp, dtype), block=block,
                              interpret=True)
    assert (op_t.npad, op_t.block, op_t.sub) == (op_j.npad, op_j.block,
                                                 op_j.sub)
    assert op_t.offsets == op_j.offsets
    x = np.random.default_rng(1).standard_normal(dt.n)
    y_t = op_t.matvec(op_t.pad_vec(x)).numpy()
    y_j = np.asarray(op_j.matvec(op_j.pad_vec(x)))
    assert y_t.dtype == y_j.dtype == np.dtype(dtype)
    assert np.abs(y_t - y_j).max() <= TOL[dtype] * np.abs(y_j).max()
    # pads and rows past n are exact zeros; the true rows are A x
    assert not y_t[:op_t.block].any() and not y_t[op_t.block + dt.n:].any()
    np.testing.assert_allclose(op_t.unpad_vec(torch.from_numpy(y_t)).numpy(),
                               dt.matvec(x), rtol=TOL[dtype] * 10,
                               atol=TOL[dtype] * 10 * np.abs(y_j).max())


def test_banded_laplacian_dia_matches_jax():
    for dtype in (np.float32, np.float64):
        t = ct.banded_laplacian_dia(31, dtype)
        j = jprob.banded_laplacian_dia(31, dtype)
        assert (t.n, t.nnz) == (j.n, j.nnz) and t.data.dtype == j.data.dtype
        np.testing.assert_array_equal(t.offsets, j.offsets)
        np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(ct.banded_laplacian_dia(31, np.float64).data,
                                  tprob.banded_laplacian(31).to_dia().data)


def test_diagonal_matrix_gets_a_nonzero_sub():
    """A diagonal matrix (bandwidth 0): the JAX rule rounds the bandwidth
    up to sub = 0 and divides by it; the port takes sub = 1024."""
    n = 50
    d = np.arange(1.0, n + 1)[None, :]
    op = tds.PallasDIAOperator.from_dia(
        DIAMatrix(n, n, np.zeros(1, np.int32), d, n), dtype=torch.float64,
        device="cpu")
    assert (op.sub, op.block, op.npad) == (1024, 32768, 32768)
    x = np.random.default_rng(0).standard_normal(n)
    np.testing.assert_array_equal(op.unpad_vec(op.matvec(op.pad_vec(x))),
                                  d[0] * x)
    with pytest.raises(ZeroDivisionError):
        JOperator.from_dia(JDIAMatrix(n, n, np.zeros(1, np.int32), d, n),
                           interpret=True)


def test_front_end_checks_its_operands():
    dt, _ = _pair("laplacian20")
    op = tds.PallasDIAOperator.from_dia(dt, dtype=torch.float64, block=2048,
                                        device="cpu")
    x = op.pad_vec(np.ones(dt.n))
    with pytest.raises(ValueError, match="shape"):
        tds.dia_spmv_block_padded(op.data, x[:-1], op.offsets, op.block,
                                  op.sub)
    with pytest.raises(ValueError, match="sub-block"):
        tds.dia_spmv_block_padded(op.data, x, (-2000,) + op.offsets[1:],
                                  op.block, op.sub)
    with pytest.raises(ValueError, match="dtype"):
        tds.dia_spmv_block_padded(op.data, x.float(), op.offsets, op.block,
                                  op.sub)


def _factor_dias(r, c):
    low, up, _ = neumann_factors(ct.grid_laplacian(r, c))
    jlow, jup, _ = jpre.neumann_factors(jprob.grid_laplacian(r, c))
    return ((low.to_dia(max_diags=128), jlow.to_dia(max_diags=128)),
            (up.to_dia(max_diags=128), jup.to_dia(max_diags=128)))


def test_restride_matches_jax_bitwise():
    """The exact ILU(0) factors of grid_laplacian(12, 20) and the matrix
    itself, restrided to stride 128, as in the stencil layout."""
    pairs = list(_factor_dias(12, 20))
    pairs.append((ct.grid_laplacian(12, 20).to_dia(),
                  jprob.grid_laplacian(12, 20).to_dia()))
    for t, j in pairs:
        rt, rj = restride_dia(t, 20, 128), jrestride(j, 20, 128)
        assert (rt.n, rt.m, rt.nnz) == (rj.n, rj.m, rj.nnz) == (
            12 * 128, 12 * 128, t.nnz)
        np.testing.assert_array_equal(rt.offsets, rj.offsets)
        assert rt.data.dtype == rj.data.dtype
        np.testing.assert_array_equal(rt.data, rj.data)
    with pytest.raises(ValueError, match="gap width"):
        restride_dia(pairs[0][0], 20, 20)


def test_dia_operator_from_numpy_carries_the_jax_operator():
    _, dj = _pair("random")
    op_j = JOperator.from_dia(dj, dtype=jnp.float64, block=4096,
                              interpret=True)
    op_t = convert.dia_operator_from_numpy(dict(
        data=tuple(np.asarray(d) for d in op_j.data), offsets=op_j.offsets,
        n=op_j.n, block=op_j.block, sub=op_j.sub,
        vec_dtype=op_j.vec_dtype), "cpu")
    assert op_t.vec_dtype == torch.float64 and op_t.data.shape == (
        len(op_j.offsets), op_j.npad)
    x = np.random.default_rng(2).standard_normal(op_j.n)
    y_j = np.asarray(op_j.matvec(op_j.pad_vec(x)))
    y_t = op_t.matvec(op_t.pad_vec(x)).numpy()
    assert np.abs(y_t - y_j).max() <= TOL["float64"] * np.abs(y_j).max()
