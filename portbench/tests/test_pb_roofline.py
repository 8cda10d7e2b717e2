"""The roofline models against hand counts at a 4 x 3 grid, the frozen
generator against the port's, and a roofline share's arithmetic."""

import types

import numpy as np
import pytest

import pb_helpers  # noqa: F401  (puts the repository on sys.path)
from portbench import harness, matrices, peaks, spec, trace

# 4 x 3 grid: 12 rows; 5 entries a row less 2 per grid row (the +-1
# neighbours cut at its ends, 4 grid rows) and 2 per grid column (+-3
# cut at the first and the last grid row, 3 columns): 60 - 8 - 6 = 46
N, NNZ = 12, 46


def rec(dtype, terms=4, traced=()):
    return types.SimpleNamespace(
        n=N, nnz=NNZ, itemsize=np.dtype(dtype).itemsize, traced=list(traced),
        config={"solver": {"dtype": dtype, "neumann_terms": terms}},
        trace=None)


def test_grid_counts():
    a = matrices.make({"generator": "grid_laplacian", "rows": 4, "cols": 3})
    assert (a.n, a.indices.size, a.indptr[-1]) == (N, NNZ, NNZ)
    # the configurations' sizes: 5n - 2 rows - 2 cols
    for rows, cols, nnz in ((100000, 100, 49799800), (10000, 100, 4979800)):
        assert 5 * rows * cols - 2 * rows - 2 * cols == nnz


@pytest.mark.parametrize("rows,cols", [(4, 3), (7, 5), (1, 6), (6, 1)])
def test_grid_equals_the_ports(rows, cols):
    from cuda_mat_tpu_torch.models.problems import grid_laplacian

    ours = matrices.make({"generator": "grid_laplacian", "rows": rows,
                          "cols": cols})
    port = grid_laplacian(rows, cols)
    np.testing.assert_array_equal(ours.indptr, port.indptr)
    np.testing.assert_array_equal(ours.indices, port.indices)
    np.testing.assert_array_equal(ours.data, port.data)


def test_stencil_spmv_counts():
    op = spec.load_module("roofline", "stencil_spmv")
    r = rec("float32")
    assert op.nbytes(r) == 2 * 12 * 4          # x read, y written
    assert op.nflops(r) == 2 * 46
    assert op.per_solve(types.SimpleNamespace(steps=10)) == 21


def test_neumann_msolve_counts():
    op = spec.load_module("roofline", "neumann_msolve")
    r = rec("float32", terms=4)
    assert op.nbytes(r) == 3 * 12 * 4          # x, inv_d read, y written
    # off-diagonal entries 46 - 12 = 34, 3 Horner products each side
    assert op.nflops(r) == 2 * 3 * 34 + 12
    assert op.per_solve(types.SimpleNamespace(steps=10)) == 20


def test_ilu0_msolve_counts():
    op = spec.load_module("roofline", "ilu0_msolve")
    r = rec("float64")
    assert op.nbytes(r) == (46 + 2 * 12) * 8   # factors on A's pattern
    assert op.nflops(r) == 2 * 34 + 12
    assert op.per_solve(types.SimpleNamespace(steps=10)) == 20


def test_least_time_and_share():
    assert peaks.least_seconds(3.35e12, 1, "float32") == pytest.approx(1.0)
    assert peaks.least_seconds(1, 34e12, "float64") == pytest.approx(1.0)
    summary = trace.Summary(
        kernels={"void const_stencil_spmv_kernel<float>(float const*)": 2e-9,
                 "void const_stencil_spmv_dots_kernel<float>(int)": 5.0},
        launches={}, busy_s=0.0, window_s=0.0, gaps={})
    rows = [types.SimpleNamespace(steps=1)]          # 3 matvecs
    r = rec("float32", traced=rows)
    r.trace = summary
    op = spec.load_module("roofline", "stencil_spmv")
    least = 96 / 3.35e12
    assert peaks.roofline_pct(r, op, ("const_stencil_spmv_kernel",)) == \
        pytest.approx(100 * least * 3 / 2e-9)
    assert peaks.roofline_pct(r, op, ("chunk_walk_kernel",)) is None


def test_steps_counts_a_first_half_exit():
    hist = np.full(10, -1.0)
    hist[:5] = [3.0, 2.0, 1.0, 0.5, 0.1]       # steps 0, 1 whole, 2 half
    assert harness.steps_of(types.SimpleNamespace(residual_history=hist)) \
        == 3


def test_kernel_names():
    name = ("void at::native::vectorized_elementwise_kernel<4, "
            "at::native::CUDAFunctor_add<float>>(int, float)")
    assert trace.is_library(name)
    assert trace.is_library("void dot_kernel<float, 128, 0, "
                            "cublasDotParams<float>>(float)")
    assert not trace.is_library("void chunk_walk_kernel<double>(double)")
    assert trace.kernel_id("void chunk_walk_kernel<double>(double)") == \
        "chunk_walk_kernel"
    assert trace.short(name) == name[5:name.index(">(") + 1]
    port = ("void (anonymous namespace)::const_series_msolve_kernel<float, "
            "4>(MsolveArgs<float>)")
    assert trace.kernel_id(port) == "const_series_msolve_kernel"
    assert trace.short(port) == "const_series_msolve_kernel<float, 4>"
    assert not trace.is_library(port)
    where = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
             "(anonymous namespace)::where_kernel_impl(at::TensorIterator&)::"
             "{lambda(bool, float, float)#1}>(int, float)")
    assert trace.is_library(where)
    assert trace.kernel_id(where) == "vectorized_elementwise_kernel"
