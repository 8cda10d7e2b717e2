"""The level-scheduled triangular solver (``ops/level_trisolve.py``, the
plain twin of kernel B8), HPCG's matrix generator
(``models/problems.hpcg27``), and exact ILU(0)'s route rule.

- The generator against a plain transcription of HPCG's
  ``GenerateProblem_ref`` triple loop: pattern, values, nnz = (3N - 2)^3.
- The level analysis: each row one level past its deepest dependency; a
  27-point N^3 grid in lexicographic order takes 7N - 6 levels a sweep.
- The twin's sweeps and msolve against the reference's sequential solves
  (``reference/cpu_solvers.py``) within 1e-12 of max|x|, f64: the twin sums
  each row in its column order as they do, but the products of a level
  come from torch's gather.
- The route rule, the make_solver record's span and level count, and the
  port's ``"levels"`` route against the JAX package's blocked engine on a
  12^3 HPCG grid (same status, iterations within 2, x to the goldens'
  tolerance).
"""

import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cuda_mat_tpu as cm
from cuda_mat_tpu.formats.csr import CSRMatrix as JCSRMatrix

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.formats import reorder
from cuda_mat_tpu_torch.formats.coo import COOMatrix
from cuda_mat_tpu_torch.models.problems import hpcg27
from cuda_mat_tpu_torch.ops import level_trisolve as tlv
from cuda_mat_tpu_torch.precond import preconditioners as tpre
from cuda_mat_tpu_torch.reference.cpu_solvers import (ilu0_factorize,
                                                      solve_lower_unit,
                                                      solve_upper)
from cuda_mat_tpu_torch.utils import timing

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for the dense route's block inverses (see
    test_torch_ilu0.py)."""
    with threadpool_limits(1):
        yield


hpcg = hpcg27


def hpcg_loop(nx, ny, nz):
    """``GenerateProblem_ref``'s loops as HPCG writes them, row by row."""
    indptr, indices, data = [0], [], []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                row = iz * nx * ny + iy * nx + ix
                for sz in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            if 0 <= iz + sz < nz and 0 <= iy + sy < ny \
                                    and 0 <= ix + sx < nx:
                                col = row + sz * nx * ny + sy * nx + sx
                                indices.append(col)
                                data.append(26.0 if col == row else -1.0)
                indptr.append(len(indices))
    return np.array(indptr), np.array(indices), np.array(data)


@pytest.mark.parametrize("shape", [(4, 3, 5), (6, 6, 6)])
def test_hpcg27_matches_the_reference_loop(shape):
    a = hpcg(*shape)
    indptr, indices, data = hpcg_loop(*shape)
    np.testing.assert_array_equal(a.indptr, indptr)
    np.testing.assert_array_equal(a.indices, indices)
    np.testing.assert_array_equal(a.data, data)
    assert a.indices.dtype == np.int32 and a.data.dtype == np.float64
    assert a.nnz == np.prod([3 * s - 2 for s in shape])


def _lower(a, upper=False):
    rows = np.repeat(np.arange(a.n), a.row_lengths)
    keep = a.indices > rows if upper else a.indices < rows
    return rows[keep], a.indices[keep].astype(np.int64)


@pytest.mark.parametrize("upper", [False, True])
def test_row_levels_are_one_past_the_deepest_dependency(upper):
    a = ct.load_mm_sparse_matrix(f"{ROOT}/data/mat900.mtx")
    rows, cols = _lower(a, upper)
    level = tlv.row_levels(a.n, rows, cols)
    want = np.zeros(a.n, dtype=np.int64)
    order = range(a.n - 1, -1, -1) if upper else range(a.n)
    for i in order:
        deps = cols[rows == i]
        want[i] = 1 + want[deps].max() if deps.size else 0
    np.testing.assert_array_equal(level, want)


@pytest.mark.parametrize("side", [4, 8])
def test_a_27_point_grid_takes_7n_minus_6_levels_a_sweep(side):
    a = hpcg(side, side, side)
    tri = tlv.LevelTriSolver.from_factor(a, ilu0_factorize(a), device="cpu")
    assert tri.lower.levels == tri.upper.levels == 7 * side - 6
    assert tri.levels == 2 * (7 * side - 6)
    assert tri.lower.blocks == 1


def _shuffled_grid():
    a = ct.grid_laplacian(17, 13)
    return reorder.permute_csr(
        a, np.random.default_rng(0).permutation(a.n).astype(np.int64))


TWIN_CASES = {
    "hpcg 7x6x5": lambda: hpcg(7, 6, 5),
    "mat900": lambda: ct.load_mm_sparse_matrix(f"{ROOT}/data/mat900.mtx"),
    "shuffled grid": _shuffled_grid,
}


@pytest.mark.parametrize("case", sorted(TWIN_CASES))
def test_twin_matches_the_sequential_solves(case):
    a = TWIN_CASES[case]()
    m = ilu0_factorize(a)
    tri = tlv.LevelTriSolver.from_factor(a, m, device="cpu")
    f = np.random.default_rng(4).standard_normal(a.n)
    y = solve_lower_unit(a, m, f)
    want = {"solve_lower": y, "solve_upper": solve_upper(a, m, f),
            "msolve": solve_upper(a, m, y)}
    tlv.reset_launch_counts()
    for what, x in want.items():
        got = getattr(tri, what)(torch.from_numpy(f)).numpy()
        assert np.abs(got - x).max() <= 1e-12 * np.abs(x).max(), what
    assert tlv.level_sweep.launches == 0


def test_f32_plan_is_the_f64_plan_rounded():
    a = hpcg(5, 4, 3)
    m = ilu0_factorize(a)
    t64 = tlv.LevelTriSolver.from_factor(a, m, device="cpu")
    t32 = tlv.LevelTriSolver.from_factor(a, m, dtype=torch.float32,
                                         device="cpu")
    assert torch.equal(t32.upper.vals, t64.upper.vals.float())
    assert torch.equal(t32.upper.diag, t64.upper.diag.float())
    f = torch.from_numpy(np.random.default_rng(5).standard_normal(a.n))
    x32 = t32.msolve(f.float())
    assert x32.dtype == torch.float32
    x64 = t64.msolve(f)
    assert float((x32.double() - x64).abs().max()) <= \
        1e-5 * float(x64.abs().max())


def test_front_end_rejects_bad_operands():
    a = hpcg(3, 3, 3)
    tri = tlv.LevelTriSolver.from_factor(a, ilu0_factorize(a), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tlv.level_sweep(torch.zeros(a.n - 1, dtype=torch.float64), tri.lower)
    with pytest.raises(ValueError, match="dtype"):
        tlv.level_sweep(torch.zeros(a.n, dtype=torch.float32), tri.lower)


def _offsets(n, lower, upper):
    rows, cols = [np.arange(n)], [np.arange(n)]
    for sign, dists in ((-1, lower), (1, upper)):
        for o in dists:
            i = np.arange(o, n) if sign < 0 else np.arange(n - o)
            rows.append(i)
            cols.append(i + sign * o)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.where(rows == cols, 4.0 * len(lower) + 4.0, -1.0)
    return ct.CSRMatrix.from_coo(COOMatrix(
        n, n, rows.astype(np.int32), cols.astype(np.int32), vals))


ROUTES = {
    # HPCG at 12^3: bandwidth 157 past the block
    "band past the block": (lambda: hpcg(12, 12, 12), "levels"),
    # the 1M cell's pattern (5-point, 100 wide) at 50 grid rows
    "the 1M cell's pattern": (lambda: ct.grid_laplacian(50, 100), "diag"),
    # nine offsets below the diagonal, all within the block
    "nine offsets within the block": (
        lambda: _offsets(300, tuple(range(3, 30, 3)), (1, 7)), "dense"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_ilu0_route_rule(case):
    make, route = ROUTES[case]
    a = make()
    pre = tpre.ILU0Preconditioner.from_csr(a, block=128, device="cpu")
    assert pre.route == route
    m = ilu0_factorize(a)
    f = np.random.default_rng(6).standard_normal(a.n)
    want = solve_upper(a, m, solve_lower_unit(a, m, f))
    got = pre.msolve(torch.from_numpy(f)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _cfg(mod, **kw):
    return mod.SolverConfig(**{"maxit": 2000, "tol": 1e-6,
                               "dtype": "float64", "precond": "ilu0",
                               "trisolve_block": 128, **kw})


def test_make_solver_records_the_level_analysis():
    a = hpcg(12, 12, 12)
    ps = ct.make_solver(a, _cfg(ct), device="cpu")
    rec = timing.records()[-1]
    assert rec.kind == "make_solver"
    assert ps.pre.route == "levels"
    assert rec.levels == ps.pre.tri.levels == 2 * (7 * 12 - 6)
    assert 0 < rec.seconds("precond.levels") < rec.seconds(
        "make_solver.precond")
    ps.solve(np.ones(a.n))
    assert timing.records()[-1].levels == 0


def test_levels_route_matches_jax_blocked_engine_on_hpcg():
    """HPCG 12^3 (bandwidth 157 > block 128): the port's level-scheduled
    ILU(0) against the JAX package's blocked one, f64, random b."""
    a = hpcg(12, 12, 12)
    a_j = JCSRMatrix(a.n, a.m, a.data, a.indices, a.indptr)
    b = np.random.default_rng(7).uniform(-1.0, 1.0, a.n)
    ps = ct.make_solver(a, _cfg(ct), device="cpu")
    assert isinstance(ps.pre.tri, tlv.LevelTriSolver)
    rt = ps.solve(b)
    rj = cm.make_solver(a_j, _cfg(cm)).solve(b)
    assert rt.status == rj.status == ct.SolverStatus.CONVERGED
    assert abs(rt.iters - rj.iters) <= 2
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-5, atol=1e-7)


# ---- the chunked layout (kernel B8's block-a-chunk form) ----

def _shuffled_316():
    a = ct.grid_laplacian(316, 316)
    return reorder.permute_csr(
        a, np.random.default_rng(0).permutation(a.n).astype(np.int64))


CHUNK_CASES = {
    "hpcg 24^3": lambda: hpcg(24, 24, 24),
    "grid 316^2": lambda: ct.grid_laplacian(316, 316),
    "mat900": lambda: ct.load_mm_sparse_matrix(f"{ROOT}/data/mat900.mtx"),
}


def _triangle(a, upper):
    """One triangle's entries in CSR order (the matrix's own values) and,
    for U, a diagonal."""
    rows = np.repeat(np.arange(a.n, dtype=np.int64), a.row_lengths)
    cols = a.indices.astype(np.int64)
    keep = cols > rows if upper else cols < rows
    diag = np.full(a.n, 4.0) if upper else None
    return rows[keep], cols[keep], a.data[keep].astype(np.float64), diag


@pytest.mark.parametrize("upper", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunked_plan_keeps_each_row_beside_what_it_reads(case, upper):
    """Every row in exactly one chunk, a chunk at least the bandwidth wide
    and counted in sweep order, positions by (chunk, level), and each
    entry's column in its own chunk or the chunk before it, at a lower
    level (there within the group's needed progress), its entries those of
    the triangle in column order."""
    a = CHUNK_CASES[case]()
    rows, cols, vals, diag = _triangle(a, upper)
    plan = tlv.level_plan(a.n, rows, cols, vals, diag, torch.float64, "cpu")
    ch = plan.chunks
    assert ch is not None and plan.level_ptr is None
    assert ch.width >= int(np.abs(rows - cols).max())
    assert ch.count == -(-a.n // ch.width)
    assert not ch.flags.any() and ch.flags.numel() == ch.count
    at = plan.rows.numpy().astype(np.int64)          # position -> row
    np.testing.assert_array_equal(np.sort(at), np.arange(a.n))
    g, ptr = ch.groups.numpy().astype(np.int64), ch.ptr.numpy()
    r, k = g[:, 2] & 0xFFFF, g[:, 2] >> 16
    np.testing.assert_array_equal(g[:, 1], np.cumsum(r) - r)
    chunk_of = np.repeat(np.repeat(np.arange(ch.count), np.diff(ptr)), r)
    sweep = a.n - 1 - at if upper else at
    np.testing.assert_array_equal(sweep // ch.width, chunk_of)
    level = tlv.row_levels(a.n, rows, cols)
    np.testing.assert_array_equal(np.repeat(ch.group_level.numpy(), r),
                                  level[at])
    key = chunk_of * (level.max() + 1) + level[at]
    assert (np.diff(key) >= 0).all()
    # each position's slots decoded: (row, column) pairs in column order
    p = np.repeat(np.arange(a.n), np.repeat(k, r))
    step = np.arange(p.size) - np.repeat(np.cumsum(np.repeat(k, r))
                                         - np.repeat(k, r),
                                         np.repeat(k, r))
    grp = np.repeat(np.arange(len(r)), r)[p]
    code = plan.cols.numpy()[g[grp, 0] + step * r[grp] + p - g[grp, 1]]
    keep = code != -1
    p, code = p[keep], code[keep].astype(np.int64)
    first = g[ptr[:-1], 1]
    src = np.where(code >= 0, first[chunk_of[p]] + code, -code - 2)
    own = code >= 0
    assert (chunk_of[src[own]] == chunk_of[p[own]]).all()
    assert (chunk_of[src[~own]] == chunk_of[p[~own]] - 1).all()
    assert (level[at[src]] < level[at[p]]).all()
    # ... and among the previous chunk's first `need` groups
    gpos = np.repeat(np.arange(len(r)), r)        # group of each position
    prev = ~own
    assert (gpos[src[prev]] - ptr[chunk_of[p[prev]] - 1]
            < g[gpos[p[prev]], 3]).all()
    same = p[1:] == p[:-1]                       # a row's slots: ascending
    assert (at[src][1:][same] > at[src][:-1][same]).all()
    got = np.stack([at[p], at[src]])
    order = np.lexsort((got[1], got[0]))
    np.testing.assert_array_equal(got[:, order], np.stack([rows, cols]))


@pytest.mark.parametrize("upper", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_twin_on_the_chunked_plan_equals_the_grid_plans(case, upper):
    a = CHUNK_CASES[case]()
    rows, cols, vals, diag = _triangle(a, upper)
    plans = [tlv.level_plan(a.n, rows, cols, vals, diag, torch.float64,
                            "cpu", route) for route in ("chunks", "grid")]
    assert plans[0].chunks is not None and plans[1].chunks is None
    f = torch.from_numpy(np.random.default_rng(8).standard_normal(a.n))
    got, want = (tlv.level_sweep_plain(f, p) for p in plans)
    assert torch.equal(got, want)


HPCG104_WIDTH = 104 * 104 + 104 + 1   # HPCG 104^3's bandwidth, both sweeps


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["hpcg 24^3", "hpcg 104^3",
                                  "shuffled 316^2"])
def test_chunk_route_rule(case, dtype):
    """HPCG's triangles take the chunked layout (a chunk's values fit a
    block's shared memory); the shuffled grid, whose band is nearly n,
    keeps the grid barrier."""
    item = torch.empty((), dtype=dtype).element_size()
    if case == "hpcg 104^3":     # the rule alone: no full-size plan here
        assert tlv.chunks_fit(HPCG104_WIDTH, item)
        return
    a = hpcg(24, 24, 24) if case == "hpcg 24^3" else _shuffled_316()
    rows, cols, vals, _ = _triangle(a, False)
    width = int(np.abs(rows - cols).max())
    plan = tlv.level_plan(a.n, rows, cols, vals, None, dtype, "cpu")
    chunked = case != "shuffled 316^2"
    assert tlv.chunks_fit(width, item) == chunked
    assert (plan.chunks is not None) == chunked
    assert (plan.level_ptr is None) == chunked


@pytest.mark.parametrize("route,want", [(None, 2 * 12), ("grid", 0)])
def test_levels_record_counts_the_chunks(route, want):
    """A make_solver record counts both sweeps' chunks beside their
    levels: HPCG 12^3, 12 chunks of 157 rows a sweep, none on the grid
    layout."""
    a = hpcg(12, 12, 12)
    with timing.record("make_solver"):
        tri = tlv.LevelTriSolver.from_factor(a, ilu0_factorize(a),
                                             device="cpu", route=route)
    rec = timing.records()[-1]
    assert rec.chunks == tri.chunks == want
    assert rec.levels == tri.levels == 2 * (7 * 12 - 6)
