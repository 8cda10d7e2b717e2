"""The diagonal-form route of the banded ILU(0) trisolve (kernels B4a/B4b
over the factor's own diagonals): its plain twin, the chunked algorithm in
PyTorch phase for phase (``diag_sweep_chunked_plain``), held against the
dense route's sequential twin (``banded_sweep_padded_plain``), a plain
sequential solve in numpy and, where the matrix is small, a dense numpy
solve; its plan; the route rule at its edge; and the factor's values kept
as ``_factorize`` made them.

The chunked walk reorders only additions (a chunk's entering tail comes
through its transfer matrix) and scales the backward rows by 1 / u_ii, so
it agrees to rounding: 1e-12 of max|reference| in f64, 1e-5 in f32.
"""

import functools
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.models.problems as tprob
from cuda_mat_tpu_torch.formats.coo import COOMatrix
from cuda_mat_tpu_torch.ops import banded_trisolve as tbt
from cuda_mat_tpu_torch.precond import preconditioners as tpre
from cuda_mat_tpu_torch.reference.cpu_solvers import ilu0_factorize

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
MATS = ["grid300x20", "grid97x13", "mat900", "mat10000"]
CHUNKS = ["1", "2", "7", "ragged"]
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
DENSE_MAX_N = 1500   # dense numpy solves only below this


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's block inverses (the dense route's
    arrays, built here as a reference)."""
    with threadpool_limits(1):
        yield


def _matrix(name):
    if name.startswith("mat"):
        return ct.load_mm_sparse_matrix(os.path.join(DATA, f"{name}.mtx"))
    r, c = name[4:].split("x")
    return tprob.grid_laplacian(int(r), int(c))


def offset_matrix(n, lower, upper, seed=0):
    """A diagonally dominant matrix with entries on exactly the given
    offsets (distances below and above the diagonal)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [np.arange(n)], [np.arange(n)], [
        np.full(n, 2.0 + len(lower) + len(upper))]
    for sign, dists in ((-1, lower), (1, upper)):
        for o in dists:
            i = np.arange(o, n) if sign < 0 else np.arange(n - o)
            rows.append(i)
            cols.append(i + sign * o)
            vals.append(rng.uniform(-1.0, -0.2, i.shape[0]))
    return ct.CSRMatrix.from_coo(COOMatrix(
        n, n, np.concatenate(rows).astype(np.int32),
        np.concatenate(cols).astype(np.int32), np.concatenate(vals)))


def sequential_solve(csr, m, f, lower):
    """The recurrence row by row in numpy, in float64: y = L⁻¹f (unit L)
    or x = U⁻¹f."""
    n = csr.n
    out = np.zeros(n)
    order = range(n) if lower else range(n - 1, -1, -1)
    for i in order:
        lo, hi = csr.indptr[i], csr.indptr[i + 1]
        js, vs = csr.indices[lo:hi], m[lo:hi]
        keep = js < i if lower else js > i
        acc = f[i] - float(np.dot(vs[keep], out[js[keep]]))
        out[i] = acc if lower else acc / vs[js == i][0]
    return out


@functools.lru_cache(maxsize=None)
def _factor(name):
    a = _matrix(name)
    m = ilu0_factorize(a)
    f = np.random.default_rng(5).standard_normal(a.n)
    y = sequential_solve(a, m, f, True)
    return a, m, f, y, sequential_solve(a, m, y, False), \
        sequential_solve(a, m, f, False)


@functools.lru_cache(maxsize=None)
def _solvers(name, dtype):
    a, m, *_ = _factor(name)
    return (tbt.DiagTriSolver.from_factor(a, m, block=128, dtype=dtype,
                                          device="cpu"),
            tbt.BandedTriSolver.from_factor(a, m, block=128, dtype=dtype,
                                            device="cpu"))


def _rows(which, n, tb):
    return {"1": n, "2": -(-n // 2), "7": -(-n // 7),
            "ragged": 2 * max(tb, 1) + 1}[which]


def _close(got, want, dtype):
    got = got.double().numpy() if torch.is_tensor(got) else got
    want = want.double().numpy() if torch.is_tensor(want) else want
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("which", CHUNKS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", MATS)
def test_chunked_twin_matches_references(name, dtype, which):
    """Both sweeps and the msolve at 1, 2, 7 chunks and at a chunk length
    that leaves the last chunk short, against the dense route's sequential
    twin, the numpy sequential solve and (small n) a dense numpy solve."""
    a, m, f, y_ref, x_ref, up_ref = _factor(name)
    tri, dense = _solvers(name, dtype)
    ft = torch.from_numpy(f).to(dtype)
    plans = [tbt.diag_plan(tri.lo_vals, tri.lo_offs, None, a.n, True,
                           _rows(which, a.n, tri.plan_lo.tb)),
             tbt.diag_plan(tri.up_vals, tri.up_offs, tri.up_diag, a.n,
                           False, _rows(which, a.n, tri.plan_up.tb))]
    assert plans[0].chunks == {"1": 1, "2": 2, "7": 7}.get(
        which, plans[0].chunks)
    assert plans[0].t.shape == (plans[0].chunks - 1, plans[0].tb,
                                plans[0].tb)
    y = tbt.diag_sweep_chunked_plain(ft, tri.lo_vals, tri.lo_offs, None,
                                     plans[0], True)
    up = tbt.diag_sweep_chunked_plain(ft, tri.up_vals, tri.up_offs,
                                      tri.up_diag, plans[1], False)
    x = tbt.diag_msolve_plain(ft, tri.lo_vals, tri.lo_offs, tri.up_vals,
                              tri.up_offs, tri.up_diag, plans)
    for got, want in ((y, y_ref), (up, up_ref), (x, x_ref)):
        assert got.dtype == dtype and got.shape == (a.n,)
        _close(got, want, dtype)
    fp = dense._pad(ft)
    _close(y, tbt.banded_sweep_padded_plain(fp, dense.wt_lo, dense.wct_lo,
                                            True)[:a.n], dtype)
    _close(up, tbt.banded_sweep_padded_plain(fp, dense.wt_up, dense.wct_up,
                                             False)[:a.n], dtype)
    _close(x, tbt.fused_msolve_padded_plain(fp, dense.wt_lo, dense.wct_lo,
                                            dense.wt_up,
                                            dense.wct_up)[:a.n], dtype)
    if a.n <= DENSE_MAX_N:
        d = np.zeros((a.n, a.n))
        d[np.repeat(np.arange(a.n), a.row_lengths), a.indices] = m
        lo_d = np.tril(d, -1) + np.eye(a.n)
        _close(x, np.linalg.solve(np.triu(d), np.linalg.solve(lo_d, f)),
               dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", MATS)
def test_solver_front_ends_run_the_twin_on_the_cpu(name, dtype):
    """DiagTriSolver's sweeps and msolve on CPU tensors: true-n vectors in
    and out, the plain twin with the factor's own plan, no launch
    counted."""
    a, _, f, y_ref, x_ref, up_ref = _factor(name)
    tri, _ = _solvers(name, dtype)
    ft = torch.from_numpy(f).to(dtype)
    tbt.reset_launch_counts()
    _close(tri.solve_lower(ft), y_ref, dtype)
    _close(tri.solve_upper(ft), up_ref, dtype)
    x = tri.msolve(ft)
    _close(x, x_ref, dtype)
    assert torch.equal(x, tri.msolve(ft))
    assert tbt.diag_msolve.launches == 0 and tbt.diag_sweep.launches == 0


@pytest.mark.parametrize("name", MATS)
def test_values_are_the_factors_unchanged(name):
    """Each stored value is ``_factorize``'s own, by offset, bit for bit in
    f64; rows without an entry at an offset hold 0."""
    a, m, *_ = _factor(name)
    tri, _ = _solvers(name, torch.float64)
    rows = np.repeat(np.arange(a.n), a.row_lengths)
    offs = a.indices.astype(np.int64) - rows
    lo, up = tbt.factor_offsets(a)
    assert (tri.lo_offs, tri.up_offs) == (lo, up)
    assert list(lo) == sorted(set(-offs[offs < 0]), reverse=True)
    got = np.zeros_like(m)
    for k, o in enumerate(lo):
        got[offs == -o] = tri.lo_vals[k].numpy()[rows[offs == -o]]
    for k, o in enumerate(up):
        got[offs == o] = tri.up_vals[k].numpy()[rows[offs == o]]
    got[offs == 0] = tri.up_diag.numpy()[rows[offs == 0]]
    assert np.array_equal(got, m)
    nnz = sum(int(torch.count_nonzero(v)) for v in (tri.lo_vals,
                                                      tri.up_vals))
    assert nnz == int(np.count_nonzero(m[offs != 0]))


@pytest.mark.parametrize("name", MATS)
def test_transfer_matrices_carry_a_tail(name):
    """T_c is the map from a chunk's entering tail to its exit tail under f
    = 0: walking a chunk from a random tail with f = 0 gives s·T_c."""
    a, *_ = _factor(name)
    tri, _ = _solvers(name, torch.float64)
    plan = tbt.diag_plan(tri.lo_vals, tri.lo_offs, None, a.n, True,
                         2 * tri.plan_lo.tb + 3)
    assert plan.chunks > 2
    s = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (plan.chunks - 1, plan.tb)))
    vc = tbt._in_chunks(tri.lo_vals, plan.chunks, plan.rows)[:, :-1]
    _, exits = tbt._walk(torch.zeros(plan.chunks - 1, plan.rows,
                                     dtype=torch.float64), vc, tri.lo_offs, s)
    want = torch.einsum("ck,ckj->cj", s, plan.t)
    assert float((exits - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


def test_plan_follows_the_shape():
    """P from n and the tail: one chunk where n is no longer than the
    tail, more chunks as n grows, each chunk at least tb long, the tail the
    largest offset rounded up to whole 16-byte rows; no tail, no transfer
    matrices."""
    assert tbt.diag_chunk_shape(100, 100, "cuda") == (100, 1)
    rows, p = tbt.diag_chunk_shape(1_000_000, 100, "cuda")
    assert 16 <= p <= tbt.H100_SMS + 1 and rows >= 100
    assert -(-1_000_000 // rows) == p
    assert tbt.diag_chunk_shape(10 ** 9, 100, "cuda")[1] == \
        tbt.H100_SMS + 1   # a block of the carry per SM at most
    assert tbt.diag_chunk_shape(10_000, 100, "cuda")[1] < p
    rows16, p16 = tbt.diag_chunk_shape(16_000_000, 100, "cuda")
    assert p16 > p and rows16 > rows
    assert tbt.diag_chunk_shape(10_000, 100, "cpu")[0] >= 100
    a = _matrix("mat900")
    tri32, _ = _solvers("mat900", torch.float32)
    assert tri32.plan_lo.tb == 32 and tri32.plan_up.tb == 32   # 31 → 32
    diag_only = offset_matrix(50, (), ())
    t = tbt.DiagTriSolver.from_factor(diag_only, ilu0_factorize(diag_only),
                                      dtype=torch.float64, device="cpu")
    assert t.plan_lo.tb == 0 and t.plan_lo.t.numel() == 0
    f = torch.arange(1.0, 51.0, dtype=torch.float64)
    assert torch.equal(t.solve_lower(f), f)
    np.testing.assert_allclose(t.msolve(f).numpy(),
                               f.numpy() / diag_only.diagonal(), rtol=1e-15)
    assert a.n == 900


@pytest.mark.parametrize("count,route", [(tbt.DIAG_MAX_OFFSETS, "diag"),
                                         (tbt.DIAG_MAX_OFFSETS + 1, "dense")])
@pytest.mark.parametrize("side", ["lower", "upper"])
def test_route_rule_at_its_edge(count, route, side):
    """K offsets in a triangle take the diagonal-form route, K + 1 the
    dense one; either way the msolve is the factor's."""
    dists = tuple(range(3 * count, 0, -3))
    few = (1, 5)
    lower, upper = (dists, few) if side == "lower" else (few, dists)
    a = offset_matrix(400, lower, upper)
    assert tbt.diag_route_fits(a, 128) == (route == "diag")
    pre = tpre.ILU0Preconditioner.from_csr(a, block=128, device="cpu")
    assert pre.route == route
    m = ilu0_factorize(a)
    f = np.random.default_rng(3).standard_normal(a.n)
    want = sequential_solve(a, m, sequential_solve(a, m, f, True), False)
    _close(pre.msolve(torch.from_numpy(f)), want, torch.float64)


def test_route_rule_band_wider_than_block():
    """A band wider than the block takes the level-scheduled solver, few
    offsets or not."""
    a = _matrix("mat900")
    assert not tbt.diag_route_fits(a, 16)
    assert tpre.ILU0Preconditioner.from_csr(a, block=16,
                                            device="cpu").route == "levels"
    with pytest.raises(ValueError, match="offsets"):
        tbt.DiagTriSolver.from_factor(a, ilu0_factorize(a), block=16,
                                      device="cpu")


def test_front_ends_reject_bad_operands():
    tri, _ = _solvers("grid97x13", torch.float64)
    f = torch.zeros(tri.n, dtype=torch.float64)
    plan = tri.plan_lo
    with pytest.raises(ValueError, match="values"):
        tbt.diag_sweep(f[:-1], tri.lo_vals, tri.lo_offs, None, plan, True)
    with pytest.raises(ValueError, match="offsets"):
        tbt.diag_sweep(f, tri.lo_vals, tri.lo_offs[::-1], None, plan, True)
    with pytest.raises(ValueError, match="diagonal"):
        tbt.diag_sweep(f, tri.up_vals, tri.up_offs, None, tri.plan_up,
                       False)
    with pytest.raises(ValueError, match="plan"):
        tbt.diag_sweep(f, tri.lo_vals, tri.lo_offs, None, None, True)
