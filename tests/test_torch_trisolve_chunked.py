"""The chunked sweep of kernel B4b (``banded_sweep_chunked_plain``, the
kernel's three phases in PyTorch) and its plan (``sweep_plan``), against the
sequential twin ``banded_sweep_padded_plain`` and the JAX package's Pallas
kernels ``_banded_sweep`` / ``_fused_msolve`` in interpret mode, as
tests/test_pallas_trisolve.py runs them.

The chunked sweep reorders only the additions of the recurrence (the tail
entering a chunk comes through its transfer matrix), so it agrees to
rounding: 1e-12 of max|y| in f64, 1e-5 in f32, as in
tests/test_torch_trisolve.py.
Chunk lengths m: 1, 3 (not a divisor of nb), nb and more than nb (one
chunk, the plain sequential chain).
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from cuda_mat_tpu.ops.pallas_trisolve import (PallasBandedTriSolver,
                                              _banded_sweep, _fused_msolve)
from cuda_mat_tpu.reference.cpu_solvers import ilu0_factorize

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.models.problems as tprob
from cuda_mat_tpu_torch.convert import banded_trisolver_from_numpy
from cuda_mat_tpu_torch.ops import banded_trisolve as tbt

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's block inverses in ILU(0) setups: with
    the test workers sharing the cores, OpenBLAS's spinning threads slow
    them a hundredfold."""
    with threadpool_limits(1):
        yield


DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
# tests/test_torch_trisolve.py's CASES, and the 2-D grid at the 1M layout's
# width and block (20,000 rows, nb = 160)
CASES = [("lap12", 16), ("lap12", 64), ("lap11", 32), ("mat900", 64),
         ("grid200", 128)]
CHUNKS = ["1", "3", "nb", "beyond"]
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _matrix(name):
    if name == "mat900":
        return ct.load_mm_sparse_matrix(os.path.join(DATA, "mat900.mtx"))
    if name == "grid200":
        return tprob.grid_laplacian(200, 100)
    return tprob.banded_laplacian(int(name[3:]))


@functools.lru_cache(maxsize=None)
def _pair(name, block, dtype):
    """The port's and the JAX package's solver on the same ILU(0) factor,
    a padded input and the JAX kernels' sweeps and msolve of it."""
    a = _matrix(name)
    m = ilu0_factorize(a)
    tri_t = tbt.BandedTriSolver.from_factor(a, m, block=block, dtype=dtype,
                                            device="cpu")
    tri_j = PallasBandedTriSolver.from_factor(a, m, block=block,
                                              dtype=JNP[dtype],
                                              interpret=True)
    f = np.zeros(tri_t.npad)
    f[:a.n] = np.random.default_rng(5).standard_normal(a.n)
    f_j = jnp.asarray(f, JNP[dtype])
    jax_out = {
        fw: np.asarray(_banded_sweep(f_j, getattr(tri_j, wt),
                                     getattr(tri_j, wct), block, fw,
                                     tri_j.unroll, True))
        for fw, wt, wct in ((True, "wt_lo", "wct_lo"),
                            (False, "wt_up", "wct_up"))}
    jax_out["msolve"] = np.asarray(_fused_msolve(
        f_j, tri_j.wt_lo, tri_j.wct_lo, tri_j.wt_up, tri_j.wct_up, block,
        tri_j.unroll, True))
    return a, tri_t, tri_j, torch.from_numpy(f).to(dtype), jax_out


def _csr_from_dense(d):
    rows, cols = np.nonzero(d)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                        minlength=len(d)))])
    return ct.CSRMatrix(len(d), len(d), d[rows, cols], cols, indptr)


def _band_sides(a):
    """max(row − col) and max(col − row) over ``a``'s entries."""
    offs = a.indices.astype(np.int64) - np.repeat(np.arange(a.n),
                                                  a.row_lengths)
    return max(-int(offs.min()), 0), max(int(offs.max()), 0)


def _carry_width(side, block, dtype):
    """A plan's bw: the band side rounded up to whole 16-byte rows, at most
    the block."""
    per16 = 16 // torch.empty(0, dtype=dtype).element_size()
    return min(block, -(-side // per16) * per16)


def _m(which, nb):
    return {"1": 1, "3": 3, "nb": nb, "beyond": nb + 7}[which]


def _close(got, want, dtype):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("which", CHUNKS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,block", CASES)
def test_chunked_sweep_matches_twin_and_pallas(name, block, dtype, which):
    """Both sweeps and the msolve (forward chunked sweep, then backward)
    against the sequential twin and the Pallas kernels; pad rows stay 0."""
    a, tri, _, f, jax_out = _pair(name, block, dtype)
    nb = tri.wt_lo.shape[0]
    plans = {}
    for fw, wt, wct in ((True, tri.wt_lo, tri.wct_lo),
                        (False, tri.wt_up, tri.wct_up)):
        plan = plans[fw] = tbt.sweep_plan(wt, wct, fw, _m(which, nb))
        assert plan.chunks == -(-nb // plan.m)
        y = tbt.banded_sweep_chunked_plain(f, wt, wct, plan, fw)
        _close(y, tbt.banded_sweep_padded_plain(f, wt, wct, fw), dtype)
        _close(y, jax_out[fw], dtype)
        assert not y[a.n:].any()
    y = tbt.banded_sweep_chunked_plain(f, tri.wt_lo, tri.wct_lo, plans[True],
                                       True)
    x = tbt.banded_sweep_chunked_plain(y, tri.wt_up, tri.wct_up,
                                       plans[False], False)
    _close(x, jax_out["msolve"], dtype)
    assert not x[a.n:].any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,block", CASES)
def test_plan_reads_the_factor(name, block, dtype):
    """Bandwidths, triangles and the default chunking of an ILU(0) factor:
    the carry rows are the last bw forward and the first bw backward (the
    band sides in whole 16-byte rows), each Wt[b] is triangular, and all
    other rows of WCt are zero."""
    _, tri, _, _, _ = _pair(name, block, dtype)
    nb = tri.wt_lo.shape[0]
    lo, up = tri.plan_lo, tri.plan_up
    assert (lo.bw, up.bw) == tuple(_carry_width(w, block, dtype)
                                   for w in _band_sides(_matrix(name)))
    assert (lo.tri, up.tri) == (1, 2)
    assert lo.m == up.m == -(-nb // min(nb, tbt.H100_SMS))
    assert not tri.wct_lo[:, :block - lo.bw].any()
    assert not tri.wct_up[:, up.bw:].any()
    assert lo.t.shape == (lo.chunks, lo.bw, lo.bw)
    assert lo.t.dtype == dtype


@pytest.mark.parametrize("nb,m,chunks", [(1, 1, 1), (80, 1, 80),
                                         (132, 1, 132), (133, 2, 67),
                                         (7816, 60, 131)])
def test_default_chunking(nb, m, chunks):
    """P₀ = min(nb, 132) chunks, m = ⌈nb / P₀⌉, P = ⌈nb / m⌉ off the card
    (7816: the 1M-row layout at B = 128)."""
    w = torch.zeros(nb, 1, 1)
    plan = tbt.sweep_plan(w, w, True)
    assert (plan.m, plan.chunks, plan.bw) == (m, chunks, 0)


def _rotation_factor(nb, block, bw, dtype, seed):
    """Synthetic sweep arrays whose carry does not decay: each Wt[b] upper
    triangular (a forward sweep's), each WCt[b]'s carry block an orthogonal
    matrix, so every transfer matrix has 2-norm 1."""
    rng = np.random.default_rng(seed)
    wt = np.triu(rng.uniform(-1.0, 1.0, (nb, block, block)))
    wct = np.zeros((nb, block, block))
    for b in range(nb):
        q, _ = np.linalg.qr(rng.standard_normal((bw, bw)))
        wct[b, block - bw:, block - bw:] = q
    return (torch.from_numpy(wt).to(dtype), torch.from_numpy(wct).to(dtype),
            torch.from_numpy(rng.standard_normal(nb * block)).to(dtype))


@pytest.mark.parametrize("which", CHUNKS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_exact_without_decay(dtype, which):
    """A carry that never shrinks (orthogonal carry blocks): the chunked
    sweep still gives the sequential result to rounding, and its transfer
    matrices keep norm 1 (no cut-off could drop them)."""
    nb, block, bw = 50, 16, 6
    wt, wct, f = _rotation_factor(nb, block, bw, dtype, 7)
    plan = tbt.sweep_plan(wt, wct, True, _m(which, nb))
    assert (plan.bw, plan.tri) == (_carry_width(bw, block, dtype), 1)
    norms = torch.linalg.matrix_norm(plan.t.double(), ord=2)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    _close(tbt.banded_sweep_chunked_plain(f, wt, wct, plan, True),
           tbt.banded_sweep_padded_plain(f, wt, wct, True), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_exact_on_the_1d_laplacian(dtype):
    """The tridiagonal 1-D Laplacian tridiag(−1, 2, −1), whose ILU(0) is
    its exact LU (bw = 1, carried as one 16-byte row): the carry across a
    block of 16 stays near 1 (the factors' couplings tend to −1), and the
    chunked sweeps match the twin and the JAX kernels."""
    n = 1000
    a = _csr_from_dense(2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1))
    m = ilu0_factorize(a)
    tri = tbt.BandedTriSolver.from_factor(a, m, block=16, dtype=dtype,
                                          device="cpu")
    tri_j = PallasBandedTriSolver.from_factor(a, m, block=16,
                                              dtype=JNP[dtype],
                                              interpret=True)
    nb = tri.wt_lo.shape[0]
    f = tri._pad(torch.from_numpy(np.random.default_rng(2).standard_normal(
        a.n)).to(dtype))
    f_j = jnp.asarray(f.numpy())
    for fw, wt, wct in ((True, tri.wt_lo, tri.wct_lo),
                        (False, tri.wt_up, tri.wct_up)):
        one = tbt.sweep_plan(wt, wct, fw, 1)
        corner = -1 if fw else 0   # the one carry row that is not zero
        assert one.bw == _carry_width(1, 16, dtype)
        assert float(one.t[:, corner, corner].abs().median()) > 0.9
        for m in (1, 3, nb):
            plan = tbt.sweep_plan(wt, wct, fw, m)
            y = tbt.banded_sweep_chunked_plain(f, wt, wct, plan, fw)
            _close(y, tbt.banded_sweep_padded_plain(f, wt, wct, fw), dtype)
            _close(y, _banded_sweep(
                f_j, tri_j.wt_lo if fw else tri_j.wt_up,
                tri_j.wct_lo if fw else tri_j.wct_up, 16, fw, tri_j.unroll,
                True), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_diagonal_factor_has_no_chain(dtype):
    """A diagonal matrix: bw = 0 both ways, empty transfer matrices, and
    the chunked sweep is the GEMV alone, equal to the twin."""
    n = 100
    a = _csr_from_dense(np.diag(np.arange(1.0, n + 1)))
    tri = tbt.BandedTriSolver.from_factor(a, ilu0_factorize(a), block=16,
                                          dtype=dtype, device="cpu")
    f = tri._pad(torch.from_numpy(np.random.default_rng(4).standard_normal(
        n)).to(dtype))
    for fw, wt, wct, plan in ((True, tri.wt_lo, tri.wct_lo, tri.plan_lo),
                              (False, tri.wt_up, tri.wct_up, tri.plan_up)):
        assert plan.bw == 0 and plan.t.shape[1:] == (0, 0)
        for m in (1, 3, None):
            y = tbt.banded_sweep_chunked_plain(
                f, wt, wct, tbt.sweep_plan(wt, wct, fw, m), fw)
            assert torch.equal(y, tbt.banded_sweep_padded_plain(f, wt, wct,
                                                                fw))
    x = tri.msolve(f[:n])
    np.testing.assert_allclose(x.numpy(), f[:n].numpy() / np.arange(
        1.0, n + 1), rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_carried_solver_has_the_same_plan(dtype):
    """The JAX solver's arrays carried over by convert.py give the plans
    ``from_factor`` gives: bandwidths, triangles, m and T bitwise."""
    _, tri_t, tri_j, _, _ = _pair("grid200", 128, dtype)
    fields = {f: np.asarray(getattr(tri_j, f))
              for f in ("wt_lo", "wct_lo", "wt_up", "wct_up")}
    fields.update(n=tri_j.n, block=tri_j.block, unroll=tri_j.unroll)
    tri_c = banded_trisolver_from_numpy(fields, "cpu")
    for got, want in ((tri_c.plan_lo, tri_t.plan_lo),
                      (tri_c.plan_up, tri_t.plan_up)):
        assert (got.bw, got.tri, got.m, got.chunks) == \
            (want.bw, want.tri, want.m, want.chunks)
        assert torch.equal(got.t, want.t)
