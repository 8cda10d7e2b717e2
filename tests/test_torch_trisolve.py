"""Kernels B4a/B4b (exact banded ILU(0) triangular solves) of the PyTorch
port against the JAX package's ``PallasBandedTriSolver`` and its Pallas
kernels, run in interpret mode on the CPU as tests/test_pallas_trisolve.py
runs them, and against the sequential numpy oracle.

The host setup is the same numpy code in both packages, so the block arrays
are compared bitwise.  The sweeps are not: the port's twin multiplies with
torch.matmul and the JAX kernel with XLA's dot, which sum in different
orders.  Tolerance: 1e-12 of max|y| in f64, 1e-5 of max|y| in f32.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from cuda_mat_tpu.ops.pallas_trisolve import (PallasBandedTriSolver,
                                              _banded_sweep, _fused_msolve)
from cuda_mat_tpu.reference.cpu_solvers import (ilu0_factorize,
                                                solve_lower_unit, solve_upper)

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
# (matrix, block): as tests/test_pallas_trisolve.py — n=144 at B=16 and 64,
# n=121 at B=32 (the block does not divide n), mat900 at B=64
CASES = [("lap12", 16), ("lap12", 64), ("lap11", 32), ("mat900", 64)]
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _matrix(name):
    if name == "mat900":
        return ct.load_mm_sparse_matrix(os.path.join(DATA, "mat900.mtx"))
    return tprob.banded_laplacian(int(name[3:]))


def _pair(name, block, dtype):
    """The port's and the JAX package's solver on the same ILU(0) factor."""
    a = _matrix(name)
    m = ilu0_factorize(a)
    tri_t = tbt.BandedTriSolver.from_factor(a, m, block=block, dtype=dtype,
                                            device="cpu")
    tri_j = PallasBandedTriSolver.from_factor(a, m, block=block,
                                              dtype=JNP[dtype],
                                              interpret=True)
    return a, m, tri_t, tri_j


def _close(got, want, dtype):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,block", CASES)
def test_arrays_equal_jax_bitwise(name, block, dtype):
    _, _, tri_t, tri_j = _pair(name, block, dtype)
    assert (tri_t.n, tri_t.block, tri_t.unroll, tri_t.npad) == \
        (tri_j.n, tri_j.block, tri_j.unroll, tri_j.npad)
    for f in ("wt_lo", "wct_lo", "wt_up", "wct_up"):
        assert np.array_equal(getattr(tri_t, f).numpy(),
                              np.asarray(getattr(tri_j, f))), f


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,block", CASES)
def test_twins_match_pallas_kernels(name, block, dtype):
    """Sweep forward, sweep backward and the fused msolve, each against
    its Pallas kernel on the same padded input; pad rows stay exact 0."""
    a, _, tri_t, tri_j = _pair(name, block, dtype)
    f = np.zeros(tri_t.npad)
    f[:a.n] = np.random.default_rng(5).standard_normal(a.n)
    f_t = torch.from_numpy(f).to(dtype)
    f_j = jnp.asarray(f, JNP[dtype])
    for forward, (wt, wct) in ((True, ("wt_lo", "wct_lo")),
                               (False, ("wt_up", "wct_up"))):
        y_t = tbt.banded_sweep_padded(f_t, getattr(tri_t, wt),
                                      getattr(tri_t, wct), forward).numpy()
        y_j = _banded_sweep(f_j, getattr(tri_j, wt), getattr(tri_j, wct),
                            block, forward, tri_j.unroll, True)
        _close(y_t, y_j, dtype)
        assert not y_t[a.n:].any()
    x_t = tbt.fused_msolve_padded(f_t, tri_t.wt_lo, tri_t.wct_lo,
                                  tri_t.wt_up, tri_t.wct_up).numpy()
    x_j = _fused_msolve(f_j, tri_j.wt_lo, tri_j.wct_lo, tri_j.wt_up,
                        tri_j.wct_up, block, tri_j.unroll, True)
    _close(x_t, x_j, dtype)
    assert not x_t[a.n:].any()


@pytest.mark.parametrize("name,block", CASES)
def test_solves_match_oracle(name, block):
    """True-n solves against the sequential numpy triangular solves, and
    the msolve equal to its two sweeps."""
    a, m, tri, _ = _pair(name, block, torch.float64)
    f = np.random.default_rng(42).standard_normal(a.n)
    y_ref = solve_lower_unit(a, m, f)
    x_ref = solve_upper(a, m, y_ref)
    ft = torch.from_numpy(f)
    _close(tri.solve_lower(ft).numpy(), y_ref, torch.float64)
    _close(tri.solve_upper(torch.from_numpy(y_ref)).numpy(), x_ref,
           torch.float64)
    x = tri.msolve(ft)
    _close(x.numpy(), x_ref, torch.float64)
    assert torch.equal(tri.solve_upper(tri.solve_lower(ft)), x)


def test_rejects_band_wider_than_block():
    a = _matrix("mat900")
    m = ilu0_factorize(a)
    with pytest.raises(ValueError, match="bandwidth 31 exceeds block 16"):
        tbt.BandedTriSolver.from_factor(a, m, block=16, device="cpu")
    with pytest.raises(ValueError, match="bandwidth 31 exceeds block 16"):
        PallasBandedTriSolver.from_factor(a, m, block=16)


def test_front_ends_reject_bad_operands():
    f = torch.zeros(2 * 2048)
    w = torch.zeros(1).expand(2, 2048, 2048)
    with pytest.raises(ValueError, match="one thread per column"):
        tbt.banded_sweep_padded(f, w, w, True)
    w = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="length nb\\*B"):
        tbt.fused_msolve_padded(torch.zeros(31), w, w, w, w)
    with pytest.raises(ValueError, match="differ in shape"):
        tbt.banded_sweep_padded(torch.zeros(32), w, torch.zeros(1, 16, 16),
                                True)


def test_carried_arrays_give_the_same_msolve():
    """The JAX solver's arrays carried over by convert.py run the port's
    msolve bitwise as the port's own arrays do (its ``fused`` field is
    ignored: both values compute the same two sweeps)."""
    a, _, tri_t, tri_j = _pair("mat900", 64, torch.float64)
    fields = {f: np.asarray(getattr(tri_j, f))
              for f in ("wt_lo", "wct_lo", "wt_up", "wct_up")}
    fields.update(n=tri_j.n, block=tri_j.block, unroll=tri_j.unroll,
                  fused=tri_j.fused)
    tri_c = banded_trisolver_from_numpy(fields, "cpu")
    f = torch.from_numpy(np.random.default_rng(3).standard_normal(a.n))
    assert tri_c.wt_lo.dtype == torch.float64
    assert torch.equal(tri_c.msolve(f), tri_t.msolve(f))

