"""The prepared solver's host boundary (``solvers/bicgstab._Staging``) on
the CPU, where it stages through plain host tensors:

- the default x0, made on the device in the operator's layout, gives
  bitwise the answer, count and history of an explicit ``x0 = ones`` on
  the padded stencil and DIA operators, an unpadded one, a device operator
  in place of the matrix and under ``reorder="rcm"``;
- an f64 b into an f32 solver is cast after the upload to the bits of
  the host cast;
- the answer a solve returns is the caller's: a later solve leaves it as
  it was, and the staging buffers are made once and reused; an answer's
  memory serves a later answer only once no array views it;
- a solve's record counts the bytes of the vectors that crossed (b and a
  caller's x0 up, x down), by ``make_solver``, ``bicgstab_split`` and
  ``bicg`` alike;
- ``bicgstab_split`` and ``bicg`` give bitwise the answer, count and
  history of their loops (``hform_core``, ``bicg_core``) called directly
  on the same device vectors;
- solves of one solver from several threads take turns at the staging
  buffers and run their loops side by side: each gets the answer it would
  get alone;
- a b of the wrong shape raises ValueError, as before.
"""

import importlib
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.formats.reorder import permute_csr
from cuda_mat_tpu_torch.models.problems import grid_laplacian, split_form
from cuda_mat_tpu_torch.ops.dia_spmv import PallasDIAOperator
from cuda_mat_tpu_torch.ops.operators import (CSROperator, SplitOperator,
                                              make_operator)
from cuda_mat_tpu_torch.ops.stencil import ConstStencilOperator
from cuda_mat_tpu_torch.ops.stencil2d import StencilOperator2D
from cuda_mat_tpu_torch.solvers.bicg import bicg_core
from cuda_mat_tpu_torch.utils import timing

torch.set_num_threads(1)
bs = importlib.import_module("cuda_mat_tpu_torch.solvers.bicgstab")

NEUMANN = ct.SolverConfig(precond="ilu0_neumann", milu_omega=0.96,
                          neumann_terms=4, tol=1e-4, dtype="float32",
                          true_residual=False)
ILU64 = ct.SolverConfig(precond="ilu0", dtype="float64", tol=1e-6,
                        trisolve_block=32)


def _shuffled(r, c, seed=5):
    a = grid_laplacian(r, c)
    return permute_csr(a, np.random.default_rng(seed).permutation(a.n))


# name: (matrix, config, format, the operator's type)
CASES = {
    "stencil": (lambda: grid_laplacian(24, 16), NEUMANN, None,
                ConstStencilOperator),
    "pallas_dia": (lambda: grid_laplacian(24, 16),
                   ILU64.replace(precond="jacobi"), "pallas_dia",
                   PallasDIAOperator),
    "csr": (lambda: grid_laplacian(24, 16), ILU64, "csr", CSROperator),
    "rcm": (lambda: _shuffled(20, 12), ILU64.replace(reorder="rcm"), None,
            None),
    "stencil2d": (lambda: StencilOperator2D.laplacian(
        20, 12, dtype=torch.float64, tr=8, tc=16, device="cpu"),
        ILU64.replace(precond="none"), None, StencilOperator2D),
}


def _solver(case):
    make, cfg, fmt, kind = CASES[case]
    ps = ct.make_solver(make(), cfg, format=fmt, device="cpu")
    if kind is not None:
        assert type(ps.op) is kind
    return ps


def _b(n, seed=3, dtype=np.float64):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, n).astype(dtype)


def _same(r, s):
    assert r.iters == s.iters and r.status == s.status
    assert r.x.dtype == s.x.dtype
    assert r.x.tobytes() == s.x.tobytes()
    assert r.residual_history.tobytes() == s.residual_history.tobytes()
    assert (r.residual, r.residual0) == (s.residual, s.residual0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_default_x0_is_an_explicit_ones(case):
    ps = _solver(case)
    b = _b(ps.n)
    default = ps.solve(b)
    assert default.iters > 0
    _same(default, ps.solve(b, x0=np.ones(ps.n)))


@pytest.mark.parametrize("cfg,fmt", [(NEUMANN, None),
                                     (ILU64.replace(dtype="float32"), "csr")])
def test_an_f64_b_is_cast_to_the_host_casts_bits(cfg, fmt):
    ps = ct.make_solver(grid_laplacian(24, 16), cfg, format=fmt,
                        device="cpu")
    b = _b(ps.n)
    bd = ps._prep_vec("b", b)
    assert bd.dtype == torch.float32
    assert torch.equal(bd, ps.op.pad_vec(b))        # cast on the host
    _same(ps.solve(b), ps.solve(b.astype(np.float32)))


@pytest.mark.parametrize("threaded", [False, True])
@pytest.mark.parametrize("explicit_x0", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_an_answer_outlives_the_next_solve(case, explicit_x0, threaded,
                                           monkeypatch):
    if threaded:        # the host copies of a large vector, at a small one
        monkeypatch.setattr(bs, "_THREADED_BYTES", 0)
    ps = _solver(case)
    x0 = np.ones(ps.n) if explicit_x0 else None
    first = ps.solve(_b(ps.n, 1), x0=x0)
    kept = (first.x.copy(), first.residual_history.copy())
    host = dict(ps._staging._host)
    second = ps.solve(_b(ps.n, 2), x0=x0)
    assert not np.array_equal(first.x, second.x)
    np.testing.assert_array_equal(first.x, kept[0])
    np.testing.assert_array_equal(first.residual_history, kept[1])
    # the buffers are made once and reused
    assert all(ps._staging._host[k] is v for k, v in host.items())
    assert not np.shares_memory(second.x, ps._staging._host["x"].numpy())


@pytest.mark.parametrize("keep_a_view", [False, True])
@pytest.mark.parametrize("case", ["stencil", "csr"])
def test_an_answers_memory_serves_again_only_once_unused(case, keep_a_view):
    ps = _solver(case)
    first = ps.solve(_b(ps.n, 1))
    addr, kept = first.x.ctypes.data, first.x.copy()
    view = first.x[3:].reshape(-1, 1) if keep_a_view else None
    del first
    second = ps.solve(_b(ps.n, 2))
    assert (second.x.ctypes.data == addr) is not keep_a_view
    if keep_a_view:
        np.testing.assert_array_equal(view[:, 0], kept[3:])


@pytest.mark.parametrize("entry,b_dtype,explicit_x0", [
    pytest.param("make_solver", np.float32, False, id="float32-False"),
    pytest.param("make_solver", np.float32, True, id="float32-True"),
    pytest.param("make_solver", np.float64, False, id="float64-False"),
    ("bicgstab_split", np.float64, False),
    ("bicgstab_split", np.float32, True),
    ("bicg", np.float64, False)])
def test_a_solve_counts_the_bytes_that_cross(entry, b_dtype, explicit_x0):
    a = grid_laplacian(24, 16)
    n = a.n
    b = _b(n, dtype=b_dtype)
    x0 = np.ones(n, np.float32) if explicit_x0 else None
    if entry == "make_solver":
        _solver("stencil").solve(b, x0=x0)
    elif entry == "bicgstab_split":
        a0, d = split_form(a)
        ct.bicgstab_split(a0, d, x0, b, NEUMANN, device="cpu")
    else:
        ct.bicg(a, b, NEUMANN, device="cpu")
    rec = timing.records()[-1]
    assert rec.kind == "solve"
    item = np.dtype(b_dtype).itemsize
    assert rec.h2d_bytes == n * item + (n * 4 if explicit_x0 else 0)
    assert rec.d2h_bytes == n * 4


@pytest.mark.parametrize("entry", ["bicgstab_split", "bicg"])
def test_an_entry_point_gives_the_bits_of_its_loop(entry):
    a = grid_laplacian(24, 16)
    b = _b(a.n)
    cfg = ILU64.replace(precond="none")
    if entry == "bicgstab_split":
        a0, d = split_form(a)
        x0 = _b(a.n, seed=7)
        res = ct.bicgstab_split(a0, d, x0, b, cfg, device="cpu")
        op = bs._as_op(a0, torch.float64, torch.device("cpu"))
        split = SplitOperator(op, op.pad_vec(d))
        out = bs.hform_core(split.matvec, torch.dot, op.pad_vec(x0),
                            op.pad_vec(b), cfg.tol, cfg.breakdown_tol,
                            cfg.maxit)
    else:
        res = ct.bicg(a, b, cfg, device="cpu")
        op = make_operator(a, dtype=torch.float64, device="cpu")
        op_t = make_operator(a.transpose(), dtype=torch.float64,
                             device="cpu")
        out = bicg_core(op.matvec, op_t.matvec, op.pad_vec(b), cfg.tol,
                        cfg.maxit)
    x, status, iters, nrmr, nrmr0, hist = out
    assert res.iters == int(iters) > 0 and int(res.status) == int(status)
    assert res.x.tobytes() == op.unpad_vec(x).numpy().tobytes()
    assert res.residual_history.tobytes() == hist.numpy().tobytes()
    assert (res.residual, res.residual0) == (float(nrmr), float(nrmr0))


@pytest.mark.parametrize("b", [np.ones(10), np.ones((24 * 16, 1)),
                               np.ones(24 * 16 + 1)])
def test_a_b_of_the_wrong_shape_still_raises(b):
    ps = _solver("stencil")
    with pytest.raises(ValueError, match="b must be a vector of length"):
        ps.solve(b)


def test_solves_from_several_threads_each_get_their_own_answer():
    ps = _solver("csr")
    rhs = [_b(ps.n, k) for k in range(12)]
    want = [ps.solve(b).x for b in rhs]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(12) as pool:
            futures = [pool.submit(lambda b: ps.solve(b).x, b) for b in rhs]
            got = [f.result(timeout=300) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
