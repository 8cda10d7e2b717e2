"""The Neumann-series ILU(0) with exact factors on banded DIA operators
(kernel B3) — on the stencil layout (``neumann_const_factors=False``: A on
B1, the factors restrided) and on ``format="pallas_dia"`` (A and the
factors on B3) — against the JAX package's ``make_solver`` on
grid_laplacian(40, 126) in f64, as in ``tests/test_neumann.py``.

Tolerances: the msolve takes the same products and sums in the same order
(XLA may contract some into FMAs), within 1e-12 of max|y|; the solves part
at the last bits, so their iteration counts agree within ±2 (f64).  Both of
the port's solves are held against the JAX package's stencil-layout solve:
restriding only relabels rows, so both formats apply the same
preconditioner, and the JAX package's DIA solve runs its kernel in
interpret mode at ~0.2 s per iteration.
"""

import functools

import numpy as np
import pytest
import torch

import cuda_mat_tpu as cm
import cuda_mat_tpu.models.problems as jprob
from cuda_mat_tpu.formats.coo import COOMatrix as JCOOMatrix

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.formats.coo import COOMatrix as TCOOMatrix
from cuda_mat_tpu_torch.ops import dia_spmv as tds
from cuda_mat_tpu_torch.ops import stencil as tst
from cuda_mat_tpu_torch.precond import preconditioners as tpre

torch.set_num_threads(1)

GRID = (40, 126)
FORMATS = ["stencil", "pallas_dia"]


def _config(pkg, const_factors=False):
    return pkg.SolverConfig(maxit=2000, tol=1e-8, dtype="float64",
                            precond="ilu0_neumann", neumann_terms=3,
                            neumann_const_factors=const_factors)


def _solvers(fmt, const_factors=False):
    ps_j = cm.make_solver(jprob.grid_laplacian(*GRID),
                          _config(cm, const_factors), format=fmt)
    ps_t = ct.make_solver(ct.grid_laplacian(*GRID),
                          _config(ct, const_factors), format=fmt,
                          device="cpu")
    return ps_j, ps_t


@pytest.fixture(scope="module", params=FORMATS)
def solvers(request):
    return request.param, _solvers(request.param)


def _layout(op):
    return tuple(getattr(op, k) for k in ("n", "npad", "block", "sub"))


def test_exact_factor_msolve_matches_jax(solvers):
    _, (ps_j, ps_t) = solvers
    pre = ps_t.pre
    assert pre.fused is False and pre.terms == 3
    assert isinstance(pre.nl, tds.PallasDIAOperator)
    assert isinstance(pre.nu, tds.PallasDIAOperator)
    assert (pre.nl.offsets, pre.nu.offsets) == (ps_j.pre.nl.offsets,
                                                ps_j.pre.nu.offsets)
    for t, j in ((ps_t.op, ps_j.op), (pre.nl, ps_j.pre.nl),
                 (pre.nu, ps_j.pre.nu)):
        assert _layout(t) == _layout(j)
    x = np.random.default_rng(0).standard_normal(ps_t.n)
    y_t = pre.msolve(ps_t.op.pad_vec(x)).numpy()
    y_j = np.asarray(ps_j.pre.msolve(ps_j.op.pad_vec(x)))
    assert np.abs(y_t - y_j).max() <= 1e-12 * np.abs(y_j).max()
    # the pads and the stencil layout's gap cells stay exact zeros
    assert not np.any(y_t[np.asarray(ps_j.op.pad_vec(np.ones(ps_t.n))) == 0])


@functools.lru_cache(maxsize=1)
def _jax_reference(b_seed=0):
    ps_j = cm.make_solver(jprob.grid_laplacian(*GRID), _config(cm),
                          format="stencil")
    b = np.random.default_rng(b_seed).uniform(1.0, 5.0, ps_j.n)
    return b, ps_j.solve(b)


def test_exact_factor_solve_matches_jax(solvers, monkeypatch):
    """Both packages' solves, and which twins carried the port's: per
    iteration 2 A-matvecs (B1 on the stencil, B3 on DIA) and 2 msolves of
    2(k−1) = 4 factor matvecs each on B3, B2 never."""
    fmt, (_, ps_t) = solvers
    b, rj = _jax_reference()
    calls = {"b1": 0, "b2": 0, "b3": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tds, "dia_spmv_block_padded_plain",
                        spy("b3", tds.dia_spmv_block_padded_plain))
    monkeypatch.setattr(tst, "const_stencil_spmv_padded_plain",
                        spy("b1", tst.const_stencil_spmv_padded_plain))
    monkeypatch.setattr(tst, "const_series_msolve_padded_plain",
                        spy("b2", tst.const_series_msolve_padded_plain))
    rt = ps_t.solve(b)
    assert rt.converged and rj.converged
    assert abs(rt.iters - rj.iters) <= 2
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) < 1e-7
    assert rt.residual_true / np.linalg.norm(b) < 1e-7
    a_calls = 2 * rt.iters + 1
    want = {"stencil": {"b1": a_calls, "b2": 0, "b3": 8 * rt.iters},
            "pallas_dia": {"b1": 0, "b2": 0,
                           "b3": a_calls + 8 * rt.iters}}[fmt]
    assert calls == want


def test_replan_only_for_constant_factors():
    """The stencil layout is re-planned for the fused series only with
    constant factors, as in the JAX package: the exact factors keep the
    first layout (and the two layouts differ on this grid)."""
    layouts = {}
    for const in (False, True):
        ps_j, ps_t = _solvers("stencil", const)
        layouts[const] = _layout(ps_t.op) + (ps_t.op.stride,)
        assert layouts[const] == _layout(ps_j.op) + (ps_j.op.stride,)
    assert layouts[False] != layouts[True]


def _asymmetric_band(csr_cls, coo_cls, n=8000):
    """Diagonally dominant, lower bandwidth 3000, upper 1500: A's layout
    has sub 3072 and block 33792, which the upper factor's sub 2048 does
    not divide."""
    i = np.arange(n)
    rows, cols, vals = [i], [i], [np.full(n, 4.0)]
    for off in (-3000, -1, 1, 1500):
        r = i[(i + off >= 0) & (i + off < n)]
        rows, cols, vals = rows + [r], cols + [r + off], vals + [
            np.full(r.shape[0], -0.5)]
    return csr_cls.from_coo(coo_cls(
        n, n, np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals)))


def test_factor_layout_mismatch_raises():
    """Factors whose DIA layout differs from the operator's cannot share
    its padded vectors: ValueError from the preconditioner, where the JAX
    package's solver falls back to unpadded operators; the port's solver
    raises NotImplementedError naming that ROADMAP item."""
    a = _asymmetric_band(ct.CSRMatrix, TCOOMatrix)
    op = tds.PallasDIAOperator.from_dia(a.to_dia(), dtype=torch.float64,
                                        device="cpu")
    assert (op.sub, op.block) == (3072, 33792)
    with pytest.raises(ValueError, match="padding"):
        tpre.NeumannILUPreconditioner.from_csr(a, pad_like=op)
    cfg = dict(maxit=2000, tol=1e-8, precond="ilu0_neumann")
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        ct.make_solver(a, ct.SolverConfig(**cfg), format="pallas_dia",
                       device="cpu")
    ps_j = cm.make_solver(_asymmetric_band(cm.CSRMatrix, JCOOMatrix),
                          cm.SolverConfig(**cfg),
                          format="pallas_dia")
    assert not hasattr(ps_j.op, "pad_vec")
