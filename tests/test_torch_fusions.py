"""The preconditioned loop's opt-in variants in the PyTorch port against the
JAX package: the twins of kernels B5 (BLAS1-prologue msolve) and B6 (SpMV
with dot products in its epilogue) against the Pallas kernels in interpret
mode, and whole solves with ``fuse_blas1``, ``fused_dots`` and
``check_halves=False``.

Tolerances.  XLA's CPU compile contracts the interpret-mode kernel bodies
into fused multiply-adds, where the twins round every product and sum: so
B5's p agrees to 5e-15 and its y to 1e-12 (the JAX package's own bands for
this kernel, test_neumann.py), not bit for bit.  B6's y is B1's, and B1 on
the Laplacian is exact in both (its coefficients make every product exact),
so y is compared bitwise; the dots are summed in another order (the
kernel's: a halving tree over each 256 rows, then thread t of 256 adds
the partials t, t + 256, ... in turn and a 256-way halving tree adds the
threads' sums, against XLA's lane partials), so to 1e-12 relative.  Whole f64 solves part at the last bits
between the packages' dot orders (test_torch_solver.py): ±2 iterations and
x within 1e-7, on the right-hand side of seed 2.  That window is a property
of the input: on grid_laplacian(40, 126) (k=3, MILU 0.96, tol 1e-8) the
plain loops of the two packages part by up to 3 iterations over the
right-hand sides of seeds 0-4, and with fused_dots by up to 5.  Inside the
port the variants are exact rewrites of the plain loop (``x + (−a)·y``
rounds as ``x − a·y``), so their residual histories are compared bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cuda_mat_tpu as cm
import cuda_mat_tpu.models.problems as jprob
from cuda_mat_tpu.ops import pallas_stencil as jst
from cuda_mat_tpu.precond import preconditioners as jpre

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.models.problems as tprob
from cuda_mat_tpu_torch.convert import (operator_from_numpy,
                                        preconditioner_from_numpy)
from cuda_mat_tpu_torch.ops import stencil as tst

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread while the factors are built: the test workers share
    the cores."""
    with threadpool_limits(1):
        yield


def _carried(r, c, k):
    """The JAX package's planned f64 operator and "kernel"-mode
    preconditioner on grid_laplacian(r, c), and the same state in the
    port."""
    a = jprob.grid_laplacian(r, c)
    dia = a.to_dia(max_diags=16)
    op0 = jst.ConstStencilOperator.from_dia(dia, dtype=jnp.float64,
                                            interpret=True)
    plan = jst.plan_const_neumann_layout(op0.terms, k, op0.c_grid, op0.stride)
    op = jst.ConstStencilOperator.from_dia(
        dia, dtype=jnp.float64, interpret=True, min_sub=plan[0],
        block_target=plan[1])
    pre = jpre.NeumannILUPreconditioner.from_csr(a, dtype=jnp.float64,
                                                 terms=k, pad_like=op)
    assert pre.fused == "kernel" and pre.fma_fits
    fields = {f: getattr(op, f) for f in (
        "terms", "strided_terms", "c_grid", "stride", "n", "np_true", "npad",
        "block", "sub", "vec_dtype")}
    fields["gapmask"] = np.asarray(op.gapmask)
    op_t = operator_from_numpy(fields, "cpu")
    pre_t = preconditioner_from_numpy(dict(
        inv_d=np.asarray(pre.inv_d), gap_ext=np.asarray(pre.gap_ext),
        nl_terms=pre.nl.terms, nl_strided_terms=pre.nl.strided_terms,
        nu_terms=pre.nu.terms, nu_strided_terms=pre.nu.strided_terms,
        terms=k, fused=pre.fused), op_t, "cpu")
    return op, pre, op_t, pre_t


@pytest.mark.parametrize("r,c,k", [(24, 126, 3), (40, 12, 4)])
def test_msolve_fma_twin_matches_pallas(r, c, k):
    op, pre, op_t, pre_t = _carried(r, c, k)
    assert pre_t.fused == "kernel" and pre_t.fma_fits
    rng = np.random.default_rng(3)
    vecs = [rng.standard_normal(op.n) for _ in range(3)]
    av, bv, cv = (op.pad_vec(v) for v in vecs)
    at, bt, ctv = (op_t.pad_vec(v) for v in vecs)
    layout = (pre.nl.strided_terms, pre.nu.strided_terms, op.np_true,
              op.block, op.sub)
    pads = op_t.pad_vec(np.ones(op.n)).numpy() == 0
    for c1, c2 in [(0.73, -1.21), (-0.4, 0.0), (0.0, 5.0)]:
        for three in (True, False):
            args_j = (jnp.float64(c1), bv, jnp.float64(c2) if three else None,
                      cv if three else None, pre.inv_d, pre.gap_ext)
            p_j, y_j = jst.const_series_msolve_fma_padded(
                av, *args_j, *layout, interpret=True)
            c1t = torch.tensor(c1, dtype=torch.float64)
            c2t = torch.tensor(c2, dtype=torch.float64) if three else None
            p_t, y_t = tst.const_series_msolve_fma_padded_plain(
                at, c1t, bt, c2t, ctv if three else None, pre_t.inv_d,
                pre_t.gap_ext, *layout)
            np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j),
                                       rtol=5e-15, atol=5e-15)
            np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                                       rtol=1e-12, atol=1e-12)
            assert not p_t.numpy()[pads].any()
            assert not y_t.numpy()[pads].any()
            # the preconditioner's hook runs the same front end
            p_h, y_h = pre_t.msolve_fma(at, c1t, bt, c2t,
                                        ctv if three else None)
            assert torch.equal(p_h, p_t) and torch.equal(y_h, y_t)
            assert torch.equal(y_t, pre_t.msolve(p_t))


@pytest.mark.parametrize("n_w,with_self", [(1, True), (1, False),
                                           (0, True)])
def test_spmv_dots_twin_matches_pallas(n_w, with_self):
    a_j, a_t = jprob.grid_laplacian(40, 12), tprob.grid_laplacian(40, 12)
    op = jst.ConstStencilOperator.from_dia(a_j.to_dia(max_diags=16),
                                           dtype=jnp.float64, interpret=True)
    op_t = tst.ConstStencilOperator.from_dia(a_t.to_dia(max_diags=16),
                                             dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal(op.n)
    ws = [rng.standard_normal(op.n) for _ in range(n_w)]
    y_j, d_j = op.matvec_dots(op.pad_vec(x), tuple(op.pad_vec(w) for w in ws),
                              with_self=with_self)
    y_t, d_t = op_t.matvec_dots(op_t.pad_vec(x),
                                tuple(op_t.pad_vec(w) for w in ws),
                                with_self=with_self)
    assert torch.equal(y_t, op_t.matvec(op_t.pad_vec(x)))
    assert np.array_equal(y_t.numpy(), np.asarray(y_j))
    assert d_t.shape == (n_w + with_self,)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-12)
    yt = op_t.unpad_vec(y_t).numpy()
    want = [float(w @ yt) for w in ws] + ([float(yt @ yt)] if with_self
                                          else [])
    np.testing.assert_allclose(d_t.numpy(), want, rtol=1e-12)


MATRICES = {"grid40x126": lambda m: m.grid_laplacian(40, 126),
            "lap30": lambda m: m.banded_laplacian(30)}
FLAGS = {"fuse_blas1": {"fuse_blas1": True},
         "fused_dots": {"fused_dots": True},
         "no_check_halves": {"check_halves": False}}
CFG = dict(maxit=2000, tol=1e-8, dtype="float64", precond="ilu0_neumann",
           neumann_terms=3, milu_omega=0.96)


@pytest.mark.parametrize("flag", sorted(FLAGS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_variant_solves_match_jax(name, flag):
    cfg = dict(CFG, **FLAGS[flag])
    ps_j = cm.make_solver(MATRICES[name](jprob), cm.SolverConfig(**cfg),
                          format="stencil")
    ps_t = ct.make_solver(MATRICES[name](tprob), ct.SolverConfig(**cfg),
                          format="stencil", device="cpu")
    assert ps_t.op.block == ps_j.op.block and ps_t.op.sub == ps_j.op.sub
    assert ps_t.pre.fused == ps_j.pre.fused == "kernel"
    assert ps_t.pre.fma_fits and ps_j.pre.fma_fits
    b = np.random.default_rng(2).uniform(1.0, 5.0, ps_t.n)
    rj, rt = ps_j.solve(b), ps_t.solve(b)
    assert rt.status == rj.status == ct.SolverStatus.CONVERGED
    assert abs(rt.iters - rj.iters) <= 2
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-7


def _history(a, **flags):
    ps = ct.make_solver(a, ct.SolverConfig(**dict(CFG, **flags)),
                        device="cpu")
    r = ps.solve(np.random.default_rng(1).uniform(1.0, 5.0, a.n))
    assert r.status == ct.SolverStatus.CONVERGED
    return r.iters, r.residual_history


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_variants_are_exact_rewrites_of_the_loop(name):
    """fuse_blas1 leaves the port's trajectory bit for bit;
    check_halves=False keeps every second-half residual up to the exit and
    leaves the first-half slots at −1."""
    a = MATRICES[name](tprob)
    it, hist = _history(a)
    it_f, hist_f = _history(a, fuse_blas1=True)
    assert it_f == it and np.array_equal(hist_f, hist)
    it_n, hist_n = _history(a, check_halves=False)
    assert it_n in (it, it + 1)
    assert np.array_equal(hist_n[1:2 * it:2], hist[1:2 * it:2])
    assert (hist_n[0:2 * it_n:2] == -1).all()
    assert (hist_n[2 * it_n:] == -1).all()


def test_plain_loop_where_the_variants_do_not_apply():
    """fused_dots on an operator without matvec_dots (banded DIA) and
    fuse_blas1 on the sequential series (no B5 layout) run the plain loop,
    as the JAX package does."""
    a = tprob.grid_laplacian(24, 40)
    b = np.random.default_rng(2).uniform(1.0, 5.0, a.n)
    base = ct.SolverConfig(**CFG)
    ps = ct.make_solver(a, base.replace(fused_dots=True),
                        format="pallas_dia", device="cpu")
    assert not hasattr(ps.op, "matvec_dots")
    plain = ct.make_solver(a, base, format="pallas_dia", device="cpu")
    assert np.array_equal(ps.solve(b).residual_history,
                          plain.solve(b).residual_history)
    seq = ct.make_solver(tprob.grid_laplacian(40, 126),
                         base.replace(neumann_terms=4, fuse_blas1=True),
                         device="cpu")
    assert seq.pre.fused is False and not seq.pre.fma_fits
    assert seq.solve(np.ones(seq.n)).status == ct.SolverStatus.CONVERGED
