"""Dispatch of the kernel front ends, and the kernels themselves on a card.

On the CPU a front end runs its plain twin and never counts a launch.  Any
other tensor goes to the kernel or raises: a failed build is never hidden
by a fallback.  The ``gpu`` tests compare each CUDA kernel with its twin
and skip without a card: the stencil kernels B1/B2/B5/B6, the 2-D stencil
B7 and the banded DIA SpMV B3 bit for bit (they round every product and
sum on its own, as the twins do; B6's dots are the twin's partials and
their sum in the twin's order), the
banded trisolve kernels B4a/B4b to 1e-12 (f64) and 1e-5 (f32) of max|twin|
(they sum in another order than the twin's torch.matmul), both against the
sequential twin and against the chunked plain version of their algorithm,
and equal bit for bit over two launches.
"""

import numpy as np
import pytest
import torch

import cuda_mat_tpu_torch.models.problems as tprob
from cuda_mat_tpu_torch.ops import _kernels
from cuda_mat_tpu_torch.ops import banded_trisolve as tbt
from cuda_mat_tpu_torch.ops import dia_spmv as tds
from cuda_mat_tpu_torch.ops import stencil as tst
from cuda_mat_tpu_torch.ops import stencil2d as t2d
from cuda_mat_tpu_torch.precond.preconditioners import (ILU0Preconditioner,
                                                        NeumannILUPreconditioner)
from cuda_mat_tpu_torch.reference.cpu_solvers import ilu0_factorize
from cuda_mat_tpu_torch.formats.coo import COOMatrix
from cuda_mat_tpu_torch.formats.csr import CSRMatrix

torch.set_num_threads(1)


def _setup(r=64, c=64, k=4, dtype=torch.float64, device="cpu"):
    a = tprob.grid_laplacian(r, c)
    d = a.to_dia(max_diags=16)
    op0 = tst.ConstStencilOperator.from_dia(d, dtype=dtype, device="cpu")
    plan = tst.plan_const_neumann_layout(op0.terms, k, op0.c_grid, op0.stride)
    op = tst.ConstStencilOperator.from_dia(d, dtype=dtype, device=device,
                                           min_sub=plan[0],
                                           block_target=plan[1])
    pre = NeumannILUPreconditioner.from_csr(a, terms=k, pad_like=op,
                                            milu_omega=0.96)
    return a, op, pre


def test_cpu_tensors_run_the_twins_and_count_nothing():
    a, op, pre = _setup()
    assert pre.fused == "kernel"
    tst.reset_launch_counts()
    x = op.pad_vec(np.random.default_rng(0).standard_normal(a.n))
    y = pre.msolve(op.matvec(x))
    assert torch.equal(y, tst.const_series_msolve_padded_plain(
        tst.const_stencil_spmv_padded_plain(
            x, op.gapmask, op.strided_terms, op.np_true, op.block, op.sub),
        pre.inv_d, pre.gap_ext, pre.nl.strided_terms, pre.nu.strided_terms,
        op.np_true, op.block, op.sub))
    assert tst.const_stencil_spmv_padded.launches == 0
    assert tst.const_series_msolve_padded.launches == 0


def test_missing_build_raises_and_never_falls_back(monkeypatch):
    """A non-CPU tensor (a meta tensor stands in for a CUDA one here) takes
    the kernel path; when the kernel library cannot be built the call
    raises, the twin is not run and no launch is counted."""
    _, op, pre = _setup()

    def no_build():
        raise RuntimeError("kernel build failed")

    def twin_called(*a, **k):
        raise AssertionError("fell back to the plain twin")

    monkeypatch.setattr(_kernels, "library", no_build)
    monkeypatch.setattr(tst, "const_stencil_spmv_padded_plain", twin_called)
    monkeypatch.setattr(tst, "const_series_msolve_padded_plain", twin_called)
    tst.reset_launch_counts()
    meta = torch.empty(op.npad + 2 * op.block, dtype=torch.float64,
                       device="meta")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tst.const_stencil_spmv_padded(meta, op.gapmask.to("meta"),
                                      op.strided_terms, op.np_true, op.block,
                                      op.sub)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tst.const_series_msolve_padded(
            meta, meta, pre.gap_ext.to("meta"), pre.nl.strided_terms,
            pre.nu.strided_terms, op.np_true, op.block, op.sub)
    assert tst.const_stencil_spmv_padded.launches == 0
    assert tst.const_series_msolve_padded.launches == 0


def _tri(side=12, block=16, dtype=torch.float64, device="cpu"):
    """The dense route's solver (block inverses) on an ILU(0) factor,
    whatever route ILU0Preconditioner would take for it."""
    a = tprob.banded_laplacian(side)
    return a, tbt.BandedTriSolver.from_factor(a, ilu0_factorize(a),
                                              block=block, dtype=dtype,
                                              device=device)


def test_trisolve_cpu_tensors_run_the_twins_and_count_nothing():
    a, tri = _tri()
    tbt.reset_launch_counts()
    f = torch.from_numpy(np.random.default_rng(0).standard_normal(a.n))
    fp = tri._pad(f)
    want = tbt.fused_msolve_padded_plain(fp, tri.wt_lo, tri.wct_lo,
                                         tri.wt_up, tri.wct_up)[:a.n]
    assert torch.equal(tri.msolve(f), want)
    assert torch.equal(tri.solve_lower(f), tbt.banded_sweep_padded_plain(
        fp, tri.wt_lo, tri.wct_lo, True)[:a.n])
    assert tbt.fused_msolve_padded.launches == 0
    assert tbt.banded_sweep_padded.launches == 0


def test_trisolve_missing_build_raises_and_never_falls_back(monkeypatch):
    _, tri = _tri()

    def no_build():
        raise RuntimeError("kernel build failed")

    def twin_called(*a, **k):
        raise AssertionError("fell back to the plain twin")

    monkeypatch.setattr(_kernels, "trisolve_library", no_build)
    monkeypatch.setattr(tbt, "banded_sweep_padded_plain", twin_called)
    monkeypatch.setattr(tbt, "fused_msolve_padded_plain", twin_called)
    tbt.reset_launch_counts()
    meta = torch.empty(tri.npad, dtype=torch.float64, device="meta")
    w = tri.wt_lo.to("meta")
    plans = (tri.plan_lo, tri.plan_up)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tbt.banded_sweep_padded(meta, w, w, True, plans[0])
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tbt.fused_msolve_padded(meta, w, w, w, w, plans)
    assert tbt.fused_msolve_padded.launches == 0
    assert tbt.banded_sweep_padded.launches == 0


def test_trisolve_kernel_path_requires_the_plan(monkeypatch):
    """On a non-CPU tensor the front ends take the factor's plan and never
    derive one per call: without it they raise before building or
    launching anything."""
    _, tri = _tri()

    def built(*a, **k):
        raise AssertionError("built or planned without a plan")

    monkeypatch.setattr(_kernels, "trisolve_library", built)
    monkeypatch.setattr(tbt, "sweep_plan", built)
    tbt.reset_launch_counts()
    meta = torch.empty(tri.npad, dtype=torch.float64, device="meta")
    w = tri.wt_lo.to("meta")
    with pytest.raises(ValueError, match="plan"):
        tbt.banded_sweep_padded(meta, w, w, True)
    with pytest.raises(ValueError, match="plan"):
        tbt.fused_msolve_padded(meta, w, w, w, w)
    assert tbt.fused_msolve_padded.launches == 0
    assert tbt.banded_sweep_padded.launches == 0


def _offset_matrix(n, lower, upper):
    """A diagonally dominant matrix on exactly the given offsets."""
    rng = np.random.default_rng(0)
    rows, cols, vals = [np.arange(n)], [np.arange(n)], [
        np.full(n, 2.0 + len(lower) + len(upper))]
    for sign, dists in ((-1, lower), (1, upper)):
        for o in dists:
            i = np.arange(o, n) if sign < 0 else np.arange(n - o)
            rows += [i]
            cols += [i + sign * o]
            vals += [rng.uniform(-1.0, -0.2, i.shape[0])]
    return CSRMatrix.from_coo(COOMatrix(
        n, n, np.concatenate(rows).astype(np.int32),
        np.concatenate(cols).astype(np.int32), np.concatenate(vals)))


DIAG_MATS = {"grid300x20": lambda: tprob.grid_laplacian(300, 20),
             "grid97x13": lambda: tprob.grid_laplacian(97, 13),
             "offsets31-29": lambda: _offset_matrix(3000, (31, 30, 29, 1),
                                                    (31, 30, 29, 1)),
             "eight-no-1": lambda: _offset_matrix(
                 2500, tuple(range(24, 2, -3)), (7, 2)),
             "diagonal": lambda: _offset_matrix(700, (), ())}


def _diag_tri(name="grid97x13", dtype=torch.float64, device="cpu"):
    a = DIAG_MATS[name]()
    return a, tbt.DiagTriSolver.from_factor(a, ilu0_factorize(a), block=128,
                                            dtype=dtype, device=device)


def test_diag_trisolve_missing_build_raises_and_never_falls_back(
        monkeypatch):
    _, tri = _diag_tri()

    def no_build():
        raise RuntimeError("kernel build failed")

    def twin_called(*a, **k):
        raise AssertionError("fell back to the plain twin")

    monkeypatch.setattr(_kernels, "trisolve_library", no_build)
    monkeypatch.setattr(tbt, "diag_sweep_chunked_plain", twin_called)
    monkeypatch.setattr(tbt, "diag_msolve_plain", twin_called)
    tbt.reset_launch_counts()
    meta = torch.empty(tri.n, dtype=torch.float64, device="meta")
    lo, up = tri.lo_vals.to("meta"), tri.up_vals.to("meta")
    d = tri.up_diag.to("meta")
    plans = (tri.plan_lo, tri.plan_up)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tbt.diag_sweep(meta, lo, tri.lo_offs, None, plans[0], True)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tbt.diag_msolve(meta, lo, tri.lo_offs, up, tri.up_offs, d, plans)
    assert tbt.diag_msolve.launches == 0
    assert tbt.diag_sweep.launches == 0


def test_diag_trisolve_kernel_path_requires_the_plan(monkeypatch):
    """Without the factor's plan the diagonal-form front ends raise before
    building or launching anything."""
    _, tri = _diag_tri()

    def built(*a, **k):
        raise AssertionError("built or planned without a plan")

    monkeypatch.setattr(_kernels, "trisolve_library", built)
    monkeypatch.setattr(tbt, "diag_plan", built)
    tbt.reset_launch_counts()
    meta = torch.empty(tri.n, dtype=torch.float64, device="meta")
    lo, up = tri.lo_vals.to("meta"), tri.up_vals.to("meta")
    with pytest.raises(ValueError, match="plan"):
        tbt.diag_sweep(meta, lo, tri.lo_offs, None, None, True)
    with pytest.raises(ValueError, match="plan"):
        tbt.diag_msolve(meta, lo, tri.lo_offs, up, tri.up_offs,
                        tri.up_diag.to("meta"), (None, None))
    assert tbt.diag_msolve.launches == 0
    assert tbt.diag_sweep.launches == 0


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
@pytest.mark.parametrize("rows", ["one", "ragged", "short"])
@pytest.mark.parametrize("name", list(DIAG_MATS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_diag_trisolve_kernels_match_twins_on_card(dtype, name, rows):
    """The diagonal-form route: B4b both ways and B4a against the chunked
    twin on the same plan and the dense route's sequential twin, within
    1e-12 (f64) / 1e-5 (f32) of max|twin|, two launches equal bit for bit;
    one chunk, chunks of 2·tb + 1 (the last one short), chunks shorter
    than the tail (where 120 chunks cover n); offsets with and without 1,
    eight of them, none; and the
    kernel's transfer matrices against the twin's, in f64."""
    a, tri = _diag_tri(name, dtype, "cuda")
    m = ilu0_factorize(a)
    dense = tbt.BandedTriSolver.from_factor(a, m, block=128, dtype=dtype,
                                            device="cpu")
    tb = tri.plan_lo.tb
    # "short": chunks shorter than the tail where at most 120 chunks do
    # (the carry's blocks must fit the card at once)
    length = {"one": a.n, "ragged": 2 * max(tb, 1) + 1,
              "short": max(tb // 2, 1, -(-a.n // 120))}[rows]
    plans = (tbt.diag_plan(tri.lo_vals, tri.lo_offs, None, a.n, True, length),
             tbt.diag_plan(tri.up_vals, tri.up_offs, tri.up_diag, a.n, False,
                           length))
    if tb and rows != "one":
        assert plans[0].chunks > 2
        v64 = tri.lo_vals.double().cpu()
        t_twin = tbt.diag_transfer_plain(v64, tri.lo_offs, None, a.n, tb,
                                         plans[0].rows, plans[0].chunks, True)
        t_kern = _kernels.diag_transfer(v64.cuda(), tri.lo_offs, None, a.n,
                                        tb, plans[0].rows, plans[0].chunks,
                                        True).cpu()
        assert (t_kern - t_twin).abs().max() <= 1e-12 * max(
            1.0, float(t_twin.abs().max()))
    f = torch.from_numpy(np.random.default_rng(1).standard_normal(a.n)).to(
        dtype).to("cuda")
    fp = dense._pad(f.cpu())
    bound = {torch.float32: 1e-5, torch.float64: 1e-12}[dtype]
    lo = (tri.lo_vals, tri.lo_offs, None)
    up = (tri.up_vals, tri.up_offs, tri.up_diag)
    tbt.reset_launch_counts()
    cases = [
        (lambda: tbt.diag_sweep(f, *lo, plans[0], True),
         lambda: tbt.diag_sweep_chunked_plain(f, *lo, plans[0], True),
         lambda: tbt.banded_sweep_padded_plain(fp, dense.wt_lo, dense.wct_lo,
                                               True)[:a.n]),
        (lambda: tbt.diag_sweep(f, *up, plans[1], False),
         lambda: tbt.diag_sweep_chunked_plain(f, *up, plans[1], False),
         lambda: tbt.banded_sweep_padded_plain(fp, dense.wt_up, dense.wct_up,
                                               False)[:a.n]),
        (lambda: tbt.diag_msolve(f, tri.lo_vals, tri.lo_offs, tri.up_vals,
                                 tri.up_offs, tri.up_diag, plans),
         lambda: tbt.diag_msolve_plain(f, tri.lo_vals, tri.lo_offs,
                                       tri.up_vals, tri.up_offs, tri.up_diag,
                                       plans),
         lambda: tbt.fused_msolve_padded_plain(fp, dense.wt_lo, dense.wct_lo,
                                               dense.wt_up,
                                               dense.wct_up)[:a.n])]
    for kern, twin, seq in cases:
        torch.full_like(f, float("nan"))
        yk = kern()
        torch.full_like(f, float("nan"))
        yk2 = kern()
        yt, ys = twin(), seq().to("cuda")
        torch.cuda.synchronize()
        assert torch.isfinite(yk).all()
        assert torch.equal(yk, yk2)   # deterministic: no atomics
        assert (yk - yt).abs().max() <= bound * yt.abs().max()
        assert (yk - ys).abs().max() <= bound * ys.abs().max()
    # B4a runs B4b forward and backward: two sweeps of its own
    assert tbt.diag_sweep.launches == 8
    assert tbt.diag_msolve.launches == 2
    # the carry's hand-over slots hold the sentinel again between sweeps
    for plan in plans:
        bits = plan.hand.view(torch.int64 if dtype == torch.float64
                              else torch.int32)
        assert bool((bits == tbt.HAND_SENTINEL[dtype]).all())


def test_operator_constructors_default_to_the_card():
    """ConstStencilOperator.from_dia and PallasDIAOperator.from_dia, like
    the entry points, put their tensors on the card unless asked for the
    CPU: without a card they raise rather than quietly return CPU tensors."""
    dia = tprob.grid_laplacian(64, 64).to_dia(max_diags=16)
    for make in (tst.ConstStencilOperator.from_dia,
                 tds.PallasDIAOperator.from_dia):
        if torch.cuda.is_available():
            assert make(dia).device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                make(dia)


def _dia(dtype=torch.float64, device="cpu"):
    """The DIA operator of banded_laplacian_dia(40), block 2048, and a
    random-valued band with offsets up to ±1500 in a block of 4096."""
    lap = tds.PallasDIAOperator.from_dia(tprob.banded_laplacian_dia(40),
                                         dtype=dtype, block=2048,
                                         device=device)
    n, offs = 3000, np.array([-1500, -3, 0, 1, 700], np.int32)
    data = np.random.default_rng(0).uniform(-1.0, 1.0, (offs.size, n))
    for d, off in enumerate(offs):
        i = np.arange(n)
        data[d, (i + off < 0) | (i + off >= n)] = 0.0
    band = tds.PallasDIAOperator.from_dia(
        tprob.DIAMatrix(n, n, offs, data, int(np.count_nonzero(data))),
        dtype=dtype, block=4096, device=device)
    return lap, band


def test_dia_cpu_tensors_run_the_twin_and_count_nothing():
    for op in _dia():
        tds.reset_launch_counts()
        x = op.pad_vec(np.random.default_rng(1).standard_normal(op.n))
        assert torch.equal(op.matvec(x), tds.dia_spmv_block_padded_plain(
            op.data, x, op.offsets, op.block, op.sub))
        assert tds.dia_spmv_block_padded.launches == 0


def test_dia_missing_build_raises_and_never_falls_back(monkeypatch):
    op, _ = _dia()

    def no_build():
        raise RuntimeError("kernel build failed")

    def twin_called(*a, **k):
        raise AssertionError("fell back to the plain twin")

    monkeypatch.setattr(_kernels, "dia_library", no_build)
    monkeypatch.setattr(tds, "dia_spmv_block_padded_plain", twin_called)
    tds.reset_launch_counts()
    meta = torch.empty(op.npad + 2 * op.block, dtype=torch.float64,
                       device="meta")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tds.dia_spmv_block_padded(op.data.to("meta"), meta, op.offsets,
                                  op.block, op.sub)
    assert tds.dia_spmv_block_padded.launches == 0


def test_msolve_fit_check():
    """The fused kernel takes a layout only while P_l's reads over the u
    tile stay inside the pad block and the tile fits shared memory."""
    _, op, pre = _setup()
    tl, tu = pre.nl.strided_terms, pre.nu.strided_terms
    assert _kernels.msolve_fits(op.block, tl, tu, 8)
    far = tu + ((op.block, 1.0),)
    assert not _kernels.msolve_fits(op.block, tl, far, 8)
    assert not _kernels.msolve_fits(op.block, tl, tu + ((40000, 1.0),), 8)


def _fusion_args(op, pre, seed=2):
    """Three padded vectors and the B5 layout arguments of ``pre``."""
    rng = np.random.default_rng(seed)
    vecs = [op.pad_vec(rng.standard_normal(op.n)) for _ in range(3)]
    layout = (pre.inv_d, pre.gap_ext, pre.nl.strided_terms,
              pre.nu.strided_terms, op.np_true, op.block, op.sub)
    return vecs, layout


def test_fusion_front_ends_on_cpu_run_the_twins_and_count_nothing():
    _, op, pre = _setup()
    assert pre.fma_fits
    (a, b, c), layout = _fusion_args(op, pre)
    tst.reset_launch_counts()
    c1, c2 = torch.tensor(0.5, dtype=a.dtype), torch.tensor(-2.0,
                                                            dtype=a.dtype)
    for cc, c2c in ((c, c2), (None, None)):
        p, y = tst.const_series_msolve_fma_padded(a, c1, b, c2c, cc, *layout)
        pp, yp = tst.const_series_msolve_fma_padded_plain(a, c1, b, c2c, cc,
                                                          *layout)
        assert torch.equal(p, pp) and torch.equal(y, yp)
    y, d = op.matvec_dots(a, (b,), with_self=True)
    yp, dp = tst.const_stencil_spmv_dots_padded_plain(
        a, op.gapmask, (b,), op.strided_terms, op.np_true, op.block, op.sub,
        with_self=True)
    assert torch.equal(y, yp) and torch.equal(d, dp)
    op2 = t2d.StencilOperator2D.laplacian(20, 50, torch.float64, tr=8, tc=32,
                                          device="cpu")
    t2d.reset_launch_counts()
    x2 = op2.pad_vec(np.ones(op2.n))
    assert torch.equal(op2.matvec(x2), t2d.stencil_spmv_padded_plain(
        op2.coeffs, x2, op2.offsets, 8, 32, op2.rp, op2.cp, 20, 50))
    assert tst.const_series_msolve_fma_padded.launches == 0
    assert tst.const_stencil_spmv_dots_padded.launches == 0
    assert t2d.stencil_spmv_padded.launches == 0


def test_fusion_missing_build_raises_and_never_falls_back(monkeypatch):
    _, op, pre = _setup()

    def no_build():
        raise RuntimeError("kernel build failed")

    def twin_called(*a, **k):
        raise AssertionError("fell back to the plain twin")

    monkeypatch.setattr(_kernels, "library", no_build)
    monkeypatch.setattr(_kernels, "stencil2d_library", no_build)
    for name in ("const_series_msolve_fma_padded_plain",
                 "const_stencil_spmv_dots_padded_plain"):
        monkeypatch.setattr(tst, name, twin_called)
    monkeypatch.setattr(t2d, "stencil_spmv_padded_plain", twin_called)
    tst.reset_launch_counts()
    t2d.reset_launch_counts()
    meta = torch.empty(op.npad + 2 * op.block, dtype=torch.float64,
                       device="meta")
    one = torch.empty((), dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tst.const_series_msolve_fma_padded(
            meta, one, meta, one, meta, meta, pre.gap_ext.to("meta"),
            pre.nl.strided_terms, pre.nu.strided_terms, op.np_true, op.block,
            op.sub)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tst.const_stencil_spmv_dots_padded(
            meta, op.gapmask.to("meta"), (meta,), op.strided_terms,
            op.np_true, op.block, op.sub, with_self=True)
    op2 = t2d.StencilOperator2D.laplacian(20, 50, torch.float64, tr=8, tc=32,
                                          device="meta")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        op2.matvec(torch.empty((op2.rp + 16) * (op2.cp + 64),
                               dtype=torch.float64, device="meta"))
    assert tst.const_series_msolve_fma_padded.launches == 0
    assert tst.const_stencil_spmv_dots_padded.launches == 0
    assert t2d.stencil_spmv_padded.launches == 0


def test_msolve_fma_fit_check():
    """Kernel B5 takes a layout only where B2 does and its shared memory
    also holds the combined vector over P_l's window."""
    _, op, pre = _setup()
    tl, tu = pre.nl.strided_terms, pre.nu.strided_terms
    assert _kernels.msolve_fma_fits(op.block, tl, tu, 8)
    assert not _kernels.msolve_fma_fits(op.block, tl, tu + ((op.block, 1.0),),
                                        8)
    # a halo whose u tile fitted B2 but not B5's p window beside it: B5's
    # streaming rings hold it too now; a u reach whose ring does not fit
    # shared memory even alone is refused by both
    wide = tu + ((9000, 1.0),)
    assert _kernels.msolve_fits(1 << 17, tl, wide, 8)
    assert _kernels.msolve_fma_fits(1 << 17, tl, wide, 8)
    both = wide + ((-20000, 1.0), (20000, 1.0))
    assert not _kernels.msolve_fits(1 << 17, tl, both, 8)
    assert not _kernels.msolve_fma_fits(1 << 17, tl, both, 8)


FMA_PAIRS = [(0.73, -1.21), (-0.4, 0.0), (0.0, 5.0)]


def _msolve_cases(dtype, device):
    """Layouts and terms at the edges of B2's and B5's design, each as
    (name, mode, x_pad, inv_d_pad, gapmask_ext, terms_l, terms_u, np_true,
    block, sub, base): ``mode`` names what the case reaches of the plan
    (``_kernels.msolve_plan``).  x and inv_d are random in the pad blocks
    too where a shard's base is set, as a shard's halo would be."""
    rng = np.random.default_rng(8)
    f32 = dtype == torch.float32
    cases = []
    # the mat10000 layout: fewer tiles than blocks on a card, runs of one
    # tile, np_true (12800) inside a tile
    a, op, pre = _setup(100, 100, 4, dtype, device)
    cases.append(("mat10000 layout", "one-tile runs",
                  op.pad_vec(rng.standard_normal(a.n)), pre.inv_d,
                  pre.gap_ext, pre.nl.strided_terms, pre.nu.strided_terms,
                  op.np_true, op.block, op.sub, 0))

    def synthetic(name, mode, block, nblocks, tl, tu, np_true, base, sub,
                  pads):
        n = (nblocks + 2) * block
        gap = torch.zeros(block, dtype=dtype)
        gap.view(-1, 128)[:, :100] = 1.0
        ext = torch.cat([gap[-1024:], gap, gap[:1024]])
        x = torch.from_numpy(rng.standard_normal(n)).to(dtype)
        inv_d = torch.from_numpy(rng.uniform(0.5, 2.0, n)).to(dtype)
        if not pads:
            for v in (x, inv_d):
                v[:block] = 0
                v[n - block:] = 0
        cases.append((name, mode, x.to(device), inv_d.to(device),
                      ext.to(device), tl, tu, np_true, block, sub, base))

    both_l = ((-300, 0.5), (-1, -1.0), (0, 4.0), (2, -1.0), (129, 0.25),
              (700, -0.125))
    both_u = ((-130, 0.3), (0, 1.0), (1, -0.5), (257, 0.7), (-3, 0.1))
    synthetic("offsets of both signs in both polynomials", "both signs",
              4096, 3, both_l, both_u, 3 * 4096 - 700, 0, 1024, False)
    synthetic("a shard's base: the tail inside the vector, random pads",
              "both signs", 4096, 3, both_l, both_u, 3 * 4096 + 500, 1000,
              1024, True)
    synthetic("a shard past np_true: all zero", "both signs", 4096, 3,
              both_l, both_u, 5000, 5005, 1024, True)
    neumann = (tuple((-o, 1.0 / (1 + o)) for o in (384, 257, 256, 130, 129,
                                                   128, 3, 2, 1, 0)),
               tuple((o, 1.0 / (2 + o)) for o in (0, 1, 2, 3, 128, 129, 130,
                                                  256, 257, 384)))
    synthetic("runs of uneven length", "uneven runs", 1 << 17, 5, *neumann,
              5 * (1 << 17) - 1234, 0, 2048, False)
    far = (((-60000, 0.5), (-1, -1.0), (0, 4.0), (1, -1.0)),
           ((0, 1.0), (1, -0.5), (128, 0.25)))
    synthetic("a P_l term past the p ring's halo", "far terms", 1 << 17, 2,
              *far, 2 * (1 << 17) - 99, 0, 65536, False)
    for mode, h in (("wrap", 20000 if f32 else 9000),
                    ("lean", 28000 if f32 else 14000)):
        synthetic(f"P_u reaching {h} rows both ways", mode, 1 << 17, 2,
                  ((-1, -1.0), (0, 4.0), (1, -1.0)),
                  ((-h, 0.3), (-1, 0.5), (0, 1.0), (h, 0.2)),
                  2 * (1 << 17) - 5, 0, 65536, False)
    return cases


def _fma_inputs(x, block):
    """B5's a, b, c from x's layout: random, zero in the pad blocks (as the
    loop's vectors are)."""
    rng = np.random.default_rng(9)
    out = []
    for _ in range(3):
        v = torch.from_numpy(rng.standard_normal(x.shape[0])).to(x.dtype)
        v[:block] = 0
        v[x.shape[0] - block:] = 0
        out.append(v.to(x.device))
    return out


def _check_mode(mode, plan, npad):
    tiles = npad // plan.tile
    if mode == "one-tile runs":
        assert plan.ctas == tiles < 132 and plan.run == 1
    elif mode == "both signs":
        assert plan.gp_lo and plan.gp_hi and plan.gu_lo and plan.gu_hi
    elif mode == "uneven runs":
        assert plan.run > 1 and tiles % plan.ctas
    elif mode == "far terms":
        assert plan.stages and plan.gp_lo < 60000
    elif mode == "wrap":
        assert plan.stages and plan.wrap
    else:
        assert mode == "lean" and plan.stages == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_msolve_cases_reach_their_modes_and_run_the_twins_on_cpu(dtype):
    """The card cases below on CPU tensors: each layout's plan (as an H100
    would get it, 132 SMs) reaches the mode the case names, for B2 and both
    forms of B5, and the front ends take the layouts and run the twins,
    counting no launch."""
    tst.reset_launch_counts()
    for name, mode, x, inv_d, ext, tl, tu, np_true, block, sub, base in \
            _msolve_cases(dtype, "cpu"):
        npad = x.shape[0] - 2 * block
        for nin in (1, 2, 3):
            _check_mode(mode, _kernels.msolve_plan(
                npad, block, tuple(tl), tuple(tu), x.element_size(), nin,
                132), npad)
        args = (inv_d, ext, tl, tu, np_true, block, sub, base)
        assert torch.equal(tst.const_series_msolve_padded(x, *args),
                           tst.const_series_msolve_padded_plain(x, *args))
        a, b, c = _fma_inputs(x, block)
        one = torch.tensor(0.5, dtype=dtype)
        assert all(torch.equal(u, v) for u, v in zip(
            tst.const_series_msolve_fma_padded(a, one, b, one, c, *args),
            tst.const_series_msolve_fma_padded_plain(a, one, b, one, c,
                                                     *args)))
    assert tst.const_series_msolve_padded.launches == 0
    assert tst.const_series_msolve_fma_padded.launches == 0


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_equal_twins_on_card(dtype):
    a, op, pre = _setup(100, 100, 4, dtype, "cuda")
    assert pre.fused == "kernel"
    x = op.pad_vec(np.random.default_rng(1).standard_normal(a.n))
    tst.reset_launch_counts()
    # a NaN block left in the caching allocator: an output element the
    # kernel did not write would show as NaN
    torch.full_like(x, float("nan"))
    y = op.matvec(x)
    torch.full_like(x, float("nan"))
    z = pre.msolve(y)
    torch.cuda.synchronize()
    assert tst.const_stencil_spmv_padded.launches == 1
    assert tst.const_series_msolve_padded.launches == 1
    y_plain = tst.const_stencil_spmv_padded_plain(
        x, op.gapmask, op.strided_terms, op.np_true, op.block, op.sub)
    z_plain = tst.const_series_msolve_padded_plain(
        y, pre.inv_d, pre.gap_ext, pre.nl.strided_terms,
        pre.nu.strided_terms, op.np_true, op.block, op.sub)
    assert torch.equal(y, y_plain)
    assert torch.equal(z, z_plain)
    # B2 at the edges of its design (_msolve_cases): bitwise equal to its
    # twin, output poisoned first, the same over two launches, pads zero
    cases = _msolve_cases(dtype, "cuda")
    for name, mode, x, inv_d, ext, tl, tu, np_true, block, sub, base in \
            cases:
        args = (inv_d, ext, tl, tu, np_true, block, sub, base)
        torch.full_like(x, float("nan"))
        z = tst.const_series_msolve_padded(x, *args)
        torch.full_like(x, float("nan"))
        z2 = tst.const_series_msolve_padded(x, *args)
        z_plain = tst.const_series_msolve_padded_plain(x, *args)
        torch.cuda.synchronize()
        assert torch.equal(z, z_plain), name
        assert torch.equal(z, z2), name
        assert torch.count_nonzero(z[:block]) == 0, name
        assert torch.count_nonzero(z[z.shape[0] - block:]) == 0, name
    assert tst.const_series_msolve_padded.launches == 1 + 2 * len(cases)


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
@pytest.mark.parametrize("side,block", [(30, 32), (30, 64), (100, 128),
                                        (20, 30), (30, 45), (30, 31)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trisolve_kernels_match_twins_on_card(dtype, side, block):
    """Blocks 30 (f32), 45 and 31 are not whole 16-byte rows: the walk
    kernel copies one element at a time; at 31 in f32 the carry (bw 30
    rounded up to 32, capped at 31) does too."""
    a, tri = _tri(side, block, dtype, "cuda")
    per16 = 16 // tri.wt_lo.element_size()
    assert tri.plan_lo.chunks > 1
    assert tri.plan_lo.bw == min(block, -(-side // per16) * per16)
    plans = (tri.plan_lo, tri.plan_up)
    f = tri._pad(torch.from_numpy(
        np.random.default_rng(1).standard_normal(a.n)).to("cuda"))
    bound = {torch.float32: 1e-5, torch.float64: 1e-12}[dtype]
    tbt.reset_launch_counts()
    cases = [
        (lambda: tbt.banded_sweep_padded(f, tri.wt_lo, tri.wct_lo, True,
                                         plans[0]),
         lambda: tbt.banded_sweep_padded_plain(f, tri.wt_lo, tri.wct_lo,
                                               True)),
        (lambda: tbt.banded_sweep_padded(f, tri.wt_up, tri.wct_up, False,
                                         plans[1]),
         lambda: tbt.banded_sweep_padded_plain(f, tri.wt_up, tri.wct_up,
                                               False)),
        (lambda: tbt.fused_msolve_padded(f, tri.wt_lo, tri.wct_lo, tri.wt_up,
                                         tri.wct_up, plans),
         lambda: tbt.fused_msolve_padded_plain(f, tri.wt_lo, tri.wct_lo,
                                               tri.wt_up, tri.wct_up))]
    chunked = [
        lambda: tbt.banded_sweep_chunked_plain(f, tri.wt_lo, tri.wct_lo,
                                               tri.plan_lo, True),
        lambda: tbt.banded_sweep_chunked_plain(f, tri.wt_up, tri.wct_up,
                                               tri.plan_up, False),
        lambda: tbt.banded_sweep_chunked_plain(
            tbt.banded_sweep_chunked_plain(f, tri.wt_lo, tri.wct_lo,
                                           tri.plan_lo, True),
            tri.wt_up, tri.wct_up, tri.plan_up, False)]
    for (kern, plain), chunk in zip(cases, chunked):
        torch.full_like(f, float("nan"))
        yk = kern()
        torch.full_like(f, float("nan"))
        yk2 = kern()
        yp, yc = plain(), chunk()
        torch.cuda.synchronize()
        assert torch.isfinite(yk).all()
        assert torch.equal(yk, yk2)   # deterministic: no atomics
        assert (yk - yp).abs().max() <= bound * yp.abs().max()
        assert (yk - yc).abs().max() <= bound * yp.abs().max()
        assert torch.count_nonzero(yk[a.n:]) == 0
    # B4a runs B4b forward and backward: two sweeps of its own
    assert tbt.banded_sweep_padded.launches == 8
    assert tbt.fused_msolve_padded.launches == 2


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dia_kernel_equals_twin_on_card(dtype):
    tds.reset_launch_counts()
    for op in _dia(dtype, "cuda"):
        x = op.pad_vec(np.random.default_rng(1).standard_normal(op.n))
        torch.full_like(x, float("nan"))
        y = op.matvec(x)
        torch.cuda.synchronize()
        assert torch.equal(y, tds.dia_spmv_block_padded_plain(
            op.data, x, op.offsets, op.block, op.sub))
        assert torch.count_nonzero(y[:op.block]) == 0
        assert torch.count_nonzero(y[op.block + op.n:]) == 0
    assert tds.dia_spmv_block_padded.launches == 2


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fusion_kernels_equal_twins_on_card(dtype):
    a, op, pre = _setup(100, 100, 4, dtype, "cuda")
    assert pre.fused == "kernel" and pre.fma_fits
    (av, bv, cv), layout = _fusion_args(op, pre)
    tst.reset_launch_counts()
    pads = op.pad_vec(np.ones(a.n)) == 0
    for c1, c2 in FMA_PAIRS:
        s1 = torch.tensor(c1, dtype=dtype, device="cuda")
        s2 = torch.tensor(c2, dtype=dtype, device="cuda")
        for cc, c2c in ((cv, s2), (None, None)):
            torch.full_like(av, float("nan"))
            torch.full_like(av, float("nan"))
            p, y = tst.const_series_msolve_fma_padded(av, s1, bv, c2c, cc,
                                                      *layout)
            pp, yp = tst.const_series_msolve_fma_padded_plain(
                av, s1, bv, c2c, cc, *layout)
            torch.cuda.synchronize()
            assert torch.equal(p, pp) and torch.equal(y, yp)
            assert not p[pads].any() and not y[pads].any()
    assert tst.const_series_msolve_fma_padded.launches == 6
    # B5 at the edges of its design, both forms, every scalar pair: p and y
    # bitwise equal to the twin, outputs poisoned first, the same over two
    # launches, pads zero
    cases = _msolve_cases(dtype, "cuda")
    for name, mode, x, inv_d, ext, tl, tu, np_true, block, sub, base in \
            cases:
        args = (inv_d, ext, tl, tu, np_true, block, sub, base)
        a, b, c = _fma_inputs(x, block)
        for c1, c2 in FMA_PAIRS:
            s1 = torch.tensor(c1, dtype=dtype, device="cuda")
            s2 = torch.tensor(c2, dtype=dtype, device="cuda")
            for cc, c2c in ((c, s2), (None, None)):
                outs = []
                for _ in range(2):
                    torch.full_like(x, float("nan"))
                    torch.full_like(x, float("nan"))
                    outs.append(tst.const_series_msolve_fma_padded(
                        a, s1, b, c2c, cc, *args))
                pp, yp = tst.const_series_msolve_fma_padded_plain(
                    a, s1, b, c2c, cc, *args)
                torch.cuda.synchronize()
                (p, y), (p2, y2) = outs
                assert torch.equal(p, pp) and torch.equal(y, yp), name
                assert torch.equal(p, p2) and torch.equal(y, y2), name
                for v in (p, y):
                    assert torch.count_nonzero(v[:block]) == 0, name
                    assert torch.count_nonzero(v[v.shape[0] - block:]) == 0
    assert tst.const_series_msolve_fma_padded.launches == \
        6 + 2 * 2 * len(FMA_PAIRS) * len(cases)
    for ws, with_self in (((bv,), True), ((bv,), False)):
        torch.full_like(av, float("nan"))
        y, d = op.matvec_dots(av, ws, with_self=with_self)
        y2, d2 = op.matvec_dots(av, ws, with_self=with_self)
        yp, dp = tst.const_stencil_spmv_dots_padded_plain(
            av, op.gapmask, ws, op.strided_terms, op.np_true, op.block,
            op.sub, with_self=with_self)
        torch.cuda.synchronize()
        assert torch.equal(y, yp) and torch.equal(d, dp)
        assert torch.equal(y, op.matvec(av))
        assert torch.equal(y, y2) and torch.equal(d, d2)
    assert tst.const_stencil_spmv_dots_padded.launches == 4


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
@pytest.mark.parametrize("constant", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil2d_kernel_equals_twin_on_card(dtype, constant):
    t2d.reset_launch_counts()
    for r, c, tr, tc in [(30, 30, 16, 16), (32, 32, 16, 16), (20, 50, 8, 32),
                         (300, 700, 256, 512)]:
        op = t2d.StencilOperator2D.laplacian(r, c, dtype, tr=tr, tc=tc,
                                             constant=constant, device="cuda")
        x = op.pad_vec(np.random.default_rng(1).standard_normal(op.n))
        torch.full_like(x, float("nan"))
        y = op.matvec(x)
        torch.cuda.synchronize()
        assert torch.equal(y, t2d.stencil_spmv_padded_plain(
            op.coeffs, x, op.offsets, tr, tc, op.rp, op.cp, r, c))
    assert t2d.stencil_spmv_padded.launches == 4


def _b1_cases(dtype, device):
    """Layouts and terms that B1's geometry must take, each as
    (name, x_pad, args of const_stencil_spmv_padded after x_pad)."""
    rng = np.random.default_rng(3)
    cases = []
    # a block that is not a power of two: 3163 columns, stride 3200, block
    # 102400 = 100 * 1024
    d = tprob.grid_laplacian(6, 3163).to_dia(max_diags=16)
    op = tst.ConstStencilOperator.from_dia(d, dtype=dtype, device=device)
    assert op.block & (op.block - 1)
    x = op.pad_vec(rng.standard_normal(op.n))
    cases.append(("block not a power of two", x, (
        op.gapmask, op.strided_terms, op.np_true, op.block, op.sub, 0)))
    # a shard's base: the tail np_true - base falls inside the vector, and
    # a base past np_true leaves all of it zero
    d = tprob.grid_laplacian(17, 30).to_dia(max_diags=16)
    op = tst.ConstStencilOperator.from_dia(d, dtype=dtype, device=device)
    x = torch.from_numpy(rng.standard_normal(op.npad + 2 * op.block)).to(
        dtype).to(device)
    for base in (1000, 3000, op.np_true + 5):
        cases.append((f"base {base}", x, (
            op.gapmask, op.strided_terms, op.np_true, op.block, op.sub,
            base)))
    # mono's 37 wide terms on the mat10000 grid
    a, op, _ = _setup(100, 100, 4, dtype, device)
    mono = NeumannILUPreconditioner.from_csr(a, terms=4, pad_like=op,
                                             prefer_mono=True,
                                             milu_omega=0.96)
    assert mono.fused == "mono" and len(mono.nl.strided_terms) == 37
    x = op.pad_vec(rng.standard_normal(a.n))
    cases.append(("mono", x, (op.gapmask, mono.nl.strided_terms, op.np_true,
                              op.block, op.sub, 0)))
    # the fuse_blas1 layout of a 100-column grid
    a = tprob.grid_laplacian(300, 100)
    d = a.to_dia(max_diags=16)
    op0 = tst.ConstStencilOperator.from_dia(d, dtype=dtype, device="cpu")
    plan = tst.plan_const_neumann_layout(op0.terms, 4, op0.c_grid,
                                         op0.stride, fuse_blas1=True)
    op = tst.ConstStencilOperator.from_dia(d, dtype=dtype, device=device,
                                           min_sub=plan[0],
                                           block_target=plan[1])
    x = op.pad_vec(rng.standard_normal(a.n))
    cases.append(("fuse_blas1 layout", x, (
        op.gapmask, op.strided_terms, op.np_true, op.block, op.sub, 0)))
    # terms four grid rows away on a 3163-column grid, past what the
    # ring holds in shared memory: those read device memory
    sub = 16384
    stride, sub, block, np_true, npad, _ = tst.stencil_layout(
        3163, 8 * 3163, ((0, 0, 1.0),), min_sub=sub)
    terms = ((-4 * stride, 0.5), (-1, -1.0), (0, 4.0), (1, -1.0),
             (4 * stride, 0.25))
    plan = _kernels.spmv_plan(npad, block, 4 * stride, 8, 132)
    assert plan.halo * plan.tile < 4 * stride
    gap = torch.zeros(block, dtype=dtype)
    gap.view(-1, stride)[:, :3163] = 1.0
    x = torch.from_numpy(rng.standard_normal(npad + 2 * block)).to(dtype)
    cases.append(("terms past the ring", x.to(device), (
        gap.to(device), terms, np_true, block, sub, 0)))
    return cases


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmv_kernel_layouts_on_card(dtype):
    """B1 bitwise equal to its twin, with its output poisoned first and
    the same bits over two launches, at each layout and term set of
    _b1_cases; the pad blocks zero."""
    tst.reset_launch_counts()
    cases = _b1_cases(dtype, "cuda")
    for name, x, args in cases:
        torch.full_like(x, float("nan"))
        y = tst.const_stencil_spmv_padded(x, *args)
        torch.full_like(x, float("nan"))
        y2 = tst.const_stencil_spmv_padded(x, *args)
        yp = tst.const_stencil_spmv_padded_plain(x, *args)
        torch.cuda.synchronize()
        block = args[3]
        assert torch.equal(y, yp), name
        assert torch.equal(y, y2), name
        assert torch.count_nonzero(y[:block]) == 0, name
        assert torch.count_nonzero(y[y.shape[0] - block:]) == 0, name
    assert tst.const_stencil_spmv_padded.launches == 2 * len(cases)


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmv_dots_kernel_layouts_on_card(dtype):
    """B6 bitwise equal to its twin (y and the dots) at each layout and
    term set of _b1_cases (a tail and a shard's base, mono's 37 terms, the
    fuse_blas1 layout, terms past the ring that read device memory), with
    and without <y, y>, with and without a weight (random in the pad
    blocks too): outputs poisoned first (y, and the one allocation of the
    partials and the dots), the same bits over two launches, y equal to
    B1's, the pad blocks zero."""
    tst.reset_launch_counts()
    cases = _b1_cases(dtype, "cuda")
    rng = np.random.default_rng(9)
    for name, x, args in cases:
        gap, terms, np_true, block, sub, base = args
        w = torch.from_numpy(rng.standard_normal(x.shape[0])).to(dtype).to(
            "cuda")
        y1 = tst.const_stencil_spmv_padded(x, *args)
        for ws, with_self in (((w,), True), ((w,), False), ((), True)):
            outs = []
            for _ in range(2):
                _poison_b6(x, len(ws) + with_self)
                outs.append(tst.const_stencil_spmv_dots_padded(
                    x, gap, ws, terms, np_true, block, sub, with_self, base))
            yp, dp = tst.const_stencil_spmv_dots_padded_plain(
                x, gap, ws, terms, np_true, block, sub, with_self, base)
            torch.cuda.synchronize()
            (y, d), (y2, d2) = outs
            what = f"{name}, {len(ws)} weight(s), with_self {with_self}"
            assert d.shape == (len(ws) + with_self,), what
            assert torch.equal(y, yp) and torch.equal(d, dp), what
            assert torch.equal(y, y2) and torch.equal(d, d2), what
            assert torch.equal(y, y1), what
            assert torch.count_nonzero(y[:block]) == 0, what
            assert torch.count_nonzero(y[y.shape[0] - block:]) == 0, what
    assert tst.const_stencil_spmv_dots_padded.launches == 6 * len(cases)
    assert tst.const_stencil_spmv_padded.launches == len(cases)


def _poison_b6(x, n_dots):
    """Leave NaN blocks of the sizes of B6's y and of its partials and dots
    (one allocation, n_dots per DOTS_BLOCK rows and the n_dots sums) in the
    caching allocator, so that the launch's torch.empty likely gets them:
    an element, partial or dot the kernel fails to write shows as NaN."""
    torch.full_like(x, float("nan"))
    torch.full((x.shape[0] // _kernels.DOTS_BLOCK * n_dots + n_dots,),
               float("nan"), dtype=x.dtype, device=x.device)


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_spmv_dots_kernel_on_two_streams_and_in_a_graph():
    """B6 on two streams at once, each with its own ticket, gives the
    twin's bits on both; captured in a CUDA graph (after a launch on the
    capturing stream), its replays give them too."""
    tst.reset_launch_counts()
    name, x, args = _b1_cases(torch.float32, "cuda")[0]
    gap, terms, np_true, block, sub, base = args
    rng = np.random.default_rng(10)
    ws = tuple(torch.from_numpy(rng.standard_normal(x.shape[0])).to(
        torch.float32).to("cuda") for _ in range(2))
    want = [tst.const_stencil_spmv_dots_padded_plain(
        x, gap, (w,), terms, np_true, block, sub, True, base) for w in ws]
    streams = [torch.cuda.Stream() for _ in ws]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(10):
        for i, (st, w) in enumerate(zip(streams, ws)):
            with torch.cuda.stream(st):
                _poison_b6(x, 2)
                outs[i].append(tst.const_stencil_spmv_dots_padded(
                    x, gap, (w,), terms, np_true, block, sub, True, base))
    torch.cuda.synchronize()
    tickets = [_kernels._dots_tickets[x.device, st.cuda_stream]
               for st in streams]
    assert tickets[0].data_ptr() != tickets[1].data_ptr()
    assert all(t.tolist() == [0] for t in tickets)
    for i, (yp, dp) in enumerate(want):
        for y, d in outs[i]:
            assert torch.equal(y, yp) and torch.equal(d, dp), (name, i)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tst.const_stencil_spmv_dots_padded(x, gap, (ws[0],), terms, np_true,
                                           block, sub, True, base)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y, d = tst.const_stencil_spmv_dots_padded(
            x, gap, (ws[0],), terms, np_true, block, sub, True, base)
    for _ in range(3):
        y.fill_(float("nan"))
        d.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want[0][0]) and torch.equal(d, want[0][1])
    assert tst.const_stencil_spmv_dots_padded.launches == 22


def _b7_cases(dtype, device):
    """(name, coeffs, x_pad, offsets, tr, tc, rp, cp, r, c) for B7."""
    rng = np.random.default_rng(4)

    def case(name, r, c, tr, tc, offsets, n_var):
        rp, cp = -(-r // tr) * tr, -(-c // tc) * tc
        grids = torch.from_numpy(rng.standard_normal((n_var, rp, cp)))
        x = torch.from_numpy(rng.standard_normal((rp + 2 * tr)
                                                 * (cp + 2 * tc)))
        return (name, grids.to(dtype).to(device), x.to(dtype).to(device),
                offsets, tr, tc, rp, cp, r, c)

    reach = ((-4, 0, 0.5), (0, -8, -1.0), (0, 0, 4.0), (0, 8, -1.0),
             (4, 0, 0.25), (-4, -8, None), (4, 8, None))
    mixed = tuple((dr, dc, None if (dr + dc) % 2 == 0
                   else float(rng.uniform(-2, 2)))
                  for dr in (-1, 0, 1) for dc in (-1, 0, 1))
    far = ((-200, 0, 1.5), (0, -1, -1.0), (0, 0, 4.0), (0, 3, -1.0),
           (200, 0, 0.5))
    return [
        case("|dr| = tr and |dc| = tc", 13, 21, 4, 8, reach, 2),
        case("variable coefficients with the mask", 30, 45, 16, 16, mixed,
             5),
        case("variable only, no mask", 20, 50, 8, 32,
             tuple((dr, dc, None) for dr, dc, _ in mixed), 9),
        case("columns not whole 16-byte words (tc 3)", 10, 10, 4, 3,
             ((-1, 0, -1.0), (0, -1, -1.0), (0, 0, 4.0), (0, 1, -1.0),
              (1, 0, -1.0)), 0),
        case("rows past the ring (dr 200)", 300, 600, 256, 512, far, 0),
        case("tc 512, the bench's tiles", 300, 700, 256, 512, mixed, 5),
        case("runs of rows longer than a step, with a partial last step",
             5000, 40, 8, 32, mixed, 5),
    ]


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil2d_kernel_layouts_on_card(dtype):
    """B7 bitwise equal to its twin, output poisoned first, the same bits
    over two launches, at each case of _b7_cases."""
    t2d.reset_launch_counts()
    cases = _b7_cases(dtype, "cuda")
    for name, coeffs, x, offsets, tr, tc, rp, cp, r, c in cases:
        args = (coeffs, x, offsets, tr, tc, rp, cp, r, c)
        torch.full_like(x, float("nan"))
        y = t2d.stencil_spmv_padded(*args)
        torch.full_like(x, float("nan"))
        y2 = t2d.stencil_spmv_padded(*args)
        yp = t2d.stencil_spmv_padded_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(y, yp), name
        assert torch.equal(y, y2), name
    assert t2d.stencil_spmv_padded.launches == 2 * len(cases)


@pytest.mark.parametrize("kernel", ["B1", "B6", "B7"])
def test_stencil_cases_run_the_twins_on_cpu(kernel):
    """The card cases above on CPU tensors: the front ends take them (the
    layouts and terms pass their checks) and run the twins, counting no
    launch."""
    if kernel == "B1":
        tst.reset_launch_counts()
        for name, x, args in _b1_cases(torch.float64, "cpu"):
            assert torch.equal(tst.const_stencil_spmv_padded(x, *args),
                               tst.const_stencil_spmv_padded_plain(x, *args))
        assert tst.const_stencil_spmv_padded.launches == 0
    elif kernel == "B6":
        tst.reset_launch_counts()
        for name, x, (gap, *lay, base) in _b1_cases(torch.float64, "cpu"):
            for ws, with_self in (((x,), True), ((), True)):
                y, d = tst.const_stencil_spmv_dots_padded(
                    x, gap, ws, *lay, with_self, base)
                yp, dp = tst.const_stencil_spmv_dots_padded_plain(
                    x, gap, ws, *lay, with_self, base)
                assert torch.equal(y, yp) and torch.equal(d, dp), name
                assert torch.equal(y, tst.const_stencil_spmv_padded_plain(
                    x, gap, *lay, base)), name
        assert tst.const_stencil_spmv_dots_padded.launches == 0
    else:
        t2d.reset_launch_counts()
        for name, *args in _b7_cases(torch.float64, "cpu"):
            assert torch.equal(t2d.stencil_spmv_padded(*args),
                               t2d.stencil_spmv_padded_plain(*args))
        assert t2d.stencil_spmv_padded.launches == 0


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """A library is rebuilt when a header its source includes changes, and
    reused while neither changes (a copying "compiler" stands in for
    nvcc)."""
    import sys

    from cuda_mat_tpu_torch.utils import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    src, hdr = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text("source")
    hdr.write_text("header 1")
    cc = [sys.executable, "-c",
          "import shutil, sys; shutil.copy(sys.argv[-1], sys.argv[-2])"]
    p1, s1 = build.build_library(cc, str(src), "libk", [str(hdr)])
    p2, s2 = build.build_library(cc, str(src), "libk", [str(hdr)])
    assert p1 == p2 and s2 == 0.0
    hdr.write_text("header 2")
    p3, s3 = build.build_library(cc, str(src), "libk", [str(hdr)])
    assert p3 != p1 and s3 > 0.0


def _arrow(n):
    """Row 0 coupled to every row and every row to row 0, diagonally
    dominant: level 1 of L holds n - 1 rows (more than the grid's
    threads), and U's row 0 holds n - 1 entries (past the kernel's
    registers)."""
    i = np.arange(1, n)
    rows = np.concatenate([np.arange(n), i, np.zeros(n - 1, np.int64)])
    cols = np.concatenate([np.arange(n), np.zeros(n - 1, np.int64), i])
    vals = np.concatenate([np.full(n, 4.0), np.full(n - 1, -1.0 / n),
                           np.full(n - 1, -1.0 / n)])
    vals[0] = 4.0 * n
    return CSRMatrix.from_coo(COOMatrix(n, n, rows.astype(np.int32),
                                        cols.astype(np.int32), vals))


def _level_mats():
    from cuda_mat_tpu_torch.formats.reorder import permute_csr

    g = tprob.grid_laplacian(120, 90)
    return {
        "hpcg 20x18x16": tprob.hpcg27(20, 18, 16),
        "shuffled grid": permute_csr(g, np.random.default_rng(0).permutation(
            g.n).astype(np.int64)),
        "arrow": _arrow(40000),
    }


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
@pytest.mark.parametrize("name", ["hpcg 20x18x16", "shuffled grid", "arrow"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_level_sweep_kernel_matches_twin_on_card(dtype, name):
    """B8 (both sweeps and the msolve) against its plain twin on the same
    plans, within 1e-12 (f64) / 1e-5 (f32) of max|twin| (the twin's row
    sums come from torch's gather and index_add), two launches bitwise
    equal, one launch a sweep."""
    from cuda_mat_tpu_torch.ops import level_trisolve as tlv

    a = _level_mats()[name]
    m = ilu0_factorize(a)
    tri = tlv.LevelTriSolver.from_factor(a, m, dtype=dtype, device="cuda")
    tri_cpu = tlv.LevelTriSolver.from_factor(a, m, dtype=dtype, device="cpu")
    f = torch.from_numpy(np.random.default_rng(2).standard_normal(a.n)).to(
        dtype)
    bound = {torch.float32: 1e-5, torch.float64: 1e-12}[dtype]
    tlv.reset_launch_counts()
    for what, sweeps in (("solve_lower", 1), ("solve_upper", 1),
                         ("msolve", 2)):
        before = tlv.level_sweep.launches
        y1 = getattr(tri, what)(f.cuda())
        y2 = getattr(tri, what)(f.cuda())
        torch.cuda.synchronize()
        assert tlv.level_sweep.launches - before == 2 * sweeps
        want = getattr(tri_cpu, what)(f)
        assert torch.equal(y1, y2), what
        err = float((y1.cpu() - want).abs().max())
        assert err <= bound * float(want.abs().max()), (what, err)
