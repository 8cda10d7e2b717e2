"""Dispatch of the kernel front ends, and the kernels themselves on a card.

On the CPU a front end runs its plain twin and never counts a launch.  Any
other tensor goes to the kernel or raises: a failed build is never hidden
by a fallback.  The ``gpu`` tests compare each CUDA kernel with its twin
and skip without a card: the stencil kernels B1/B2/B5/B6, the 2-D stencil
B7 and the banded DIA SpMV B3 bit for bit (they round every product and
sum on its own, as the twins do; B6's dots are the twin's tree), the
banded trisolve
kernels B4a/B4b to 1e-12 (f64) and 1e-5 (f32) of max|twin| (they sum in
another order than the twin's torch.matmul).
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

torch.set_num_threads(1)


def _setup(r=64, c=64, k=4, dtype=torch.float64, device="cpu"):
    a = tprob.grid_laplacian(r, c)
    d = a.to_dia(max_diags=16)
    op0 = tst.ConstStencilOperator.from_dia(d, dtype=dtype)
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
    a = tprob.banded_laplacian(side)
    return a, ILU0Preconditioner.from_csr(a, block=block, dtype=dtype,
                                          device=device).tri


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
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tbt.banded_sweep_padded(meta, w, w, True)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tbt.fused_msolve_padded(meta, w, w, w, w)
    assert tbt.fused_msolve_padded.launches == 0
    assert tbt.banded_sweep_padded.launches == 0


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
    # a halo whose u tile still fits B2 but not B5's window beside it
    wide = tu + ((9000, 1.0),)
    assert _kernels.msolve_fits(1 << 17, tl, wide, 8)
    assert not _kernels.msolve_fma_fits(1 << 17, tl, wide, 8)


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


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
@pytest.mark.parametrize("side,block", [(30, 32), (30, 64), (100, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trisolve_kernels_match_twins_on_card(dtype, side, block):
    a, tri = _tri(side, block, dtype, "cuda")
    f = tri._pad(torch.from_numpy(
        np.random.default_rng(1).standard_normal(a.n)).to("cuda"))
    bound = {torch.float32: 1e-5, torch.float64: 1e-12}[dtype]
    tbt.reset_launch_counts()
    cases = [
        (lambda: tbt.banded_sweep_padded(f, tri.wt_lo, tri.wct_lo, True),
         lambda: tbt.banded_sweep_padded_plain(f, tri.wt_lo, tri.wct_lo,
                                               True)),
        (lambda: tbt.banded_sweep_padded(f, tri.wt_up, tri.wct_up, False),
         lambda: tbt.banded_sweep_padded_plain(f, tri.wt_up, tri.wct_up,
                                               False)),
        (lambda: tbt.fused_msolve_padded(f, tri.wt_lo, tri.wct_lo, tri.wt_up,
                                         tri.wct_up),
         lambda: tbt.fused_msolve_padded_plain(f, tri.wt_lo, tri.wct_lo,
                                               tri.wt_up, tri.wct_up))]
    for kern, plain in cases:
        torch.full_like(f, float("nan"))
        yk = kern()
        yp = plain()
        torch.cuda.synchronize()
        assert torch.isfinite(yk).all()
        assert (yk - yp).abs().max() <= bound * yp.abs().max()
        assert torch.count_nonzero(yk[a.n:]) == 0
    # B4a runs B4b forward and backward: two sweeps of its own
    assert tbt.banded_sweep_padded.launches == 4
    assert tbt.fused_msolve_padded.launches == 1


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
    for c1, c2 in [(0.73, -1.21), (-0.4, 0.0), (0.0, 5.0)]:
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
