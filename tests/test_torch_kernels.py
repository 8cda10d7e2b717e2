"""Dispatch of the kernel front ends, and the kernels themselves on a card.

On the CPU a front end runs its plain twin and never counts a launch.  Any
other tensor goes to the kernel or raises: a failed build is never hidden
by a fallback.  The ``gpu`` tests compare each CUDA kernel with its twin
and skip without a card: the stencil kernels B1/B2 and the banded DIA SpMV
B3 bit for bit (they round every product and sum on its own, as the twins
do), the banded trisolve
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
