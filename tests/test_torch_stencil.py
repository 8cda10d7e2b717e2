"""Kernel B1 (constant-stencil SpMV) of the PyTorch port against the JAX
Pallas kernel it replaces, run in interpret mode on the CPU.

The two packages choose the same gap-strided layout by construction (the
port carries a copy of the layout algebra), so padded vectors are compared
element for element and the matvec bitwise: the plain twin takes the same
products and sums in the same order as the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_mat_tpu.models.problems as jprob
from cuda_mat_tpu.ops import pallas_stencil as jst

import cuda_mat_tpu_torch.models.problems as tprob
from cuda_mat_tpu_torch.ops import _kernels as tk
from cuda_mat_tpu_torch.ops import stencil as tst
from cuda_mat_tpu_torch.precond.preconditioners import NeumannILUPreconditioner

torch.set_num_threads(1)

GRIDS = [("grid", 24, 126), ("grid", 17, 30), ("grid", 40, 12),
         ("grid", 8, 100), ("lap9", 30, 30)]


def _pair(kind, r, c):
    if kind == "grid":
        a_j, a_t = jprob.grid_laplacian(r, c), tprob.grid_laplacian(r, c)
    else:
        a_j, a_t = jprob.laplacian_2d(r), tprob.laplacian_2d(r)
    op_j = jst.ConstStencilOperator.from_dia(
        a_j.to_dia(max_diags=16), dtype=jnp.float64, interpret=True)
    op_t = tst.ConstStencilOperator.from_dia(
        a_t.to_dia(max_diags=16), dtype=torch.float64, device="cpu")
    return a_t, op_j, op_t


@pytest.mark.parametrize("kind,r,c", GRIDS)
def test_layouts_identical(kind, r, c):
    _, op_j, op_t = _pair(kind, r, c)
    for f in ("terms", "strided_terms", "c_grid", "stride", "n", "np_true",
              "npad", "block", "sub"):
        assert getattr(op_j, f) == getattr(op_t, f), f
    assert np.array_equal(np.asarray(op_j.gapmask), op_t.gapmask.numpy())


@pytest.mark.parametrize("kind,r,c", GRIDS)
def test_spmv_plain_matches_pallas_bitwise(kind, r, c):
    a, op_j, op_t = _pair(kind, r, c)
    x = np.random.default_rng(7).standard_normal(a.n)
    xp_j = op_j.pad_vec(x)
    xp_t = op_t.pad_vec(x)
    assert np.array_equal(np.asarray(xp_j), xp_t.numpy())
    y_j = np.asarray(op_j.matvec(xp_j))
    y_t = op_t.matvec(xp_t).numpy()
    assert np.array_equal(y_j, y_t), np.abs(y_j - y_t).max()
    # and it is A x on the true coordinates
    np.testing.assert_allclose(op_t.unpad_vec(torch.from_numpy(y_t)).numpy(),
                               a.matvec(x), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("kind,r,c", GRIDS)
def test_pad_roundtrip_and_zero_pads(kind, r, c):
    a, _, op_t = _pair(kind, r, c)
    x = np.random.default_rng(3).standard_normal(a.n)
    xp = op_t.pad_vec(x)
    assert np.array_equal(op_t.unpad_vec(xp).numpy(), x)
    y = op_t.matvec(xp)
    # pads, gaps and the tail of the output are exact zeros: the padded
    # vector is a fixed point of the layout
    assert torch.equal(y, op_t.pad_vec(op_t.unpad_vec(y)))
    assert torch.count_nonzero(y[:op_t.block]) == 0
    assert torch.count_nonzero(y[op_t.block + op_t.np_true:]) == 0


@pytest.mark.parametrize("base", [0, 1000, 3000])
def test_spmv_base_tail_matches_pallas(base):
    """``base`` shifts the global strided row of the tail mask (the
    per-shard offset of the distributed layout)."""
    _, op_j, op_t = _pair("grid", 17, 30)
    x = np.random.default_rng(5).standard_normal(op_t.npad + 2 * op_t.block)
    y_j = np.asarray(jst.const_stencil_spmv_padded(
        jnp.asarray(x), op_j.gapmask, op_j.strided_terms, op_j.np_true,
        op_j.block, op_j.sub, interpret=True,
        base=jnp.asarray([base], jnp.int32)))
    y_t = tst.const_stencil_spmv_padded(
        torch.from_numpy(x), op_t.gapmask, op_t.strided_terms, op_t.np_true,
        op_t.block, op_t.sub, base=base).numpy()
    assert np.array_equal(y_j, y_t)


def test_spmv_rejects_bad_layout():
    _, _, op_t = _pair("grid", 17, 30)
    x = torch.zeros(op_t.npad + 2 * op_t.block + 1, dtype=torch.float64)
    with pytest.raises(ValueError):
        op_t.matvec(x)
    with pytest.raises(ValueError):
        tst.const_stencil_spmv_padded(
            torch.zeros(op_t.npad + 2 * op_t.block, dtype=torch.float64),
            op_t.gapmask, ((op_t.sub + 1, 1.0),), op_t.np_true, op_t.block,
            op_t.sub)


# ---------------------------------------------------------------------------
# Kernel B1's launch geometry (ops/_kernels.spmv_plan) at the layouts the
# paths use, and its 32-bit guard
# ---------------------------------------------------------------------------

def _lap_terms(c):
    return ((-c, 0, -1.0), (-1, -1, -1.0), (0, 0, 4.0), (1, 1, -1.0),
            (c, 0, -1.0))


def _path_layouts():
    """(name, npad, block, reach) of B1 on the paths chip_smoke.py drives:
    the flagship's Neumann layout and its fuse_blas1 layout, the plain
    layouts of the 10M, 1M and 3163² grids, the mat10000 grid, and mono's
    37 terms on mat10000's Neumann layout."""
    out = []
    for r, c in ((100000, 100), (10000, 100), (3163, 3163), (100, 100)):
        terms = _lap_terms(c)
        stride, sub, block, np_true, npad, st_ = tst.stencil_layout(
            c, r * c, terms)
        out.append((f"{r}x{c}", npad, block, max(abs(t[0]) for t in st_)))
    for name, kw in (("flagship", {}), ("fuse_blas1", {"fuse_blas1": True})):
        min_sub, cap, _ = tst.plan_const_neumann_layout(
            _lap_terms(100), 4, 100, 128, **kw)
        stride, sub, block, np_true, npad, st_ = tst.stencil_layout(
            100, 100000 * 100, _lap_terms(100), cap, min_sub)
        out.append((name, npad, block, max(abs(t[0]) for t in st_)))
    a = tprob.grid_laplacian(100, 100)
    op0 = tst.ConstStencilOperator.from_dia(a.to_dia(max_diags=16),
                                            device="cpu")
    min_sub, cap, _ = tst.plan_const_neumann_layout(
        op0.terms, 4, op0.c_grid, op0.stride, prefer_mono=True)
    op = tst.ConstStencilOperator.from_dia(a.to_dia(max_diags=16),
                                           device="cpu", min_sub=min_sub,
                                           block_target=cap)
    mono = NeumannILUPreconditioner.from_csr(a, terms=4, pad_like=op,
                                             prefer_mono=True,
                                             milu_omega=0.96)
    assert mono.fused == "mono"
    out.append(("mono", op.npad, op.block,
                max(abs(t[0]) for t in mono.nl.strided_terms)))
    return out


@pytest.mark.parametrize("itemsize", [4, 8])
def test_spmv_plan_at_the_path_layouts(itemsize):
    """Every layout the paths give B1 gets a ring that covers all its
    terms (no term reads device memory), whole 4-8 KB tiles that divide
    the layout's block, at least two stages loading ahead, shared memory
    within a block's limit and blocks that all fit on the card at once."""
    layouts = _path_layouts()
    assert {n: b for n, _, b, _ in layouts}["flagship"] == 104448
    assert {n: b for n, _, b, _ in layouts}["fuse_blas1"] == 88064
    for name, npad, block, reach in layouts:
        p = tk.spmv_plan(npad, block, reach, itemsize, 132)
        assert p.vec == 16 // itemsize
        assert p.tile & (p.tile - 1) == 0 and block % p.tile == 0, name
        assert 4096 <= p.tile * itemsize <= 8192, name
        assert reach <= p.halo * p.tile <= block, name
        assert p.stages >= 2 * p.halo + 3, name
        assert p.smem == (p.stages + 2) * p.tile * itemsize + 8 * p.stages
        assert p.smem <= tk.SMEM_LIMIT - tk.STATIC_SMEM, name
        per_sm = -(-p.ctas // 132)
        assert 1 <= p.ctas <= npad // p.tile and per_sm <= 4, name
        assert per_sm * (p.smem + tk.STATIC_SMEM + tk.SMEM_RESERVED) \
            <= tk.SMEM_PER_SM, name
    flag = [lay for lay in layouts if lay[0] == "flagship"][0]
    if itemsize == 4:
        assert tk.spmv_plan(*flag[1:], 4, 132) == tk.SpmvPlan(
            2048, 1, 5, 396, 57384, 4)


def test_spmv_plan_shrinks_a_ring_that_does_not_fit():
    """Terms far past what shared memory holds: the ring's halo shrinks
    until it fits, and those terms read device memory."""
    p = tk.spmv_plan(409600, 409600, 4 * 3200, 8, 132)
    assert p.halo * p.tile < 4 * 3200
    assert p.smem <= tk.SMEM_LIMIT - tk.STATIC_SMEM
    with pytest.raises(ValueError, match="multiples"):
        tk.spmv_plan(3000, 1500, 10, 4, 132)


def test_spmv_front_end_refuses_64_bit_lengths():
    """A padded vector of 2^31 elements or more needs 64-bit indices: the
    front end raises before building or launching anything (a meta tensor
    stands in for a CUDA one; it allocates nothing)."""
    block = 1 << 20
    x = torch.empty(2049 * block, dtype=torch.float32, device="meta")
    assert x.shape[0] >= 2 ** 31
    gap = torch.empty(block, dtype=torch.float32, device="meta")
    tst.reset_launch_counts()
    with pytest.raises(ValueError, match="32-bit"):
        tst.const_stencil_spmv_padded(x, gap, ((0, 1.0),), 2047 * block,
                                      block, 1024)
    assert tst.const_stencil_spmv_padded.launches == 0
