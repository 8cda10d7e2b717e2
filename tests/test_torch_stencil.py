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
from cuda_mat_tpu_torch.ops import stencil as tst

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
