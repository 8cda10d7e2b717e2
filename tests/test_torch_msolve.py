"""Kernel B2 (fused Neumann-ILU msolve) of the PyTorch port against the JAX
package's fused Pallas kernel (interpret mode) on the cases of
test_neumann.py's bitwise kernel test, with ILU(0) and relaxed MILU(0)
factors, in float64.

Tolerance: 1e-14 of max|y|, for two reasons.  XLA's CPU backend compiles
the interpret-mode kernel body with fused multiply-adds, while the port's
twin (and its CUDA kernel) rounds every product and sum on its own: with
the series' general coefficients 42% of a 5-term stencil's outputs differ
in the last bit (kernel B1 on the Laplacian itself stays bitwise, since
its coefficients 4, -1 and 8 make every product exact).  And the factor
values come from two builds of the same native factorizer: the JAX
package's is built with -march=native, where g++ may contract MILU's
dropped-fill updates into FMAs, and the port's without (measured up to
1.8e-15 apart).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_mat_tpu.models.problems as jprob
from cuda_mat_tpu.ops import pallas_stencil as jst
from cuda_mat_tpu.precond import preconditioners as jpre

import cuda_mat_tpu_torch.models.problems as tprob
from cuda_mat_tpu_torch.ops import stencil as tst
from cuda_mat_tpu_torch.precond import preconditioners as tpre

torch.set_num_threads(1)

CASES = [(24, 126, 3), (17, 30, 3), (40, 12, 4), (8, 100, 5)]


def _planned_ops(r, c, k):
    a_j, a_t = jprob.grid_laplacian(r, c), tprob.grid_laplacian(r, c)
    d_j, d_t = a_j.to_dia(max_diags=16), a_t.to_dia(max_diags=16)
    op0 = jst.ConstStencilOperator.from_dia(d_j, dtype=jnp.float64,
                                            interpret=True)
    plan = jst.plan_const_neumann_layout(op0.terms, k, op0.c_grid, op0.stride)
    assert plan == tst.plan_const_neumann_layout(op0.terms, k, op0.c_grid,
                                                 op0.stride)
    # no plan: the series cannot fuse, and the first layout stays
    kw = {} if plan is None else dict(min_sub=plan[0], block_target=plan[1])
    op_j = jst.ConstStencilOperator.from_dia(d_j, dtype=jnp.float64,
                                             interpret=True, **kw)
    op_t = tst.ConstStencilOperator.from_dia(d_t, dtype=torch.float64,
                                             device="cpu", **kw)
    return a_j, a_t, op_j, op_t


@pytest.mark.parametrize("omega", [0.0, 0.96])
@pytest.mark.parametrize("r,c,k", CASES)
def test_msolve_matches_pallas_kernel(r, c, k, omega):
    a_j, a_t, op_j, op_t = _planned_ops(r, c, k)
    pre_j = jpre.NeumannILUPreconditioner.from_csr(
        a_j, dtype=jnp.float64, terms=k, pad_like=op_j, milu_omega=omega)
    pre_t = tpre.NeumannILUPreconditioner.from_csr(
        a_t, terms=k, pad_like=op_t, milu_omega=omega)
    assert pre_j.fused == "kernel" and pre_t.fused == "kernel"
    for p_j, p_t in ((pre_j.nl, pre_t.nl), (pre_j.nu, pre_t.nu)):
        assert [t[0] for t in p_j.strided_terms] == \
            [t[0] for t in p_t.strided_terms]
        np.testing.assert_allclose([t[1] for t in p_t.strided_terms],
                                   [t[1] for t in p_j.strided_terms],
                                   rtol=1e-14)
    x = np.random.default_rng(11).standard_normal(a_t.n)
    y_j = np.asarray(pre_j.msolve(op_j.pad_vec(x)))
    y_t = pre_t.msolve(op_t.pad_vec(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=0,
                               atol=1e-14 * np.abs(y_j).max())
    # pads, gaps and tail are exact zeros in both
    assert np.array_equal(y_t == 0, y_j == 0)


@pytest.mark.parametrize("r,c,k", CASES)
def test_series_fallback_equals_kernel_mode(r, c, k):
    """As test_neumann.py's JAX check: the two-launch series (kernel B1 on
    P_l and P_u) equals the one-launch fused msolve bitwise."""
    _, a_t, _, op_t = _planned_ops(r, c, k)
    pre = tpre.NeumannILUPreconditioner.from_csr(
        a_t, terms=k, pad_like=op_t, milu_omega=0.96)
    assert pre.fused == "kernel"
    seq = dataclasses.replace(pre, fused="series", gap_ext=None)
    f = op_t.pad_vec(np.random.default_rng(2).standard_normal(a_t.n))
    yk, ys = pre.msolve(f), seq.msolve(f)
    assert torch.equal(yk, ys)
    assert torch.equal(yk, op_t.pad_vec(op_t.unpad_vec(yk)))


def test_sequential_series_matches_jax():
    """A grid whose series exceeds the gap width (C=126, stride 128, k=4)
    falls back to the sequential series in both packages."""
    a_j, a_t, op_j, op_t = _planned_ops(40, 126, 4)
    pre_j = jpre.NeumannILUPreconditioner.from_csr(
        a_j, dtype=jnp.float64, terms=4, pad_like=op_j)
    pre_t = tpre.NeumannILUPreconditioner.from_csr(
        a_t, terms=4, pad_like=op_t)
    assert pre_j.fused is False and pre_t.fused is False
    x = np.random.default_rng(4).standard_normal(a_t.n)
    y_j = np.asarray(pre_j.msolve(op_j.pad_vec(x)))
    y_t = pre_t.msolve(op_t.pad_vec(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=0,
                               atol=1e-14 * np.abs(y_j).max())
