"""The distributed solver on each device, the card's cases marked ``gpu``.

This file imports only the port, so it also runs on a machine without JAX
(``python -m pytest --noconftest -m gpu tests/test_torch_parallel_card.py``
on a card); the ``cuda`` cases skip without one.  On a mesh of 1-8 shards
of one device: ``dist_spmv`` within 1e-12 (f64) / 1e-5 (f32) of max|y| of
the host f64 product, the overlapped matvec bitwise equal to the unsplit
one, two solves bitwise equal, every preconditioner converged to the true
relative residual its tolerance gives, the card's counts within ±6 of the
CPU's and x within 1e-6 (the card sums the dots in another order: the
ROADMAP's card-against-CPU slack for unpreconditioned and Jacobi solves;
an H100 read 90 for Jacobi and 44 for block-Jacobi against the CPU's 87
and 39; one f64 ulp of one entry of b, a change of rounding alone, moves
the JAX package's CPU count over 86..93 and 38..45 and the port's over
86..96 and 39..44, over b and 15 such changes:
``tests/test_torch_parallel_scan.py card-slack 16``), block-Jacobi's batched
sweep within 1e-12 of one shard's sweep a shard.  On the CPU "auto" is the
"xla" engine, stock torch ops, and no kernel of this repository launches;
on the card it is a kernel engine (banded_laplacian(40) is a constant
stencil: B1, and B3 for block-Jacobi), whose kernels carry the solve.

The kernel engines' batched front ends on the card (B1, B2, B5 and B3 on
a batch of S = 1, 2 and 8 shards with a base past 0, random pad blocks):
bit for bit their twins, in one launch a call.
"""

import numpy as np
import pytest
import torch

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.models.problems as tprob
from cuda_mat_tpu_torch.ops import banded_trisolve as bt
from cuda_mat_tpu_torch.ops import dia_spmv as ds
from cuda_mat_tpu_torch.ops import stencil as st
from cuda_mat_tpu_torch.ops import stencil2d as t2d
from cuda_mat_tpu_torch.ops.trisolve import BlockTriangularSolver
from cuda_mat_tpu_torch.parallel import (dist_bicgstab, dist_spmv,
                                         make_dist_bicgstab, make_mesh)
from cuda_mat_tpu_torch.parallel.collectives import ShardComm
from cuda_mat_tpu_torch.parallel.dist_precond import (build_block_jacobi_ilu,
                                                      local_solver_from_stacked)
from cuda_mat_tpu_torch.parallel.dist_solver import (_make_local_matvec,
                                                     fetch_global, put_global)
from cuda_mat_tpu_torch.parallel.partition import RowPartitionedBanded

torch.set_num_threads(1)

ON_CARD = pytest.param("cuda", marks=[
    pytest.mark.gpu,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs a CUDA card")])
DEVICES = ["cpu", ON_CARD]
PRECONDS = ("none", "jacobi", "bjacobi_ilu0", "ilu0_neumann")
CARD_CPU = 6        # iterations, card against CPU


def _launches():
    fronts = (st.const_stencil_spmv_padded, st.const_series_msolve_padded,
              st.const_series_msolve_fma_padded,
              st.const_stencil_spmv_dots_padded, bt.fused_msolve_padded,
              bt.banded_sweep_padded, ds.dia_spmv_block_padded,
              t2d.stencil_spmv_padded)
    return sum(f.launches for f in fronts)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_dist_spmv_against_host(ndev, dtype, tol, device):
    a = tprob.banded_laplacian(40)
    x = np.random.default_rng(1).standard_normal(a.n)
    y = dist_spmv(a, x, make_mesh(ndev, device=device), dtype=dtype)
    ref = a.matvec(x)
    assert np.abs(y - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("device", DEVICES)
def test_overlap_split_is_bitwise(device):
    a = tprob.banded_laplacian(40)
    mesh = make_mesh(4, device=device)
    part = RowPartitionedBanded.from_matrix(a, 4)
    data = put_global(part.data, mesh, torch.float32, axis=1)
    x = put_global(part.pad_vector(
        np.random.default_rng(2).standard_normal(a.n)), mesh, torch.float32)
    out = [_make_local_matvec(part.offsets, part.halo, part.shard_rows,
                              ShardComm(mesh), overlap=ov)(data, x)
           for ov in (False, True)]
    assert torch.equal(out[0], out[1])
    assert fetch_global(out[0], mesh).shape == (part.npad,)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("precond", PRECONDS)
def test_solves_converge_twice_bitwise(precond, device):
    a = tprob.banded_laplacian(40)
    b = np.random.default_rng(3).uniform(1.0, 5.0, a.n)
    cfg = ct.SolverConfig(maxit=2000, tol=1e-8, precond=precond,
                          trisolve_block=64)
    n0 = _launches()
    ds_ = make_dist_bicgstab(a, make_mesh(4, device=device), cfg)
    r1, r2 = ds_.solve(b), ds_.solve(b)
    if device == "cpu":
        assert ds_.engine == "xla" and _launches() == n0
    else:
        assert ds_.engine == ("pallas" if precond == "bjacobi_ilu0"
                              else "stencil")
        assert _launches() - n0 >= 2 * r1.iters
    assert r1.converged and r1.residual_true / np.linalg.norm(b) < 1e-7
    assert r1.iters == r2.iters and np.array_equal(r1.x, r2.x)
    if device != "cpu":
        rc = dist_bicgstab(a, b, make_mesh(4, device="cpu"), cfg)
        assert abs(r1.iters - rc.iters) <= CARD_CPU
        np.testing.assert_allclose(r1.x, rc.x, rtol=1e-6)


@pytest.mark.parametrize("device", DEVICES)
def test_stacked_sweep_equals_each_shards_own(device):
    a = tprob.banded_laplacian(40)
    part = RowPartitionedBanded.from_matrix(a, 4)
    stacked = build_block_jacobi_ilu(part, 64, torch.float64)
    tri = local_solver_from_stacked(
        *(torch.from_numpy(s).to(device) for s in stacked), part.shard_rows,
        64)
    f = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, part.shard_rows))).to(device)
    got = tri.msolve(f)
    for k in range(4):
        one = BlockTriangularSolver(
            *(torch.from_numpy(s[k]).to(device) for s in stacked[:2]),
            torch.from_numpy(stacked[2][k]).to(device),
            *(torch.from_numpy(s[k]).to(device) for s in stacked[3:5]),
            torch.from_numpy(stacked[5][k]).to(device),
            n=part.shard_rows, block=64)
        want = one.msolve(f[k])
        assert float((got[k] - want).abs().max()) <= \
            1e-12 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_mesh_defaults_to_the_card():
    m = make_mesh(8)
    assert m.device == torch.device("cuda", 0) and m.local == 8


CARD = [pytest.mark.gpu, pytest.mark.skipif("not torch.cuda.is_available()",
                                            reason="needs a CUDA card")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shards", [1, 2, 8])
@pytest.mark.parametrize("kernel", ["B1", "B2", "B5", "B3"])
@pytest.mark.parametrize("_", [pytest.param(0, marks=CARD)])
def test_batched_front_ends_match_twins_on_card(kernel, shards, dtype, _):
    """One launch on S shards at base 4096 (the tail inside the last
    shard), random pads: the kernel equals its twin bit for bit."""
    block, npad, base = 4096, 8192, 4096
    np_true = base + (shards - 1) * npad + 3000
    rng = np.random.default_rng(21)
    shape = (shards, npad + 2 * block)
    x, a, b, c, d = (torch.from_numpy(rng.standard_normal(shape)).to(dtype)
                     for _ in range(5))
    d = d.abs() + 0.5
    gap = torch.ones(block, dtype=dtype)
    gap.view(-1, 128)[:, 100:] = 0
    ext = torch.cat([gap[-1024:], gap, gap[:1024]])
    tl = ((-300, 0.5), (-1, -1.0), (0, 4.0), (2, -1.0), (129, 0.25))
    tu = ((-130, 0.3), (0, 1.0), (1, -0.5), (257, 0.7))
    offsets = (-129, -1, 0, 1, 129)
    data = torch.from_numpy(rng.standard_normal(
        (len(offsets), shards, npad))).to(dtype)

    def call(dev):
        g = gap.to(dev)
        if kernel == "B1":
            return (st.const_stencil_spmv_padded(x.to(dev), g, tl, np_true,
                                                 block, 1024, base),)
        if kernel == "B2":
            return (st.const_series_msolve_padded(
                x.to(dev), d.to(dev), ext.to(dev), tl, tu, np_true, block,
                1024, base),)
        if kernel == "B5":
            return st.const_series_msolve_fma_padded(
                a.to(dev), torch.tensor(0.37, dtype=dtype, device=dev),
                b.to(dev), torch.tensor(-1.9, dtype=dtype, device=dev),
                c.to(dev), d.to(dev), ext.to(dev), tl, tu, np_true, block,
                1024, base)
        return (ds.dia_spmv_block_padded(data.to(dev), x.to(dev), offsets,
                                         block, 1024),)

    n0 = _launches()
    got = call("cuda")
    torch.cuda.synchronize()
    assert _launches() - n0 == 1
    for g, want in zip(got, call("cpu")):
        assert torch.equal(g.cpu(), want), kernel


@pytest.mark.parametrize("engine,name", [("stencil", "grid"),
                                         ("pallas", "band")])
@pytest.mark.parametrize("_", [pytest.param(0, marks=CARD)])
def test_kernel_engines_on_card(engine, name, _):
    """The kernel engines on 8 shards of the card: the SpMV within 1e-12 of
    max|y| of the host product (f64); Jacobi and the Neumann series (on the
    stencil the const factors' fused msolve), solved twice bitwise, x
    within 1e-6 of the same engine on the CPU, the counts within the JAX
    package's own card-free bands for these solves (tests/test_parallel.py:
    10% for the ~200 iterations of Jacobi on the grid, :442; max(3, 15%)
    for the Neumann series, :589; an H100 read Jacobi 223 on the grid
    against the CPU's 205); kernels launched."""
    if name == "grid":
        a = tprob.grid_laplacian(64, 126)
    else:
        lap = tprob.banded_laplacian(40)
        rows = np.repeat(np.arange(lap.n), np.diff(lap.indptr))
        a = ct.CSRMatrix(lap.n, lap.m, np.where(
            lap.indices == rows, lap.data * (1.0 + rows / lap.n), lap.data),
            lap.indices, lap.indptr)
    x = np.random.default_rng(6).standard_normal(a.n)
    y = dist_spmv(a, x, make_mesh(8, device="cuda"), local_engine=engine)
    ref = a.matvec(x)
    assert np.abs(y - ref).max() <= 1e-12 * np.abs(ref).max()
    b = np.random.default_rng(7).uniform(1.0, 5.0, a.n)
    for precond in ("jacobi", "ilu0_neumann"):
        cfg = ct.SolverConfig(maxit=2000, tol=1e-8, precond=precond,
                              neumann_terms=3)
        n0 = _launches()
        ds_ = make_dist_bicgstab(a, make_mesh(8, device="cuda"), cfg,
                                 local_engine=engine)
        r1, r2 = ds_.solve(b), ds_.solve(b)
        assert _launches() - n0 >= 4 * r1.iters
        assert r1.converged and r1.iters == r2.iters
        assert np.array_equal(r1.x, r2.x)
        rc = dist_bicgstab(a, b, make_mesh(8, device="cpu"), cfg,
                           local_engine=engine)
        band = 0.10 if precond == "jacobi" else 0.15
        assert abs(r1.iters - rc.iters) <= max(3, band * rc.iters)
        np.testing.assert_allclose(r1.x, rc.x, rtol=1e-6)
