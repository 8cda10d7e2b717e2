"""The port's distributed solver (``cuda_mat_tpu_torch.parallel``, the JAX
package's ``local_engine="xla"``) against the JAX package on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py, the
port on ``make_mesh(n, device="cpu")``: n row shards in this process.  The
cases are the "xla"-engine cases of tests/test_parallel.py on its inputs
(``banded_laplacian(40)``: n 1600, w 40; b uniform in [1, 5) from the seed
42 stream), in f64.  Tolerances:

- partitions: bit for bit equal to the JAX package's;
- SpMV: rtol 1e-12 against the host product and against the JAX
  ``dist_spmv``;
- solves: the status of the JAX distributed solve on the same mesh size,
  iterations within ±5 of it and within ±5 of the numpy oracle (f64
  trajectories part from the last bit; the summation order of the dots
  differs between the packages), x within rtol 1e-6 of the single-device
  solve;
- block-Jacobi ILU(0) on one shard: within ±1 iteration of global ILU(0);
- the overlapped (interior, then edge rows) matvec: bitwise equal to the
  unsplit one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_mat_tpu as cm
import cuda_mat_tpu.parallel as jp
from cuda_mat_tpu.config import SolverConfig as JConfig
from cuda_mat_tpu.formats.csr import CSRMatrix as JCSR
from cuda_mat_tpu.models import problems as jprob
from cuda_mat_tpu.parallel import partition as jpart
from cuda_mat_tpu.parallel.dist_solver import make_dist_spmv as j_make_spmv
from cuda_mat_tpu.reference.cpu_solvers import bicgstab_hform_cpu

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.parallel as tp
from cuda_mat_tpu_torch.convert import partition_from_numpy
from cuda_mat_tpu_torch.parallel import partition as tpart
from cuda_mat_tpu_torch.parallel.collectives import ShardComm
from cuda_mat_tpu_torch.parallel.dist_solver import (_make_local_matvec,
                                                     fetch_global,
                                                     make_dist_spmv,
                                                     put_global)

torch.set_num_threads(1)

ITERS = 5           # iteration slack against the oracle and the JAX solve
RTOL_X = 1e-6       # x against the single-device solve
SPMV_RTOL = 1e-12


def _port(a):
    return ct.CSRMatrix(a.n, a.m, a.data, a.indices, a.indptr)


def _mesh(n):
    return tp.make_mesh(n, device="cpu")


@pytest.fixture(scope="module")
def lap():
    return jprob.banded_laplacian(40)  # n=1600, w=40


@pytest.fixture(scope="module")
def b(lap):
    return np.random.default_rng(42).uniform(1.0, 5.0, lap.n)


def _rel(a, b, x):
    return np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b)


def _both(a, b, n, cfg_kw, **kw):
    """The JAX and the port's distributed solves of one configuration."""
    rj = jp.dist_bicgstab(a, b, jp.make_mesh(n), JConfig(**cfg_kw), **kw)
    rt = tp.dist_bicgstab(_port(a), b, _mesh(n), ct.SolverConfig(**cfg_kw),
                          **kw)
    assert rt.status == rj.status, (rt.status, rj.status)
    assert abs(rt.iters - rj.iters) <= ITERS, (rt.iters, rj.iters)
    return rj, rt


# -- partitions --------------------------------------------------------------


def _same_partition(pj, pt):
    assert type(pt).__name__ == type(pj).__name__
    fj, ft = dataclasses.asdict(pj), dataclasses.asdict(pt)
    assert set(fj) == set(ft)
    for k, v in fj.items():
        if isinstance(v, np.ndarray):
            assert ft[k].dtype == v.dtype and np.array_equal(ft[k], v), k
        else:
            assert ft[k] == v, k


def test_partition_plan(lap):
    part = tpart.RowPartitionedBanded.from_matrix(_port(lap), 8)
    assert part.npad == 1600 and part.shard_rows == 200 and part.halo == 40
    part2 = tpart.RowPartitionedBanded.from_matrix(
        _port(jprob.banded_laplacian(13)), 8)  # n=169
    assert part2.npad == 176
    k0 = part2.offsets.index(0)
    np.testing.assert_array_equal(part2.data[k0, 169:], 1.0)


@pytest.mark.parametrize("side,ndev,align", [(40, 8, 1), (13, 8, 1),
                                             (13, 3, 16), (40, 1, 1)])
def test_banded_partition_is_jax_bit_for_bit(side, ndev, align):
    a = jprob.banded_laplacian(side)
    pj = jpart.RowPartitionedBanded.from_matrix(a, ndev, align=align)
    pt = tpart.RowPartitionedBanded.from_matrix(_port(a), ndev, align=align)
    _same_partition(pj, pt)
    _same_partition(pj, partition_from_numpy(dataclasses.asdict(pj)))
    # a DIA input too
    _same_partition(jpart.RowPartitionedBanded.from_matrix(a.to_dia(), ndev),
                    tpart.RowPartitionedBanded.from_matrix(
                        _port(a).to_dia(), ndev))


def test_factor_partition_is_jax_bit_for_bit(lap):
    """N_l and N_u have no main diagonal: each partition adds a zero one
    with identity pad rows, as the JAX package's does."""
    from cuda_mat_tpu.precond.preconditioners import neumann_factors as jnf

    from cuda_mat_tpu_torch.precond.preconditioners import \
        neumann_factors as tnf

    for fj, ft in zip(jnf(lap)[:2], tnf(_port(lap))[:2]):
        _same_partition(jpart.RowPartitionedBanded.from_matrix(fj, 8),
                        tpart.RowPartitionedBanded.from_matrix(ft, 8))


@pytest.mark.parametrize("ndev", [3, 8])
def test_ell_partition_is_jax_bit_for_bit(ndev):
    a = JCSR.from_dense(jprob.gen_rand_csr_matrix(
        50, 50, 0.8, 0.5, 2.0, seed=3).to_dense() + 30 * np.eye(50))
    pj = jpart.RowPartitionedELL.from_matrix(a, ndev)
    _same_partition(pj, tpart.RowPartitionedELL.from_matrix(_port(a), ndev))
    _same_partition(pj, partition_from_numpy(dataclasses.asdict(pj)))


def test_partition_rejects_wide_band():
    a = jprob.banded_laplacian(4)  # n=16, w=4 > 2
    with pytest.raises(ValueError) as ej:
        jpart.RowPartitionedBanded.from_matrix(a, 8)
    with pytest.raises(ValueError) as et:
        tpart.RowPartitionedBanded.from_matrix(_port(a), 8)
    assert str(et.value) == str(ej.value)


# -- SpMV --------------------------------------------------------------------


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_dist_spmv_matches_host_and_jax(lap, ndev):
    x = np.random.default_rng(42).standard_normal(lap.n)
    y = tp.dist_spmv(_port(lap), x, _mesh(ndev))
    np.testing.assert_allclose(y, lap.matvec(x), rtol=SPMV_RTOL,
                               atol=SPMV_RTOL)
    np.testing.assert_allclose(y, jp.dist_spmv(lap, x, jp.make_mesh(ndev)),
                               rtol=SPMV_RTOL, atol=SPMV_RTOL)


def test_dist_spmv_uneven_rows():
    a = jprob.banded_laplacian(13)  # n=169, not divisible by 8
    x = np.random.default_rng(42).standard_normal(a.n)
    y = tp.dist_spmv(_port(a), x, _mesh(8))
    np.testing.assert_allclose(y, a.matvec(x), rtol=SPMV_RTOL, atol=SPMV_RTOL)
    np.testing.assert_allclose(y, jp.dist_spmv(a, x, jp.make_mesh(8)),
                               rtol=SPMV_RTOL, atol=SPMV_RTOL)


def test_make_dist_spmv_reuse(lap):
    part = tpart.RowPartitionedBanded.from_matrix(_port(lap), 8)
    mesh = _mesh(8)
    fn, put = make_dist_spmv(part, mesh, dtype=torch.float64)
    jfn, jput = j_make_spmv(jpart.RowPartitionedBanded.from_matrix(lap, 8),
                            jp.make_mesh(8), dtype=jnp.float64)
    rng = np.random.default_rng(42)
    for _ in range(2):
        x = rng.standard_normal(lap.n)
        y = part.unpad_vector(fetch_global(fn(put(x)), mesh))
        np.testing.assert_allclose(y, lap.matvec(x), rtol=SPMV_RTOL,
                                   atol=SPMV_RTOL)
        np.testing.assert_allclose(y, part.unpad_vector(np.asarray(
            jfn(jput(x)))), rtol=SPMV_RTOL, atol=SPMV_RTOL)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_overlap_split_matches_unsplit(lap, ndev):
    """The interior/edge split of the local matvec equals the unsplit form
    bit for bit: the same products and sums a row, in the same order."""
    mesh = _mesh(ndev)
    part = tpart.RowPartitionedBanded.from_matrix(_port(lap), ndev)
    data = put_global(part.data, mesh, torch.float64, axis=1)
    x = put_global(part.pad_vector(
        np.random.default_rng(42).standard_normal(lap.n)), mesh,
        torch.float64)
    out = [_make_local_matvec(part.offsets, part.halo, part.shard_rows,
                              ShardComm(mesh), overlap=ov)(data, x)
           for ov in (False, True)]
    assert torch.equal(out[0], out[1])
    np.testing.assert_allclose(part.unpad_vector(fetch_global(out[1], mesh)),
                               lap.matvec(part.unpad_vector(
                                   fetch_global(x, mesh))),
                               rtol=SPMV_RTOL, atol=SPMV_RTOL)


def test_ell_spmv_matches_host(rng):
    a = JCSR.from_dense(jprob.gen_rand_csr_matrix(
        200, 200, 0.9, 0.5, 2.0, seed=17).to_dense() + 100 * np.eye(200))
    part = tpart.RowPartitionedELL.from_matrix(_port(a), 8)
    mesh = _mesh(8)
    fn, put = make_dist_spmv(part, mesh, dtype=torch.float64)
    x = rng.standard_normal(a.n)
    np.testing.assert_allclose(
        part.unpad_vector(fetch_global(fn(put(x)), mesh)), a.matvec(x),
        rtol=SPMV_RTOL, atol=SPMV_RTOL)


# -- solves ------------------------------------------------------------------


def test_dist_bicgstab_matches_oracle(lap, b):
    cfg = dict(maxit=2000, tol=1e-6)
    rj, rt = _both(lap, b, 8, cfg)
    ref = bicgstab_hform_cpu(lap, b, maxit=2000, tol=1e-6)
    assert rt.converged
    assert abs(rt.iters - ref.iters) <= ITERS
    np.testing.assert_allclose(rt.trajectory()[:10],
                               np.asarray(ref.residual_history)[:10],
                               rtol=1e-6, atol=1e-9)
    assert _rel(lap, b, rt.x) < 1e-5
    assert rt.residual_true == pytest.approx(
        np.linalg.norm(b - lap.matvec(rt.x)), rel=1e-12)


def test_dist_bicgstab_matches_single_device(lap, b):
    cfg = dict(maxit=2000, tol=1e-6)
    rj, rt = _both(lap, b, 4, cfg)
    rs = ct.bicgstab(_port(lap), b, ct.SolverConfig(**cfg), device="cpu")
    rsj = cm.bicgstab(lap, b, JConfig(**cfg))
    assert rt.converged and rs.converged and rsj.converged
    np.testing.assert_allclose(rt.x, rs.x, rtol=RTOL_X, atol=1e-8)
    np.testing.assert_allclose(rt.x, rsj.x, rtol=RTOL_X, atol=1e-8)


def test_dist_jacobi(lap, b):
    rj, rt = _both(lap, b, 8, dict(maxit=2000, tol=1e-6, precond="jacobi"))
    assert rt.converged and _rel(lap, b, rt.x) < 1e-5


def test_dist_single_device_mesh(lap, b):
    """One shard: no neighbours, zero halos."""
    rj, rt = _both(lap, b, 1, dict(tol=1e-6))
    assert rt.converged
    rs = ct.bicgstab(_port(lap), b, ct.SolverConfig(tol=1e-6), device="cpu")
    np.testing.assert_allclose(rt.x, rs.x, rtol=RTOL_X, atol=1e-8)


def test_solver_is_reused_across_right_hand_sides(lap, b):
    ds = tp.make_dist_bicgstab(_port(lap), _mesh(4),
                               ct.SolverConfig(tol=1e-8, precond="jacobi"))
    for rhs in (b, 2.0 * b):
        r = ds.solve(rhs)
        assert r.converged and _rel(lap, rhs, r.x) < 1e-7
        assert r.dt_setup == ds.dt_setup


@pytest.mark.parametrize("ndev", [2, 8])
def test_dist_block_jacobi_ilu(lap, b, ndev):
    """Block-Jacobi ILU(0): each shard's own ILU(0), every shard's block
    step in one batched step."""
    rj, rt = _both(lap, b, ndev, dict(maxit=2000, tol=1e-6,
                                      precond="bjacobi_ilu0",
                                      trisolve_block=64))
    assert rt.converged and _rel(lap, b, rt.x) < 1e-5
    np.testing.assert_allclose(rt.x, rj.x, rtol=RTOL_X, atol=1e-8)


def test_block_jacobi_arrays_are_jax_bit_for_bit(lap):
    from cuda_mat_tpu.parallel.dist_precond import build_block_jacobi_ilu as jb

    from cuda_mat_tpu_torch.parallel.dist_precond import \
        build_block_jacobi_ilu as tb

    pj = jpart.RowPartitionedBanded.from_matrix(lap, 4)
    pt = tpart.RowPartitionedBanded.from_matrix(_port(lap), 4)
    for aj, at in zip(jb(pj, 64, jnp.float64), tb(pt, 64, torch.float64)):
        assert at.dtype == aj.dtype and at.shape == aj.shape
        np.testing.assert_allclose(at, aj, rtol=1e-12, atol=1e-12)


def test_dist_bjacobi_single_shard_matches_global_ilu(lap, b):
    """One shard: block-Jacobi ILU(0) is global ILU(0)."""
    cfg = dict(maxit=2000, tol=1e-6, trisolve_block=64)
    rt = tp.dist_bicgstab(_port(lap), b, _mesh(1), ct.SolverConfig(
        precond="bjacobi_ilu0", **cfg))
    rs = ct.bicgstab_lu_precond(_port(lap), b, ct.SolverConfig(**cfg),
                                device="cpu")
    rsj = cm.bicgstab_lu_precond(lap, b, JConfig(**cfg))
    assert rt.converged and rs.converged
    assert abs(rt.iters - rs.iters) <= 1 and abs(rt.iters - rsj.iters) <= 1
    np.testing.assert_allclose(rt.x, rs.x, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("precond", ["ilu0", "bogus"])
def test_dist_rejects_plain_ilu0(lap, precond):
    with pytest.raises(ValueError) as ej:
        jp.dist_bicgstab(lap, np.ones(lap.n), jp.make_mesh(4),
                         JConfig(precond=precond))
    with pytest.raises(ValueError) as et:
        tp.dist_bicgstab(_port(lap), np.ones(lap.n), _mesh(4),
                         ct.SolverConfig(precond=precond))
    assert str(et.value) == str(ej.value)


def test_dist_general_allgather(b):
    """A general matrix: ELL partition, all of x gathered."""
    a = JCSR.from_dense(jprob.gen_rand_csr_matrix(
        200, 200, 0.9, 0.5, 2.0, seed=17).to_dense() + 100 * np.eye(200))
    bb = b[:200]
    for precond in ("none", "jacobi"):
        rj, rt = _both(a, bb, 8, dict(maxit=2000, tol=1e-8, precond=precond),
                       halo_mode="allgather")
        assert rt.converged and _rel(a, bb, rt.x) < 1e-6
        assert isinstance(tp.make_dist_bicgstab(
            _port(a), _mesh(8), ct.SolverConfig(precond=precond),
            halo_mode="allgather").part, tpart.RowPartitionedELL)


def test_dist_auto_falls_back_to_allgather(b):
    rng2 = np.random.default_rng(3)
    d = np.where(rng2.random((120, 120)) > 0.9,
                 rng2.standard_normal((120, 120)), 0.0) + 60 * np.eye(120)
    a = JCSR.from_dense(d)
    rj, rt = _both(a, b[:120], 8, dict(maxit=2000, tol=1e-8))
    assert rt.converged
    assert isinstance(tp.make_dist_bicgstab(_port(a), _mesh(8)).part,
                      tpart.RowPartitionedELL)


def test_dist_ppermute_mode_rejects_general():
    rng2 = np.random.default_rng(4)
    d = np.where(rng2.random((64, 64)) > 0.8, 1.0, 0.0) + 40 * np.eye(64)
    a = JCSR.from_dense(d)
    with pytest.raises(ValueError) as ej:
        jp.dist_bicgstab(a, np.ones(64), jp.make_mesh(8), JConfig(),
                         halo_mode="ppermute")
    with pytest.raises(ValueError) as et:
        tp.dist_bicgstab(_port(a), np.ones(64), _mesh(8), ct.SolverConfig(),
                         halo_mode="ppermute")
    assert str(et.value) == str(ej.value)


def test_dist_ilu0_neumann(lap, b):
    """The Neumann series of the global ILU(0) factors, each term a
    halo-exchange matvec: the JAX distributed solve's count and x, and the
    single-device series (format="dia") within ±1."""
    cfg = dict(maxit=2000, tol=1e-8, precond="ilu0_neumann", neumann_terms=3)
    rj, rt = _both(lap, b, 8, cfg)
    rs = ct.solve(_port(lap), b, ct.SolverConfig(**cfg), format="dia",
                  device="cpu")
    assert rt.converged and rs.converged
    assert abs(rt.iters - rs.iters) <= 1
    np.testing.assert_allclose(rt.x, rs.x, rtol=RTOL_X, atol=1e-9)
    np.testing.assert_allclose(rt.x, rj.x, rtol=RTOL_X, atol=1e-9)
    assert _rel(lap, b, rt.x) < 1e-6


@pytest.mark.parametrize("precond", ["ilu0_neumann", "bjacobi_ilu0"])
def test_dist_factor_preconds_reject_general(precond):
    a, bb = jprob.random_diag_nonzero_system(64, prob_of_zero=0.7)
    cfg = dict(maxit=50, precond=precond)
    with pytest.raises(ValueError, match="banded") as ej:
        jp.dist_bicgstab(a, bb, jp.make_mesh(4), JConfig(**cfg))
    with pytest.raises(ValueError, match="banded") as et:
        tp.dist_bicgstab(_port(a), bb, _mesh(4), ct.SolverConfig(**cfg))
    assert str(et.value) == str(ej.value)


# -- engines and the mesh ------------------------------------------------------


@pytest.mark.parametrize("engine", ["pallas", "stencil"])
def test_kernel_engines_are_not_run_by_another(lap, b, engine):
    """A kernel engine asked for is the one that runs (its kernel's twin on
    the CPU, on the carry layout), never the "xla" engine: the SpMV within
    rtol 1e-12 of the host product and of the JAX engine's, the solve
    within ±5 iterations of the JAX solve on the same engine, x within
    rtol 1e-6 (the JAX package's own kernel-engine cases are in
    tests/test_torch_parallel_kernels.py)."""
    x = np.random.default_rng(5).standard_normal(lap.n)
    y = tp.dist_spmv(_port(lap), x, _mesh(4), local_engine=engine)
    yj = jp.dist_spmv(lap, x, jp.make_mesh(4), local_engine=engine,
                      interpret=True)
    np.testing.assert_allclose(y, lap.matvec(x), rtol=SPMV_RTOL,
                               atol=SPMV_RTOL)
    np.testing.assert_allclose(y, yj, rtol=SPMV_RTOL, atol=SPMV_RTOL)
    cfg = dict(maxit=2000, tol=1e-8, precond="jacobi")
    ds = tp.make_dist_bicgstab(_port(lap), _mesh(4), ct.SolverConfig(**cfg),
                               local_engine=engine)
    assert ds.engine == engine and ds.carry_block > 0
    rt = ds.solve(b)
    rj = jp.dist_bicgstab(lap, b, jp.make_mesh(4), JConfig(**cfg),
                          local_engine=engine)
    assert rt.status == rj.status and abs(rt.iters - rj.iters) <= ITERS
    np.testing.assert_allclose(rt.x, rj.x, rtol=RTOL_X, atol=1e-9)


def test_make_mesh_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.make_mesh(8)
    with pytest.raises(RuntimeError):
        tp.make_mesh(8, device="cuda")
    m = tp.make_mesh(8, device="cpu")
    assert (m.ndev, m.local, m.first, m.device.type) == (8, 8, 0, "cpu")


def test_make_mesh_devices_and_counts():
    m = tp.make_mesh(devices=["cpu"] * 4)
    assert m.ndev == 4 and m.axis == "rows"
    assert tp.make_mesh(2, devices=["cpu"] * 4).ndev == 2
    with pytest.raises(ValueError, match="only 4 available"):
        tp.make_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        tp.make_mesh(0, device="cpu")
    tp.init_distributed()            # no coordinator: nothing to do
    assert not torch.distributed.is_initialized()


# -- the stencil plan ---------------------------------------------------------


@pytest.fixture(scope="module")
def grid():
    return jprob.grid_laplacian(64, 126)  # n=8064; stride=128, np_true=8192


@pytest.mark.parametrize("ndev", [1, 8])
def test_partition_stencil_plan(grid, ndev):
    part = tpart.RowPartitionedStencil.from_matrix(_port(grid), ndev)
    assert part.stride == 128 and part.np_true == 64 * 128
    assert part.shard_rows % part.block == 0
    assert part.npad == ndev * part.shard_rows
    assert part.block % part.stride == 0
    assert part.halo <= part.sub
    gm = part.gapmask.reshape(-1, part.stride)
    np.testing.assert_array_equal(gm[:, :126], 1.0)
    np.testing.assert_array_equal(gm[:, 126:], 0.0)
    v = np.arange(part.n, dtype=np.float64)
    np.testing.assert_array_equal(part.unpad_vector(part.pad_vector(v)), v)
    pj = jpart.RowPartitionedStencil.from_matrix(grid, ndev)
    _same_partition(pj, part)
    _same_partition(pj, partition_from_numpy(dataclasses.asdict(pj)))
    np.testing.assert_array_equal(part.strided_scatter(v, fill=1.0),
                                  pj.strided_scatter(v, fill=1.0))


def test_partition_stencil_rejects_nonstencil():
    a, _ = jprob.random_diag_nonzero_system(64, prob_of_zero=0.7)
    with pytest.raises(ValueError) as ej:
        jpart.RowPartitionedStencil.from_matrix(a, 4)
    with pytest.raises(ValueError) as et:
        tpart.RowPartitionedStencil.from_matrix(_port(a), 4)
    assert str(et.value) == str(ej.value)
