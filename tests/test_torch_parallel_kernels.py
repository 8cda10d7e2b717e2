"""The distributed solver's kernel engines (``local_engine="pallas"``: kernel
B3 a shard; ``"stencil"``: B1 a shard and the fused msolve B2/B5) against
the JAX package on the CPU, and the shard axis of the kernels' twins.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py, its
Pallas kernels in interpret mode, as tests/test_parallel.py runs them; the
port runs on ``make_mesh(n, device="cpu")``, where each front end takes its
kernel's plain twin.  The cases are the kernel-engine cases of
tests/test_parallel.py, on its fixtures ``banded_laplacian(40)`` (n 1600,
band 40) and ``grid_laplacian(64, 126)`` (n 8064, stride 128), in f64.
Tolerances:

- SpMV and msolve: rtol 1e-12 against the host product and the JAX
  package's (its interpret kernels run under XLA, which may contract a
  multiply and an add into one FMA);
- solves: the status of the JAX solve on the same engine and mesh,
  iterations within ±5 of it, x within rtol 1e-6 of it;
- the split form against the scatter form, a batched twin against S calls
  of the one-vector twin, and the B2/B5 twins against the JAX interpret
  kernels at a shard's base (scalars that are powers of two, whose
  products no FMA contraction changes): bit for bit.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import cuda_mat_tpu.parallel as jp
from cuda_mat_tpu.config import SolverConfig as JConfig
from cuda_mat_tpu.models import problems as jprob
from cuda_mat_tpu.ops import pallas_stencil as jps
from cuda_mat_tpu.parallel import dist_solver as jds
from cuda_mat_tpu.parallel import partition as jpart
from cuda_mat_tpu.precond.preconditioners import (
    neumann_factors as j_neumann_factors)

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.parallel as tp
from cuda_mat_tpu_torch.ops import dia_spmv as tdia
from cuda_mat_tpu_torch.ops import stencil as tst
from cuda_mat_tpu_torch.parallel import dist_solver as tdist
from cuda_mat_tpu_torch.parallel import partition as tpart
from cuda_mat_tpu_torch.parallel.collectives import ShardComm
from cuda_mat_tpu_torch.precond.preconditioners import neumann_factors

torch.set_num_threads(1)

ITERS = 5           # iterations against the JAX solve on the same engine
RTOL_X = 1e-6
SPMV_RTOL = 1e-12


def _port(a):
    return ct.CSRMatrix(a.n, a.m, a.data, a.indices, a.indptr)


def _mesh(n):
    return tp.make_mesh(n, device="cpu")


LAP = jprob.banded_laplacian(40)            # n=1600, w=40
GRID = jprob.grid_laplacian(64, 126)        # n=8064; stride 128
MATS = {"lap": LAP, "grid": GRID}
B = {k: np.random.default_rng(42).uniform(1.0, 5.0, a.n)
     for k, a in MATS.items()}
_SOLVES = {}


def _solves(name, n, engine, b=None, **cfg):
    """The JAX and the port's distributed solves of one case, each built
    once per module: ``(jax result, port solver, port result)``."""
    key = (name, n, engine, tuple(sorted(cfg.items())))
    if key not in _SOLVES:
        a = MATS[name]
        b = B[name] if b is None else b
        rj = jp.dist_bicgstab(a, b, jp.make_mesh(n), JConfig(**cfg),
                              local_engine=engine)
        ds = tp.make_dist_bicgstab(_port(a), _mesh(n), ct.SolverConfig(**cfg),
                                   local_engine=engine)
        _SOLVES[key] = (rj, ds, ds.solve(b))
    return _SOLVES[key]


def _rel(a, b, x):
    return np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b)


def _close_to_jax(rj, rt):
    assert rt.status == rj.status, (rt.status, rj.status)
    assert abs(rt.iters - rj.iters) <= ITERS, (rt.iters, rj.iters)
    np.testing.assert_allclose(rt.x, rj.x, rtol=RTOL_X, atol=1e-9)


# -- the fused msolve's u mask at a shard's base (ROADMAP C12) -------------

U_BLOCK, U_SUB, U_NPAD = 4096, 2048, 16384
U_TL = ((-3, -0.25), (-1, -0.5), (0, 1.0))
U_TU = ((0, 1.0), (1, -0.5), (3, -0.25))
U_CASES = [(0, 16000, "zero"), (0, 16000, "random"),
           (16384, 49152, "zero"), (16384, 49152, "random")]


def _u_inputs(pads, nvec):
    rng = np.random.default_rng(11)
    n = U_NPAD + 2 * U_BLOCK
    vs = [rng.standard_normal(n) for _ in range(nvec)]
    if pads == "zero":
        for v in vs:
            v[:U_BLOCK] = 0
            v[n - U_BLOCK:] = 0
    gap = np.ones(U_BLOCK)
    gap.reshape(-1, 128)[:, 100:] = 0
    ext = jps.extend_gapmask(gap, jps.msolve_halo(U_TU))
    return vs, rng.uniform(0.5, 2.0, n), ext


@pytest.mark.parametrize("base,np_true,pads", U_CASES)
def test_msolve_twin_masks_u_to_the_global_rows(base, np_true, pads):
    """B2's twin equals the JAX kernel bit for bit on a shard past the
    first: u is zeroed only outside the global rows [0, np_true), so the
    rows before the shard (its left pad block: the halo and the
    neighbour's inv_d) feed its first rows."""
    (x,), d, ext = _u_inputs(pads, 1)
    yj = jps.const_series_msolve_padded(
        jnp.asarray(x), jnp.asarray(d), jnp.asarray(ext), U_TL, U_TU,
        np_true, U_BLOCK, U_SUB, interpret=True,
        base=jnp.asarray([base], jnp.int32))
    yt = tst.const_series_msolve_padded(
        torch.from_numpy(x), torch.from_numpy(d), torch.from_numpy(ext),
        U_TL, U_TU, np_true, U_BLOCK, U_SUB, base)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


@pytest.mark.parametrize("base,np_true,pads", U_CASES)
def test_msolve_fma_twin_masks_u_to_the_global_rows(base, np_true, pads):
    """B5's twin likewise, p with zero pad blocks as the JAX kernel writes
    them (c1, c2 powers of two: XLA's FMA contraction cannot round p
    otherwise)."""
    (a, b, c), d, ext = _u_inputs(pads, 3)
    pj, yj = jps.const_series_msolve_fma_padded(
        jnp.asarray(a), 0.5, jnp.asarray(b), -2.0, jnp.asarray(c),
        jnp.asarray(d), jnp.asarray(ext), U_TL, U_TU, np_true, U_BLOCK,
        U_SUB, interpret=True, base=jnp.asarray([base], jnp.int32))
    t = torch.from_numpy
    pt, yt = tst.const_series_msolve_fma_padded(
        t(a), torch.tensor(0.5, dtype=torch.float64), t(b),
        torch.tensor(-2.0, dtype=torch.float64), t(c), t(d), t(ext), U_TL,
        U_TU, np_true, U_BLOCK, U_SUB, base)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


# -- the twins' shard axis ---------------------------------------------------


@pytest.mark.parametrize("kernel", ["B1", "B2", "B5", "B3"])
def test_batched_twin_is_one_vector_calls(kernel):
    """A batch (S, L) of S shards equals S calls of the one-vector twin,
    shard i at base + i·npad, bit for bit (random pads, a tail inside the
    third shard)."""
    S, block, npad, base = 4, 4096, 8192, 4096
    np_true = base + 2 * npad + 3000
    rng = np.random.default_rng(12)
    L = npad + 2 * block
    x, a, b, c, d = (torch.from_numpy(rng.standard_normal((S, L)))
                     for _ in range(5))
    gap = torch.ones(block, dtype=torch.float64)
    gap.view(-1, 128)[:, 100:] = 0
    ext = torch.cat([gap[-1024:], gap, gap[:1024]])
    c1 = torch.tensor(0.37, dtype=torch.float64)
    c2 = torch.tensor(-1.9, dtype=torch.float64)
    offsets = (-129, -1, 0, 1, 129)
    data = torch.from_numpy(rng.standard_normal((len(offsets), S, npad)))

    def call(i):
        at = (slice(None),) if i is None else (i,)
        bi = base if i is None else base + i * npad
        if kernel == "B1":
            return (tst.const_stencil_spmv_padded(
                x[at], gap, U_TL + ((128, 0.5),), np_true, block, 1024, bi),)
        if kernel == "B2":
            return (tst.const_series_msolve_padded(
                x[at], d[at], ext, U_TL, U_TU, np_true, block, 1024, bi),)
        if kernel == "B5":
            return tst.const_series_msolve_fma_padded(
                a[at], c1, b[at], c2, c[at], d[at], ext, U_TL, U_TU, np_true,
                block, 1024, bi)
        return (tdia.dia_spmv_block_padded(
            data if i is None else data[:, i], x[at], offsets, block, 1024),)

    whole = call(None)
    for i in range(S):
        for got, one in zip(whole, call(i)):
            assert torch.equal(got[i], one), (kernel, i)


# -- the auto rule -----------------------------------------------------------


def _varied_diagonal(a):
    """``a`` with a diagonal that varies along the rows: banded, but no
    constant stencil."""
    rows = np.repeat(np.arange(a.n), np.diff(a.indptr))
    data = np.where(a.indices == rows, a.data * (1.0 + rows / a.n), a.data)
    return ct.CSRMatrix(a.n, a.m, data, a.indices, a.indptr)


AUTO_MATS = {
    "grid": lambda: _port(GRID), "lap": lambda: _port(LAP),
    "band": lambda: _varied_diagonal(LAP),
    "random": lambda: _port(jprob.random_diag_nonzero_system(
        300, prob_of_zero=0.9)[0])}
AUTO = [
    # (matrix, precond, halo_mode, cuda's engine and partition)
    ("grid", "none", "auto", "stencil", "RowPartitionedStencil"),
    ("grid", "ilu0_neumann", "auto", "stencil", "RowPartitionedStencil"),
    ("grid", "bjacobi_ilu0", "auto", "pallas", "RowPartitionedBanded"),
    ("grid", "jacobi", "allgather", "xla", "RowPartitionedELL"),
    ("lap", "jacobi", "auto", "stencil", "RowPartitionedStencil"),
    ("band", "jacobi", "auto", "pallas", "RowPartitionedBanded"),
    ("band", "ilu0_neumann", "ppermute", "pallas", "RowPartitionedBanded"),
    ("random", "jacobi", "auto", "xla", "RowPartitionedELL"),
]


@pytest.mark.parametrize("name,precond,halo,engine,part", AUTO)
def test_auto_rule_picks_the_kernel_engines_on_cuda_only(name, precond, halo,
                                                         engine, part):
    """"auto" on a CUDA device type: stencil where the structure is proved,
    else pallas (always for block-Jacobi), the all-gather for general
    sparsity or when asked; on a CPU device type "xla", the JAX package's
    rule off its accelerator.  Decided on the host: no card needed."""
    a = AUTO_MATS[name]()
    cfg = ct.SolverConfig(precond=precond)
    pl = tdist.plan_engine(a, 4, cfg, "cuda", halo)
    assert (pl.engine, type(pl.part).__name__) == (engine, part)
    cpu = tdist.plan_engine(a, 4, cfg, "cpu", halo)
    assert cpu.engine == "xla"
    assert type(cpu.part).__name__ == (
        "RowPartitionedELL" if part == "RowPartitionedELL"
        else "RowPartitionedBanded")
    if engine != "xla":
        # the layout the JAX package plans on its accelerator
        assert pl.block and pl.part.shard_rows % pl.block == 0


# -- the pallas engine: B3 a shard -------------------------------------------


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_dist_spmv_pallas_engine(ndev):
    x = np.random.default_rng(42).standard_normal(LAP.n)
    yt = tp.dist_spmv(_port(LAP), x, _mesh(ndev), local_engine="pallas")
    yj = jp.dist_spmv(LAP, x, jp.make_mesh(ndev), local_engine="pallas",
                      interpret=True)
    np.testing.assert_allclose(yt, LAP.matvec(x), rtol=SPMV_RTOL,
                               atol=SPMV_RTOL)
    np.testing.assert_allclose(yt, yj, rtol=SPMV_RTOL, atol=SPMV_RTOL)


def test_dist_bicgstab_pallas_engine_matches_xla():
    cfg = dict(maxit=500, tol=1e-8)
    rj, ds, rt = _solves("lap", 4, "pallas", **cfg)
    assert ds.engine == "pallas" and ds.carry_block
    _close_to_jax(rj, rt)
    rx = tp.dist_bicgstab(_port(LAP), B["lap"], _mesh(4),
                          ct.SolverConfig(**cfg), local_engine="xla")
    assert rt.converged and abs(rt.iters - rx.iters) <= ITERS
    assert _rel(LAP, B["lap"], rt.x) < 1e-7


def test_dist_ilu0_neumann_pallas_engine():
    cfg = dict(maxit=2000, tol=1e-8, precond="ilu0_neumann", neumann_terms=3)
    rj, ds, rt = _solves("lap", 8, "pallas", **cfg)
    assert ds.msolve_mode == "exact"
    _close_to_jax(rj, rt)
    assert _rel(LAP, B["lap"], rt.x) < 1e-6


def _jax_shard_map(mesh, fn, in_specs, out_specs):
    return jax.jit(partial(jax.shard_map, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False)(fn))


def test_pallas_overlap_split_matches_scatter():
    ndev = 4
    blk, sub = tdist._pallas_blocks(LAP.to_dia().bandwidth, "cpu")
    assert (blk, sub) == jds._pallas_blocks(LAP.to_dia().bandwidth, True)
    part = tpart.RowPartitionedBanded.from_matrix(_port(LAP), ndev,
                                                  align=blk)
    mesh = _mesh(ndev)
    xh = np.random.default_rng(42).standard_normal(LAP.n)
    xc = tdist.put_global(tdist._to_carry(part.pad_vector(xh), ndev,
                                          part.shard_rows, blk), mesh,
                          torch.float64)
    data = tdist.put_global(part.data, mesh, torch.float64, axis=1)
    out = [tdist._make_local_matvec_pallas(
        part.offsets, part.halo, part.shard_rows, ShardComm(mesh), blk, sub,
        overlap=ov)(data, xc) for ov in (False, True)]
    assert torch.equal(out[0], out[1])
    assert torch.count_nonzero(xc[:, :blk]) == 0   # the pads zero again
    # the JAX scatter form on the same carry
    jm = jp.make_mesh(ndev)
    axis = jm.axis_names[0]
    sh = NamedSharding(jm, P(axis))
    jd = tuple(jax.device_put(jnp.asarray(part.data[k]), sh)
               for k in range(len(part.offsets)))
    mv = jds._make_local_matvec_pallas(part.offsets, part.halo,
                                       part.shard_rows, ndev, axis, blk, sub,
                                       interpret=True, overlap=False)
    yj = _jax_shard_map(jm, lambda d, xl: mv(d, xl),
                        ((P(axis),) * len(jd), P(axis)), P(axis))(
        jd, jax.device_put(jnp.asarray(xc.numpy().reshape(-1)), sh))
    yt = tdist.fetch_global(out[1], mesh)
    np.testing.assert_allclose(yt, np.asarray(yj), rtol=SPMV_RTOL,
                               atol=SPMV_RTOL)
    np.testing.assert_allclose(
        part.unpad_vector(tdist._from_carry(yt, ndev, part.shard_rows, blk)),
        LAP.matvec(xh), rtol=SPMV_RTOL, atol=SPMV_RTOL)


# -- the stencil engine: B1 a shard, the fused msolve B2/B5 ------------------


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_dist_spmv_stencil_engine(ndev):
    x = np.random.default_rng(42).standard_normal(GRID.n)
    yt = tp.dist_spmv(_port(GRID), x, _mesh(ndev), local_engine="stencil")
    yj = jp.dist_spmv(GRID, x, jp.make_mesh(ndev), local_engine="stencil",
                      interpret=True)
    np.testing.assert_allclose(yt, GRID.matvec(x), rtol=SPMV_RTOL,
                               atol=SPMV_RTOL)
    np.testing.assert_allclose(yt, yj, rtol=SPMV_RTOL, atol=SPMV_RTOL)


def test_dist_spmv_stencil_global_tail():
    """np_true (8064) inside the last shard: the tail masked by each
    shard's global base row."""
    a = jprob.grid_laplacian(63, 126)
    part = tpart.RowPartitionedStencil.from_matrix(_port(a), 8)
    assert part.np_true < part.npad and part.np_true > part.npad - \
        part.shard_rows
    x = np.random.default_rng(42).standard_normal(a.n)
    yt = tp.dist_spmv(_port(a), x, _mesh(8), local_engine="stencil")
    np.testing.assert_allclose(yt, a.matvec(x), rtol=SPMV_RTOL,
                               atol=SPMV_RTOL)


def test_dist_bicgstab_stencil_matches_single_device():
    cfg = dict(maxit=1000, tol=1e-8)
    rj, ds, rt = _solves("grid", 8, "stencil", **cfg)
    assert ds.engine == "stencil"
    _close_to_jax(rj, rt)
    rs = ct.solve(_port(GRID), B["grid"], ct.SolverConfig(**cfg),
                  format="stencil", device="cpu")
    assert rt.converged and rs.converged
    assert abs(rt.iters - rs.iters) <= 0.1 * rs.iters
    np.testing.assert_allclose(rt.x, rs.x, rtol=RTOL_X, atol=1e-8)
    assert _rel(GRID, B["grid"], rt.x) < 1e-7


NEUMANN = dict(maxit=2000, tol=1e-8, precond="ilu0_neumann", neumann_terms=3)


def test_dist_stencil_neumann_uses_fused_msolve_kernel(monkeypatch):
    """The const factors take the one-launch fused msolve ("kernel" mode):
    one B2 twin call an msolve, and the solve tracks the JAX one."""
    calls = []
    orig = tst.const_series_msolve_padded
    monkeypatch.setattr(tst, "const_series_msolve_padded",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    rj = jp.dist_bicgstab(GRID, B["grid"], jp.make_mesh(8),
                          JConfig(**NEUMANN), local_engine="stencil")
    ds = tp.make_dist_bicgstab(_port(GRID), _mesh(8),
                               ct.SolverConfig(**NEUMANN),
                               local_engine="stencil")
    rt = ds.solve(B["grid"])
    assert ds.msolve_mode == "kernel"
    assert len(calls) == 2 * rt.iters
    _close_to_jax(rj, rt)


def test_dist_fuse_blas1_matches_off(monkeypatch):
    calls = []
    orig = tst.const_series_msolve_fma_padded
    monkeypatch.setattr(tst, "const_series_msolve_fma_padded",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    _, _, r_off = _solves("grid", 8, "stencil", **NEUMANN)
    ds = tp.make_dist_bicgstab(_port(GRID), _mesh(8), ct.SolverConfig(
        **NEUMANN, fuse_blas1=True), local_engine="stencil")
    r_on = ds.solve(B["grid"])
    assert len(calls) == 2 * r_on.iters
    assert r_on.converged and r_off.converged
    assert abs(r_on.iters - r_off.iters) <= max(3, 0.15 * r_off.iters)
    np.testing.assert_allclose(r_on.x, r_off.x, rtol=RTOL_X, atol=1e-8)
    rj = jp.dist_bicgstab(GRID, B["grid"], jp.make_mesh(8), JConfig(
        **NEUMANN, fuse_blas1=True), local_engine="stencil")
    _close_to_jax(rj, r_on)


def _msolve_setup(ndev):
    """Both packages' stencil partition, re-planned for the fused series
    (the same layout: the plan is shared code), the series polynomials'
    strided terms, the extended gap mask and each shard's inv_d window."""
    pj = jpart.RowPartitionedStencil.from_matrix(GRID, ndev)
    pt = tpart.RowPartitionedStencil.from_matrix(_port(GRID), ndev)
    plan = jps.plan_const_neumann_layout(pj.terms, 3, pj.c_grid, pj.stride,
                                         prefer_mono=True)
    if plan[0] > pj.sub or pj.block > plan[1]:
        kw = dict(min_sub=plan[0], block_target=plan[1])
        pj = jpart.RowPartitionedStencil.from_matrix(GRID, ndev, **kw)
        pt = tpart.RowPartitionedStencil.from_matrix(_port(GRID), ndev, **kw)
    assert (pt.block, pt.sub, pt.shard_rows) == (pj.block, pj.sub,
                                                 pj.shard_rows)
    low, up, diag_m = j_neumann_factors(GRID)
    sts = []
    for f in (low, up):
        t, _ = jps.const_factor_terms(f.to_dia(max_diags=128), pj.c_grid,
                                      pj.stride)
        poly = jps.neumann_poly_terms(t, 3, pj.c_grid, pj.stride)
        sts.append(jps.strided_offsets(poly, pj.c_grid, pj.stride))
    s, blk = pj.shard_rows, pj.block
    ext = jps.extend_gapmask(pj.gapmask, jps.msolve_halo(sts[1]))
    invd_g = np.concatenate([np.ones(blk),
                             pj.strided_scatter(1.0 / diag_m, fill=1.0),
                             np.ones(blk)])
    d_pad = np.stack([invd_g[i * s: i * s + s + 2 * blk]
                      for i in range(ndev)])
    return pj, pt, sts, ext, d_pad


def _carry(part, ndev, v):
    return tdist._to_carry(part.pad_vector(v), ndev, part.shard_rows,
                           part.block).reshape(ndev, -1)


def test_msolve_overlap_matches_scatter_and_jax():
    """The msolve's split form equals its scatter form bit for bit (the
    port rounds every op on its own), and both the JAX package's scatter
    form within rtol 1e-12."""
    ndev = 4
    pj, pt, sts, ext, d_pad = _msolve_setup(ndev)
    mesh = _mesh(ndev)
    x = _carry(pt, ndev, np.random.default_rng(42).standard_normal(GRID.n))
    t = torch.from_numpy
    out = [tdist._make_local_msolve_kernel(
        pt, ShardComm(mesh), sts[0], sts[1], overlap=ov)(
            t(ext), t(d_pad), t(x.copy())) for ov in (False, True)]
    assert torch.equal(out[0], out[1])
    jm = jp.make_mesh(ndev)
    axis = jm.axis_names[0]
    sh = NamedSharding(jm, P(axis))
    ms = jds._make_local_msolve_kernel(pj, axis, interpret=True,
                                       terms_l=sts[0], terms_u=sts[1],
                                       overlap=False)
    yj = _jax_shard_map(jm, ms, (P(), P(axis), P(axis)), P(axis))(
        jax.device_put(jnp.asarray(ext), NamedSharding(jm, P())),
        jax.device_put(jnp.asarray(d_pad.reshape(-1)), sh),
        jax.device_put(jnp.asarray(x.reshape(-1)), sh))
    np.testing.assert_allclose(out[1].numpy().reshape(-1), np.asarray(yj),
                               rtol=SPMV_RTOL, atol=SPMV_RTOL)


@pytest.mark.parametrize("ndev", [1, 4, 8])
def test_msolve_fma_matches_plain(ndev):
    """The BLAS1-prologue msolve (p, y) equals the combination and the
    plain msolve bit for bit, in both forms, p's pads zero; and the JAX
    package's fma form within 16 eps of max|y| (its FMA contraction)."""
    pj, pt, sts, ext, d_pad = _msolve_setup(ndev)
    mesh = _mesh(ndev)
    comm = ShardComm(mesh)
    rng = np.random.default_rng(42)
    av, bv, cv = (_carry(pt, ndev, rng.standard_normal(GRID.n))
                  for _ in range(3))
    t = torch.from_numpy
    c1 = torch.tensor(0.37, dtype=torch.float64)
    c2 = torch.tensor(-1.9, dtype=torch.float64)
    p_ref = tst.fma_combine(t(av), c1, t(bv), c2, t(cv))
    y_ref = tdist._make_local_msolve_kernel(pt, comm, sts[0], sts[1])(
        t(ext), t(d_pad), p_ref.clone())
    for ov in (False, True):
        msf = tdist._make_local_msolve_kernel(pt, comm, sts[0], sts[1],
                                              overlap=ov, fma=True)
        p, y = msf(t(ext), t(d_pad), t(av.copy()), c1, t(bv.copy()), c2,
                   t(cv.copy()))
        assert torch.equal(p, p_ref) and torch.equal(y, y_ref), ov
    jm = jp.make_mesh(ndev)
    axis = jm.axis_names[0]
    sh = NamedSharding(jm, P(axis))
    msf_j = jds._make_local_msolve_kernel(pj, axis, interpret=True,
                                          terms_l=sts[0], terms_u=sts[1],
                                          fma=True)
    put = lambda v: jax.device_put(jnp.asarray(v.reshape(-1)), sh)  # noqa
    pjx, yjx = _jax_shard_map(
        jm, msf_j, (P(), P(axis), P(axis), P(), P(axis), P(), P(axis)),
        (P(axis), P(axis)))(
        jax.device_put(jnp.asarray(ext), NamedSharding(jm, P())),
        put(d_pad), put(av), jnp.asarray(0.37), put(bv), jnp.asarray(-1.9),
        put(cv))
    tol = 16 * np.finfo(np.float64).eps * max(1.0, float(y.abs().max()))
    np.testing.assert_allclose(y.numpy().reshape(-1), np.asarray(yjx),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(p.numpy().reshape(-1), np.asarray(pjx),
                               rtol=0, atol=tol)


def test_dist_stencil_ilu0_neumann():
    rj, ds, rt = _solves("grid", 8, "stencil", **NEUMANN)
    _close_to_jax(rj, rt)
    rs = ct.solve(_port(GRID), B["grid"], ct.SolverConfig(**NEUMANN),
                  format="stencil", device="cpu")
    assert abs(rt.iters - rs.iters) <= max(3, 0.15 * rs.iters)
    np.testing.assert_allclose(rt.x, rs.x, rtol=RTOL_X, atol=1e-8)
    assert _rel(GRID, B["grid"], rt.x) < 1e-7


def test_dist_stencil_rejects_bjacobi():
    cfg = dict(maxit=10, precond="bjacobi_ilu0")
    with pytest.raises(ValueError, match="stencil") as ej:
        jp.dist_bicgstab(GRID, np.ones(GRID.n), jp.make_mesh(4),
                         JConfig(**cfg), local_engine="stencil")
    with pytest.raises(ValueError, match="stencil") as et:
        tp.dist_bicgstab(_port(GRID), np.ones(GRID.n), _mesh(4),
                         ct.SolverConfig(**cfg), local_engine="stencil")
    assert str(et.value) == str(ej.value)


def test_dist_stencil_rejects_nonstencil():
    a, b = jprob.random_diag_nonzero_system(64, prob_of_zero=0.7)
    with pytest.raises(ValueError) as ej:
        jp.dist_bicgstab(a, b, jp.make_mesh(4), JConfig(maxit=10),
                         local_engine="stencil")
    with pytest.raises(ValueError) as et:
        tp.dist_bicgstab(_port(a), b, _mesh(4), ct.SolverConfig(maxit=10),
                         local_engine="stencil")
    assert str(et.value) == str(ej.value)


def test_stencil_overlap_split_matches_scatter():
    ndev = 4
    part = tpart.RowPartitionedStencil.from_matrix(_port(GRID), ndev)
    mesh = _mesh(ndev)
    xh = np.random.default_rng(42).standard_normal(GRID.n)
    xc = torch.from_numpy(_carry(part, ndev, xh))
    gap = torch.from_numpy(part.gapmask.astype(np.float64))
    out = [tdist._make_local_matvec_stencil(part, ShardComm(mesh),
                                            overlap=ov)(gap, xc)
           for ov in (False, True)]
    assert torch.equal(out[0], out[1])
    y = tdist._from_carry(tdist.fetch_global(out[1], mesh), ndev,
                          part.shard_rows, part.block)
    np.testing.assert_allclose(part.unpad_vector(y), GRID.matvec(xh),
                               rtol=SPMV_RTOL, atol=SPMV_RTOL)


def test_dist_stencil_neumann_exact_pattern_factors():
    """neumann_const_factors=False: the exact factors restrided into the
    stencil layout, kernel B3 a shard."""
    cfg = dict(maxit=2000, tol=1e-6, precond="ilu0_neumann", neumann_terms=3,
               neumann_const_factors=False)
    rj, ds, rt = _solves("grid", 8, "stencil", **cfg)
    assert ds.engine == "stencil" and ds.msolve_mode == "exact"
    _close_to_jax(rj, rt)
    assert _rel(GRID, B["grid"], rt.x) < 1e-5


def test_dist_milu_omega_matches_jax_and_single_device():
    cfg = dict(NEUMANN, milu_omega=0.97)
    rj, ds, rt = _solves("grid", 8, "stencil", b=np.ones(GRID.n), **cfg)
    _close_to_jax(rj, rt)
    rs = ct.solve(_port(GRID), np.ones(GRID.n), ct.SolverConfig(**cfg),
                  format="stencil", device="cpu")
    assert abs(rt.iters - rs.iters) <= max(3, 0.15 * rs.iters)
    np.testing.assert_allclose(rt.x, rs.x, rtol=RTOL_X, atol=1e-8)


@pytest.mark.parametrize("engine", ["pallas", "stencil"])
def test_kernel_engines_keep_the_pads_zero(engine):
    """Across a solve the loop vectors keep their carry pads at zero: the
    halos scattered for a launch are cleared after it."""
    name = "lap" if engine == "pallas" else "grid"
    _, ds, rt = _solves(name, 4, engine, maxit=500, tol=1e-8)
    seen = []
    orig = ds._run

    def run(x0, b):
        out = orig(x0, b)
        seen.append(out[0])
        return out

    ds._run = run
    r2 = ds.solve(B[name])
    cb = ds.carry_block
    x = seen[0]
    assert torch.count_nonzero(x[:, :cb]) == 0
    assert torch.count_nonzero(x[:, x.shape[1] - cb:]) == 0
    assert r2.iters == rt.iters and np.array_equal(r2.x, rt.x)


def test_carry_layout_on_host_arrays_and_tensors():
    """_to_carry / _from_carry: the JAX package's host layout bit for bit
    (fill 0 for loop vectors, 1 for inverse diagonals), and the same on
    this process's (S, shard_rows) tensors."""
    ndev, s, blk = 4, 24, 8
    v = np.random.default_rng(13).standard_normal(ndev * s)
    for fill in (0.0, 1.0):
        host = tdist._to_carry(v, ndev, s, blk, fill)
        np.testing.assert_array_equal(host, jds._to_carry(v, ndev, s, blk,
                                                          fill))
        t = tdist._to_carry(torch.from_numpy(v).view(ndev, s), ndev, s, blk,
                            fill)
        np.testing.assert_array_equal(t.numpy().reshape(-1), host)
        np.testing.assert_array_equal(tdist._from_carry(host, ndev, s, blk),
                                      v)
        assert torch.equal(tdist._from_carry(t, ndev, s, blk),
                           torch.from_numpy(v).view(ndev, s))
