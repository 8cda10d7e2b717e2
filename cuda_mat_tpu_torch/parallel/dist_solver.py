"""Row-partitioned SpMV and BiCGSTAB over a mesh of row shards (counterpart
of :mod:`cuda_mat_tpu.parallel.dist_solver`, its ``local_engine="xla"``).

The JAX package runs the whole loop inside one ``shard_map``; its "xla"
engine computes the local matvec, the dots, the gathers and the Neumann
series with XLA's own ops, outside any Pallas kernel.  Here the same work is
stock torch ops on each process's ``(S, shard_rows)`` block of every vector
(:mod:`.collectives`):

- **SpMV**: each shard's banded rows multiply its x extended by a halo of
  ``w`` entries from each neighbouring shard (the JAX ``ppermute`` pair);
  a general matrix gathers all of x (the JAX ``all_gather``) and multiplies
  its ELL rows;
- **dots**: a partial per shard, one sum, one ``all_reduce`` across
  processes — one collective a dot, six an iteration, as in the JAX loop;
- the loops are :func:`~cuda_mat_tpu_torch.solvers.bicgstab.hform_core` /
  :func:`~cuda_mat_tpu_torch.solvers.bicgstab.precond_core` themselves,
  closed over the sharded matvec, msolve and dot.  Every process reads its
  own all-reduced scalars, which are equal on every process, so all stop
  at the same iteration.

The JAX package's kernel engines, ``local_engine="pallas"`` (a DIA kernel
a shard) and ``"stencil"`` (the constant-stencil kernels a shard), are not
ported yet (ROADMAP A11b): they raise NotImplementedError, and never run
another engine in their place.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cuda_mat_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from cuda_mat_tpu_torch.formats.csr import CSRMatrix
from cuda_mat_tpu_torch.parallel.collectives import ShardComm
from cuda_mat_tpu_torch.parallel.mesh import Mesh
from cuda_mat_tpu_torch.parallel.partition import (RowPartitionedBanded,
                                                   RowPartitionedELL)
from cuda_mat_tpu_torch.solvers.bicgstab import (_RUNNING,
                                                 _attach_true_residual,
                                                 _dtype_of, hform_core,
                                                 precond_core)
from cuda_mat_tpu_torch.solvers.result import SolveResult, SolverStatus
from cuda_mat_tpu_torch.utils.timing import device_sync

_PRECONDS = ("none", "jacobi", "bjacobi_ilu0", "ilu0_neumann")
_HALO_MODES = ("auto", "ppermute", "allgather")


def _engine(local_engine: str) -> str:
    """The JAX auto rule takes "xla" off a TPU (dist_solver.py:709-711);
    here "auto" is "xla" on every device until the kernel engines are
    ported."""
    if local_engine in ("auto", "xla"):
        return "xla"
    if local_engine in ("pallas", "stencil"):
        raise NotImplementedError(
            f"local_engine={local_engine!r}: the distributed solver's kernel"
            f" engines are not ported yet (ROADMAP A11b); use"
            f" local_engine='xla' or 'auto'")
    raise ValueError(f"unknown local_engine {local_engine!r}")


def _make_local_matvec(offsets, halo: int, shard_rows: int, comm: ShardComm,
                       overlap: bool = True):
    """The banded matvec of a process's shards, ``matvec(data, x)`` with
    ``data`` ``(ndiag, S, s)`` and ``x`` ``(S, s)`` (dist_solver.py:45-98).
    The halos past the mesh's ends are zeros, the global boundary
    condition (row-aligned DIA data is zero where a diagonal leaves the
    matrix).

    ``overlap=True`` (needs ``s ≥ 2w``) computes the interior rows ``[w,
    s − w)``, which read only local x, apart from the edge rows, so that
    the halo strips from the neighbouring processes are in flight while the
    interior is multiplied.  Each row's products and sums are the unsplit
    form's, in its order, so the two agree bit for bit."""
    w, s = halo, shard_rows
    ndev = comm.mesh.ndev
    split = overlap and w > 0 and ndev > 1 and s >= 2 * w

    def band(data, x_ext, rows: slice, n: int):
        # y = Σ_k data[k]·x_ext[w + off_k ...], a sum in the offsets' order
        y = None
        for k, off in enumerate(offsets):
            t = data[k][:, rows] * x_ext[:, w + off: w + off + n]
            y = t if y is None else y + t
        return y

    def matvec(data, xl):
        if w == 0 or ndev == 1:
            return band(data, F.pad(xl, (w, w)), slice(None), s)
        pending = comm.start_halos(xl, w)
        if not split:
            left, right = comm.halos(xl, w, pending)
            return band(data, torch.cat([left, xl, right], dim=1),
                        slice(None), s)
        # interior rows [w, s − w): row + off stays in [0, s) for |off| ≤ w
        y_int = band(data, xl, slice(w, s - w), s - 2 * w)
        left, right = comm.halos(xl, w, pending)
        # rows [0, w) read x_ext[−w, 2w), rows [s − w, s) read [s − 2w, s + w)
        y_l = band(data, torch.cat([left, xl[:, :2 * w]], dim=1),
                   slice(0, w), w)
        y_r = band(data, torch.cat([xl[:, s - 2 * w:], right], dim=1),
                   slice(s - w, s), w)
        return torch.cat([y_l, y_int, y_r], dim=1)

    return matvec


def _make_local_matvec_ell(comm: ShardComm):
    """The general matvec: gather all of x, multiply each shard's ELL rows
    (``values``, ``cols`` ``(S, s, K)``; dist_solver.py:846-854)."""

    def matvec(mat, xl):
        values, cols = mat
        return (values * comm.all_gather(xl)[cols]).sum(-1)

    return matvec


def _psum_dot(comm: ShardComm):
    """⟨u, v⟩ over the mesh (dist_solver.py:465-469: ``psum(jnp.dot(u_l,
    v_l))``): each shard's partial, then :meth:`ShardComm.psum` — one
    collective a dot, as in the JAX loop."""

    def dot(u, v):
        return comm.psum((u * v).sum(dim=1))

    return dot


def put_global(host_array, mesh: Mesh, dtype=None, axis: int = 0
               ) -> torch.Tensor:
    """This process's shards of a host array whose ``axis`` runs over the
    mesh's padded rows, on the mesh's device, that axis split into ``(S,
    shard_rows)`` (dist_solver.py:472-480: every process holds the whole
    host array and takes its own shards)."""
    host = np.asarray(host_array)
    rows = host.shape[axis] // mesh.ndev
    lo = mesh.first * rows
    part = np.take(host, np.arange(lo, lo + mesh.local * rows), axis=axis)
    part = part.reshape(host.shape[:axis] + (mesh.local, rows)
                        + host.shape[axis + 1:])
    t = torch.from_numpy(np.ascontiguousarray(part))
    return t.to(device=mesh.device, dtype=dtype if t.is_floating_point()
                else None)


def fetch_global(x: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """The whole ``(npad,)`` vector of a sharded ``(S, shard_rows)`` one,
    on every process (dist_solver.py:483-489)."""
    return ShardComm(mesh).all_gather(x).cpu().numpy()


def _sharded_matvec(part, comm: ShardComm, dtype):
    """``x ↦ A x`` over this process's shards of a partition, its arrays
    uploaded once: halos for a :class:`RowPartitionedBanded` (overlapped
    with the interior rows where the strips cross processes: in one
    process nothing is in flight to hide), the all-gather for a
    :class:`RowPartitionedELL`."""
    mesh = comm.mesh
    if isinstance(part, RowPartitionedELL):
        mat = (put_global(part.values, mesh, dtype),
               put_global(part.cols, mesh).long())
        mv = _make_local_matvec_ell(comm)
    else:
        mat = put_global(part.data, mesh, dtype, axis=1)
        mv = _make_local_matvec(part.offsets, part.halo, part.shard_rows,
                                comm, overlap=comm.world > 1)
    return lambda x: mv(mat, x)


def make_dist_spmv(part, mesh: Mesh, dtype=torch.float32,
                   local_engine: str = "xla"):
    """The distributed SpMV ``y = A x`` of a partition
    (dist_solver.py:492-552): returns ``(fn, put)``, where ``put(v)``
    shards a host vector and ``fn(x)`` multiplies a sharded one."""
    _engine(local_engine)

    def put(v):
        return put_global(part.pad_vector(np.asarray(v)), mesh, dtype)

    return _sharded_matvec(part, ShardComm(mesh), dtype), put


def dist_spmv(a, x: np.ndarray, mesh: Mesh, dtype=torch.float64,
              local_engine: str = "xla") -> np.ndarray:
    """One distributed SpMV of a host matrix and vector
    (dist_solver.py:555-577)."""
    _engine(local_engine)
    part = RowPartitionedBanded.from_matrix(a, mesh.ndev)
    fn, put = make_dist_spmv(part, mesh, dtype, local_engine)
    return part.unpad_vector(fetch_global(fn(put(x)), mesh))


class DistBicgstabSolver:
    """A prepared distributed solver (dist_solver.py:580-658): partition,
    preconditioner and sharded operators built once by
    :func:`make_dist_bicgstab`; :meth:`solve` runs any number of
    right-hand sides (the reference's setup/solve split,
    pbicgstab.cu:335-363 vs :366)."""

    def __init__(self, a, part, mesh: Mesh, run, dtype, config: SolverConfig,
                 dt_setup: float):
        self.a = a
        self.part = part
        self.mesh = mesh
        self._run = run
        self._dt = dtype
        self._config = config
        self.dt_setup = dt_setup

    def _put_vec(self, v) -> torch.Tensor:
        return put_global(self.part.pad_vector(np.asarray(v)), self.mesh,
                          self._dt)

    def solve(self, b: np.ndarray,
              x0: Optional[np.ndarray] = None) -> SolveResult:
        """Solve ``A x = b``; ``x0`` defaults to all-ones (reference
        pbicgstab.cu:827-832).  ``dt_alg`` excludes the uploads (reference
        pbicgstab.h:108-109); the true residual is attached as the
        single-device solve does."""
        part = self.part
        bp = self._put_vec(b)
        x0p = self._put_vec(np.ones(part.n) if x0 is None else x0)
        device_sync(self.mesh.device)
        t1 = time.perf_counter()
        x, status, iters, nrmr, nrmr0, hist = self._run(x0p, bp)
        device_sync(self.mesh.device)
        t2 = time.perf_counter()
        status = int(status)
        if status == _RUNNING:
            status = SolverStatus.MAXIT
        res = SolveResult(
            x=part.unpad_vector(fetch_global(x, self.mesh)),
            status=SolverStatus(status), iters=int(iters),
            residual=float(nrmr), residual0=float(nrmr0), dt_alg=t2 - t1,
            dt_setup=self.dt_setup, residual_history=hist.cpu().numpy())
        return _attach_true_residual(res, self.a, b, self._config)


def dist_bicgstab(a, b: np.ndarray, mesh: Mesh,
                  config: SolverConfig = DEFAULT_CONFIG,
                  x0: Optional[np.ndarray] = None,
                  halo_mode: str = "auto",
                  local_engine: str = "auto") -> SolveResult:
    """One-shot row-partitioned BiCGSTAB over the mesh (dist_solver.py:
    661-670); :func:`make_dist_bicgstab` keeps the setup for more
    right-hand sides."""
    return make_dist_bicgstab(a, mesh, config, halo_mode,
                              local_engine).solve(b, x0)


def make_dist_bicgstab(a, mesh: Mesh, config: SolverConfig = DEFAULT_CONFIG,
                       halo_mode: str = "auto",
                       local_engine: str = "auto") -> DistBicgstabSolver:
    """Partition ``a``, build the preconditioner and the sharded operators
    for row-partitioned BiCGSTAB over the mesh (dist_solver.py:673-1151,
    its "xla" engine).

    ``config.precond``: "none" (or "identity") runs the h-form loop;
    "jacobi" the preconditioned loop with a sharded 1/diag;
    "bjacobi_ilu0" with each shard's own ILU(0) (:mod:`.dist_precond`);
    "ilu0_neumann" with the truncated Neumann series of the *global*
    ILU(0) factors, each term a banded matvec of the sharded N_l or N_u
    through the same halos as A (the exact factors: the JAX package takes
    its constant ones only on the "stencil" engine).  Exact global ILU(0)
    is a sequential recurrence: use the single-device solver for it.

    ``halo_mode``: "auto" partitions a banded matrix by rows with halos
    (ppermute) and any other as ELL with an all-gather of x; "ppermute" and
    "allgather" force one.  ``local_engine``: "auto" and "xla" run this
    engine; "pallas" and "stencil" raise NotImplementedError (ROADMAP
    A11b)."""
    t0 = time.perf_counter()
    _engine(local_engine)
    if halo_mode not in _HALO_MODES:
        raise ValueError(f"unknown halo_mode {halo_mode!r}")
    dt = _dtype_of(config)
    ndev = mesh.ndev
    comm = ShardComm(mesh)
    mode = config.precond or "none"
    if mode == "identity":
        mode = "none"
    if mode not in _PRECONDS:
        raise ValueError(
            f"distributed solver supports precond none/jacobi/bjacobi_ilu0/"
            f"ilu0_neumann, got {config.precond!r}")

    banded = False
    if halo_mode in ("auto", "ppermute"):
        try:
            part = RowPartitionedBanded.from_matrix(a, ndev)
            banded = True
        except ValueError:
            if halo_mode == "ppermute":
                raise
    if not banded:
        part = RowPartitionedELL.from_matrix(a, ndev)

    matvec = _sharded_matvec(part, comm, dt)
    diag = part.data[part.offsets.index(0)] if banded else part.diag

    msolve = None
    if mode == "jacobi":
        if np.any(diag == 0):
            raise ValueError("Jacobi preconditioner requires a nonzero diagonal")
        inv_diag = put_global(1.0 / diag, mesh, dt)
        msolve = lambda f: inv_diag * f  # noqa: E731
    elif mode == "ilu0_neumann":
        if not banded:
            raise ValueError("ilu0_neumann requires a banded (DIA) partition;"
                             " use jacobi for general sparsity")
        if not isinstance(a, CSRMatrix):
            raise ValueError(
                "ilu0_neumann needs a CSRMatrix input (the ILU(0)"
                f" factorization runs on the CSR pattern); got {type(a).__name__}")
        from cuda_mat_tpu_torch.precond.preconditioners import neumann_factors

        low, up, diag_m = neumann_factors(a, config.milu_omega)
        nl_mv, nu_mv = (_sharded_matvec(
            RowPartitionedBanded.from_matrix(f, ndev), comm, dt)
            for f in (low, up))
        # pad rows: inv_d = 1 (the factors' identity padding keeps zero pad
        # entries a fixed point of every series term)
        invd = np.ones(part.npad)
        invd[: part.n] = 1.0 / diag_m
        inv_d = put_global(invd, mesh, dt)
        nterms = config.neumann_terms

        def msolve(f):
            # L⁻¹ ≈ Σ (−N_l)^j, U⁻¹ ≈ Σ (−N_u)^j D⁻¹: the update order of
            # the single-device NeumannILUPreconditioner.msolve
            y = term = f
            for _ in range(nterms - 1):
                term = -nl_mv(term)
                y = y + term
            g = inv_d * y
            x = term = g
            for _ in range(nterms - 1):
                term = -nu_mv(term)
                x = x + term
            return x
    elif mode == "bjacobi_ilu0":
        if not banded:
            raise ValueError("bjacobi_ilu0 requires a banded (DIA) partition;"
                             " use jacobi for general sparsity")
        from cuda_mat_tpu_torch.parallel.dist_precond import (
            build_block_jacobi_ilu, local_solver_from_stacked)

        tb = min(config.trisolve_block, part.shard_rows)
        stacked = build_block_jacobi_ilu(part, tb, dt,
                                         milu_omega=config.milu_omega)
        lo = mesh.first
        msolve = local_solver_from_stacked(
            *(torch.from_numpy(s[lo:lo + mesh.local]).to(mesh.device)
              for s in stacked), part.shard_rows, tb).msolve

    cfg = config
    dot = _psum_dot(comm)

    def run(x0, b):
        if msolve is None:
            return hform_core(matvec, dot, x0, b, cfg.tol,
                              cfg.breakdown_tol, cfg.maxit, cfg.debug)
        return precond_core(matvec, msolve, dot, x0, b, cfg.tol,
                            cfg.maxit, check_halves=cfg.check_halves,
                            debug=cfg.debug)

    device_sync(mesh.device)
    return DistBicgstabSolver(a, part, mesh, run, dt, config,
                              time.perf_counter() - t0)
