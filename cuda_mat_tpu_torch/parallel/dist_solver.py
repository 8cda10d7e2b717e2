"""Row-partitioned SpMV and BiCGSTAB over a mesh of row shards (counterpart
of :mod:`cuda_mat_tpu.parallel.dist_solver`).

The JAX package runs the whole loop inside one ``shard_map``.  Here the
same work is done on each process's ``(S, shard_rows)`` block of every
vector (:mod:`.collectives`), with one of three local engines, as in JAX:

- ``"xla"``: stock torch ops (the JAX engine of that name: XLA's own ops);
- ``"pallas"``: kernel B3 (``ops.dia_spmv``) on each shard's banded rows;
- ``"stencil"``: kernel B1 (``ops.stencil``) on a constant grid stencil
  with each shard's base row, and the fused Neumann msolve B2 (B5 with
  ``fuse_blas1``) in one launch.

The kernel engines keep the loop vectors in the *carry* layout, ``(S,
shard_rows + 2·block)``: each shard's rows between two zero pad blocks
(:func:`_to_carry`), so a matvec or msolve is one launch for the S shards
of a process, whatever S is.  Inside one process the halos go into the
neighbouring shards' pad blocks before the launch and the pads are zeroed
after it (the scatter form); across processes the kernel runs on the
local-only carry while the edge strips are in flight, and the rows that
read them are recomputed in torch in the kernel's op order (the split
form, bit for bit the scatter form's).

Everywhere:

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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cuda_mat_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from cuda_mat_tpu_torch.formats.csr import CSRMatrix
from cuda_mat_tpu_torch.ops import _kernels
from cuda_mat_tpu_torch.ops import stencil as _st
from cuda_mat_tpu_torch.ops.dia_spmv import dia_spmv_block_padded
from cuda_mat_tpu_torch.parallel.collectives import ShardComm
from cuda_mat_tpu_torch.parallel.mesh import Mesh
from cuda_mat_tpu_torch.parallel.partition import (RowPartitionedBanded,
                                                   RowPartitionedELL,
                                                   RowPartitionedStencil)
from cuda_mat_tpu_torch.solvers.bicgstab import (PreparedSolver, _dtype_of,
                                                 hform_core, precond_core)
from cuda_mat_tpu_torch.solvers.result import SolveResult
from cuda_mat_tpu_torch.utils import timing
from cuda_mat_tpu_torch.utils.timing import device_sync

_PRECONDS = ("none", "jacobi", "bjacobi_ilu0", "ilu0_neumann")
_HALO_MODES = ("auto", "ppermute", "allgather")
_ENGINES = ("auto", "xla", "pallas", "stencil")


def _pallas_blocks(w: int, device) -> Tuple[int, int]:
    """``(block, sub)`` of the "pallas" engine's carry layout
    (dist_solver.py:101-109).  The JAX rule is keyed on interpret mode;
    here on the mesh's device: a CUDA mesh takes the accelerator's values
    (sub the bandwidth rounded up to 1024, block the first multiple of sub
    of at least 4096), a CPU mesh the interpret values (8 and 32), so that
    the CPU tests compare the JAX package's CPU layouts.  On Hopper they fix
    only pad widths: kernel B3 reads x at any offset within a pad block."""
    cpu = torch.device(device).type == "cpu"
    unit = 8 if cpu else 1024
    sub = -(-max(w, 1) // unit) * unit
    base = 32 if cpu else 4096
    block = -(-max(base, sub) // sub) * sub
    return block, sub


def _to_carry(v, ndev: int, shard_rows: int, block: int, fill: float = 0.0):
    """A partition-padded vector in the carry layout (dist_solver.py:
    112-122): each shard's rows between two pad blocks of ``block``
    entries, ``fill`` in them (0 for loop vectors, a fixed point of the
    kernels and of every BLAS1 op; 1 for inverse-diagonal streams, so that
    inv_d·0 stays an exact 0).  A host array of ``ndev·shard_rows`` gives
    one of ``ndev·(shard_rows + 2·block)``; an ``(S, shard_rows)`` tensor
    gives ``(S, shard_rows + 2·block)``."""
    if isinstance(v, torch.Tensor):
        return F.pad(v, (block, block), value=fill)
    m = np.asarray(v).reshape(ndev, shard_rows)
    return np.pad(m, ((0, 0), (block, block)),
                  constant_values=fill).reshape(-1)


def _from_carry(vc, ndev: int, shard_rows: int, block: int):
    """Inverse of :func:`_to_carry` (dist_solver.py:125-130): the pad
    blocks dropped."""
    if isinstance(vc, torch.Tensor):
        return vc[:, block:block + shard_rows]
    m = np.asarray(vc).reshape(ndev, shard_rows + 2 * block)
    return np.ascontiguousarray(
        m[:, block: block + shard_rows]).reshape(-1)


def _scatter_halos(comm: ShardComm, xc: torch.Tensor, block: int, s: int,
                   w: int) -> None:
    """The scatter form's halos: the ``w`` x entries before and after each
    shard's rows written into its pad blocks (dist_solver.py:180-184, which
    writes them into a copy).  Here they go into the carry itself, and
    :func:`_clear_halos` zeroes them again after the launch: inside one
    process two strided copies between neighbouring rows and one fill, a
    few (S, w) strips, where a copy would move the whole vector."""
    if comm.world == 1:
        xc[:-1, block + s:block + s + w] = xc[1:, block:block + w]
        xc[1:, block - w:block] = xc[:-1, block + s - w:block + s]
        return
    left, right = comm.halos(xc[:, block:block + s], w)
    xc[:, block - w:block] = left
    xc[:, block + s:block + s + w] = right


def _clear_halos(comm: ShardComm, xc: torch.Tensor, block: int, s: int,
                 w: int) -> None:
    if comm.world == 1:
        # both strips between neighbouring shards: one strided view
        assert xc.is_contiguous()
        xc.as_strided((xc.shape[0] - 1, 2, w), (xc.shape[1], 2 * block - w, 1),
                      xc.storage_offset() + block + s).zero_()
        return
    xc[:, block - w:block] = 0
    xc[:, block + s:block + s + w] = 0


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


def _shard_bases(comm: ShardComm, s: int, device) -> torch.Tensor:
    """``(S, 1)``: the global row of each of this process's shards' first
    row (the JAX ``axis_index · shard_rows``)."""
    return (comm.mesh.first + torch.arange(comm.local, device=device)
            )[:, None] * s


def _make_local_matvec_pallas(offsets, halo: int, shard_rows: int,
                              comm: ShardComm, block: int, sub: int,
                              overlap: bool = True):
    """Kernel B3 a shard on the carry layout, ``matvec(data, xc)`` with
    ``data`` ``(ndiag, S, s)`` and ``xc`` ``(S, s + 2·block)``: one launch
    for the process's S shards (dist_solver.py:133-199).

    ``overlap=True`` (needs ``s ≥ 2w``), the split form: the kernel runs on
    the local-only carry while the halo strips are in flight, and the 2w
    edge rows, the only ones that read halos, are recomputed in torch in
    the kernel's op order (the first diagonal's product, then one add a
    diagonal in offset order) and overwrite the kernel's.  ``False``, the
    scatter form: the halos go into the pad blocks before the launch
    (:func:`_scatter_halos`).  The two agree bit for bit."""
    w, s = halo, shard_rows
    ndev = comm.mesh.ndev
    assert s % block == 0 and block % sub == 0
    split = overlap and w > 0 and ndev > 1 and s >= 2 * w

    def edge_rows(data, xe, row0: int):
        acc = None
        for k, off in enumerate(offsets):
            t = data[k][:, row0:row0 + w] * xe[:, w + off:w + off + w]
            acc = t if acc is None else acc + t
        return acc

    def matvec(data, xc):
        if w == 0 or ndev == 1:
            return dia_spmv_block_padded(data, xc, offsets, block, sub)
        if not split:
            _scatter_halos(comm, xc, block, s, w)
            y = dia_spmv_block_padded(data, xc, offsets, block, sub)
            _clear_halos(comm, xc, block, s, w)
            return y
        rows = xc[:, block:block + s]
        pending = comm.start_halos(rows, w)
        y = dia_spmv_block_padded(data, xc, offsets, block, sub)
        left, right = comm.halos(rows, w, pending)
        # rows [0, w) read x rows [-w, 2w); rows [s-w, s) read [s-2w, s+w)
        y[:, block:block + w] = edge_rows(
            data, torch.cat([left, rows[:, :2 * w]], dim=1), 0)
        y[:, block + s - w:block + s] = edge_rows(
            data, torch.cat([rows[:, s - 2 * w:], right], dim=1), s - w)
        return y

    return matvec


def _make_local_matvec_stencil(part: RowPartitionedStencil, comm: ShardComm,
                               overlap: bool = True, sterms=None, halo=None):
    """Kernel B1 a shard on the carry layout, ``matvec(gapmask, xc)``: one
    launch for the S shards, each with its global base row, so that the
    strided tail ``[np_true, npad)`` stays an exact zero
    (dist_solver.py:202-282).  ``sterms``/``halo``: another stencil on A's
    layout (the factors' series polynomials).

    ``overlap=True``: the split form; the edge rows are recomputed in the
    kernel's op order (terms in order, then the gap multiply, then the tail
    select), bit for bit the scatter form's."""
    w = part.halo if halo is None else halo
    s, block, sub = part.shard_rows, part.block, part.sub
    sterms = part.strided_terms if sterms is None else sterms
    np_true, ndev = part.np_true, part.ndev
    assert s % block == 0 and block % sub == 0 and w <= sub
    split = overlap and w > 0 and ndev > 1 and s >= 2 * w
    base = comm.mesh.first * s

    def edge_rows(xe, gap, row0):
        acc = None
        for off, scal in sterms:
            t = _st._coef(scal, xe.dtype) * xe[:, w + off:w + off + w]
            acc = t if acc is None else acc + t
        acc = acc * gap
        t = row0 + torch.arange(w, device=xe.device)
        return torch.where(t < np_true, acc, torch.zeros_like(acc))

    def kernel(gap, xc):
        return _st.const_stencil_spmv_padded(xc, gap, sterms, np_true, block,
                                             sub, base)

    def matvec(gap, xc):
        if w == 0 or ndev == 1:
            return kernel(gap, xc)
        if not split:
            _scatter_halos(comm, xc, block, s, w)
            y = kernel(gap, xc)
            _clear_halos(comm, xc, block, s, w)
            return y
        rows = xc[:, block:block + s]
        pending = comm.start_halos(rows, w)
        y = kernel(gap, xc)
        left, right = comm.halos(rows, w, pending)
        bases = _shard_bases(comm, s, xc.device)
        y[:, block:block + w] = edge_rows(
            torch.cat([left, rows[:, :2 * w]], dim=1), gap[:w], bases)
        y[:, block + s - w:block + s] = edge_rows(
            torch.cat([rows[:, s - 2 * w:], right], dim=1), gap[block - w:],
            bases + (s - w))
        return y

    return matvec


def _make_local_msolve_kernel(part: RowPartitionedStencil, comm: ShardComm,
                              terms_l, terms_u, overlap: bool = True,
                              fma: bool = False):
    """The one-launch fused Neumann msolve a shard, ``y = P_u (inv_d ∘ P_l
    x)``, kernel B2 on the carry layout (dist_solver.py:285-462):
    ``msolve(gap_ext, d_pad, xc)``, with ``d_pad`` each shard's ``(s +
    2·block)`` window of the global strided inv_d (the neighbours' values
    in the pad blocks, set up once) and ``gap_ext`` the extended gap mask.

    ``overlap=True``: the split form.  The kernel runs on the local-only
    carry; the rows whose composition reaches past the shard, ``[0, wl)``
    and ``[s − wr, s)``, are recomputed in torch through the kernel's two
    stages in its op order — ``u = (Σ c_l·x)·gap·inv_d`` over an extended
    window, zeroed outside the global rows ``[0, np_true)``, then ``y =
    (Σ c_u·u)·gap`` with the tail mask.  The port rounds every product and
    sum on its own, so the split form equals the scatter form bit for bit
    (the JAX package allows 2 ulp there, for XLA's FMA contraction).

    ``fma=True`` returns the BLAS1-prologue form, kernel B5:
    ``msolve_fma(gap_ext, d_pad, a, c1, b, c2, c) -> (p, y)`` with ``p =
    a + c1·(b + c2·c)`` formed in the kernel.  Inside one process the
    halos of a, b and c go into their pad blocks, so that the kernel forms
    the neighbours' p there itself: one launch, as on one device (the JAX
    scatter form forms p apart and runs the plain msolve).  Across
    processes the halo strips are the combination, formed on the edge
    windows."""
    hpad = _st.msolve_halo(terms_u)
    lo_l = min(o for o, _ in terms_l)
    hi_l = max(o for o, _ in terms_l)
    lo_u = min(o for o, _ in terms_u)
    hi_u = max(o for o, _ in terms_u)
    h_l = max(abs(lo_l), abs(hi_l))
    w = h_l + hpad                       # scatter-form halo width
    s, block, sub = part.shard_rows, part.block, part.sub
    np_true, ndev, stride = part.np_true, part.ndev, part.stride
    assert w <= sub and w <= s and hpad <= block
    # composition reach: y row j reads x rows [j+lo_u+lo_l, j+hi_u+hi_l], so
    # only rows [0, wl) and [s-wr, s) depend on halo x
    wl = max(0, -(lo_u + lo_l))
    wr = max(0, hi_u + hi_l)
    wb = max(wl, wr, 1)                  # exchanged halo width (split form)
    split = bool(overlap and ndev > 1 and (wl or wr)
                 and s >= 2 * (wl + wr) and wb <= s)
    gm = np.asarray(part.gapmask[:stride], np.float64)
    base = comm.mesh.first * s

    def gap_of(idx0: int, nrows: int, like: torch.Tensor) -> torch.Tensor:
        # the gap mask at local rows [idx0, idx0 + nrows): shard bases and
        # shard_rows are stride multiples, so it is the same on every shard
        return torch.as_tensor(gm[np.arange(idx0, idx0 + nrows) % stride]).to(
            dtype=like.dtype, device=like.device)

    def edge_y(xe, d_pad, bases, j0: int, nrows: int):
        # y rows [j0, j0 + nrows) through the kernel's two stages; xe[:, 0]
        # is x row j0 + lo_u + lo_l
        dt = xe.dtype
        u0, u1 = lo_u, nrows + hi_u
        nu = u1 - u0
        acc = None
        for off, scal in terms_l:
            t = _st._coef(scal, dt) * xe[:, off - lo_l:off - lo_l + nu]
            acc = t if acc is None else acc + t
        u = acc * gap_of(j0 + u0, nu, xe) * d_pad[
            :, block + j0 + u0:block + j0 + u1]
        tu = bases + (j0 + u0) + torch.arange(nu, device=xe.device)
        u = torch.where((tu >= 0) & (tu < np_true), u, torch.zeros_like(u))
        acc2 = None
        for off, scal in terms_u:
            t = _st._coef(scal, dt) * u[:, off - u0:off - u0 + nrows]
            acc2 = t if acc2 is None else acc2 + t
        y = acc2 * gap_of(j0, nrows, xe)
        ty = bases + j0 + torch.arange(nrows, device=xe.device)
        return torch.where(ty < np_true, y, torch.zeros_like(y))

    def fix_edges(y, edge_src, left, right, d_pad):
        # edge_src(lo, hi): the kernel's input on local rows [lo, hi)
        bases = _shard_bases(comm, s, y.device)
        if wl:
            xe = torch.cat([left[:, wb - wl:], edge_src(0, wl + wr)], dim=1)
            y[:, block:block + wl] = edge_y(xe, d_pad, bases, 0, wl)
        if wr:
            xe = torch.cat([edge_src(s - wr - wl, s), right[:, :wr]], dim=1)
            y[:, block + s - wr:block + s] = edge_y(xe, d_pad, bases, s - wr,
                                                    wr)

    def kernel(gap_ext, d_pad, xc):
        return _st.const_series_msolve_padded(xc, d_pad, gap_ext, terms_l,
                                              terms_u, np_true, block, sub,
                                              base)

    def msolve(gap_ext, d_pad, xc):
        if ndev == 1:
            return kernel(gap_ext, d_pad, xc)
        if not split:
            _scatter_halos(comm, xc, block, s, w)
            y = kernel(gap_ext, d_pad, xc)
            _clear_halos(comm, xc, block, s, w)
            return y
        rows = xc[:, block:block + s]
        pending = comm.start_halos(rows, wb)
        y = kernel(gap_ext, d_pad, xc)
        left, right = comm.halos(rows, wb, pending)
        fix_edges(y, lambda lo, hi: rows[:, lo:hi], left, right, d_pad)
        return y

    if not fma:
        return msolve

    def msolve_fma(gap_ext, d_pad, ac, c1, bc, c2=None, cc=None):
        def fused():
            return _st.const_series_msolve_fma_padded(
                ac, c1, bc, c2, cc, d_pad, gap_ext, terms_l, terms_u,
                np_true, block, sub, base)

        vecs = (ac, bc) if cc is None else (ac, bc, cc)
        if ndev == 1:
            return fused()
        if not split:
            for v in vecs:
                _scatter_halos(comm, v, block, s, w)
            p, y = fused()
            for v in vecs:
                _clear_halos(comm, v, block, s, w)
            return p, y

        def comb(lo, hi):   # the combination on local rows [lo, hi)
            sl = slice(block + lo, block + hi)
            return _st.fma_combine(ac[:, sl], c1, bc[:, sl], c2,
                                   None if cc is None else cc[:, sl])

        # the strips the neighbours need: the combination on both edges
        edges = torch.cat([comb(0, wb), comb(s - wb, s)], dim=1)
        pending = comm.start_halos(edges, wb)
        p, y = fused()
        left, right = comm.halos(edges, wb, pending)
        fix_edges(y, comb, left, right, d_pad)
        return p, y

    return msolve_fma


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


class MeshLayout:
    """How a vector of ``n`` entries lies on the mesh: partition-padded, in
    the carry layout where ``carry_block`` is not 0, as this process's
    shards of ``dtype`` on ``device``; :meth:`put` and :meth:`fetch` cross
    it."""

    def __init__(self, part, mesh: Mesh, carry_block: int, dtype):
        self.part = part
        self.mesh = mesh
        self.carry_block = carry_block
        self.dtype = dtype
        self.n = part.n
        self.device = mesh.device

    def put(self, v, fill: float = 0.0) -> torch.Tensor:
        """This process's shards of the host vector ``v``, ``fill`` in
        every pad entry (0 for loop vectors; 1 for inverse diagonals)."""
        part = self.part
        vp = part.pad_vector(np.asarray(v), fill)
        if self.carry_block:
            vp = _to_carry(vp, part.ndev, part.shard_rows, self.carry_block,
                           fill)
        return put_global(vp, self.mesh, self.dtype)

    def fetch(self, x: torch.Tensor) -> np.ndarray:
        """The whole host vector of the sharded ``x``, on every process."""
        part = self.part
        xh = fetch_global(x, self.mesh)
        if self.carry_block:
            xh = _from_carry(xh, part.ndev, part.shard_rows, self.carry_block)
        return part.unpad_vector(xh)


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


def _replicated(v, mesh: Mesh, dtype) -> torch.Tensor:
    """A host array every shard reads whole (the JAX ``P()`` spec)."""
    return torch.as_tensor(np.asarray(v)).to(device=mesh.device, dtype=dtype)


def make_dist_spmv(part, mesh: Mesh, dtype=torch.float32,
                   local_engine: str = "xla"):
    """The distributed SpMV ``y = A x`` of a partition
    (dist_solver.py:492-552): returns ``(fn, put)``, where ``put(v)``
    shards a host vector and ``fn(x)`` multiplies a sharded one.

    ``local_engine``: "xla" (or "auto") stock torch ops; "pallas" kernel B3
    a shard (build ``part`` with ``align=_pallas_blocks(w, device)[0]``);
    "stencil" kernel B1 a shard (``part`` a :class:`RowPartitionedStencil`).
    ``put`` is the :meth:`MeshLayout.put` of the engine's layout; its
    :meth:`~MeshLayout.fetch` recovers the true vector, as
    :func:`dist_spmv` does."""
    fn, layout = _spmv_and_layout(part, mesh, dtype, local_engine)
    return fn, layout.put


def _spmv_and_layout(part, mesh: Mesh, dtype, local_engine: str):
    if local_engine not in _ENGINES:
        raise ValueError(f"unknown local_engine {local_engine!r}")
    comm = ShardComm(mesh)
    carry_block = 0
    if local_engine == "stencil":
        gap = _replicated(part.gapmask, mesh, dtype)
        mv_st = _make_local_matvec_stencil(part, comm, overlap=comm.world > 1)
        fn = lambda x: mv_st(gap, x)  # noqa: E731
        carry_block = part.block
    elif local_engine == "pallas":
        blk, sub = _pallas_blocks(part.halo, mesh.device)
        data = put_global(part.data, mesh, dtype, axis=1)
        mv_p = _make_local_matvec_pallas(part.offsets, part.halo,
                                         part.shard_rows, comm, blk, sub,
                                         overlap=comm.world > 1)
        fn = lambda x: mv_p(data, x)  # noqa: E731
        carry_block = blk
    else:
        fn = _sharded_matvec(part, comm, dtype)
    return fn, MeshLayout(part, mesh, carry_block, dtype)


def dist_spmv(a, x: np.ndarray, mesh: Mesh, dtype=torch.float64,
              local_engine: str = "xla") -> np.ndarray:
    """One distributed SpMV of a host matrix and vector
    (dist_solver.py:555-577)."""
    if local_engine not in _ENGINES:
        raise ValueError(f"unknown local_engine {local_engine!r}")
    if local_engine == "stencil":
        part = RowPartitionedStencil.from_matrix(a, mesh.ndev)
    else:
        align = 1
        if local_engine == "pallas":
            dia = a.to_dia(max_diags=128) if hasattr(a, "to_dia") else a
            align = _pallas_blocks(dia.bandwidth, mesh.device)[0]
        part = RowPartitionedBanded.from_matrix(a, mesh.ndev, align=align)
    fn, layout = _spmv_and_layout(part, mesh, dtype, local_engine)
    return layout.fetch(fn(layout.put(x)))


class DistBicgstabSolver(PreparedSolver):
    """A prepared distributed solver (dist_solver.py:580-658): partition,
    preconditioner and sharded operators built once by
    :func:`make_dist_bicgstab`; :meth:`solve` runs any number of
    right-hand sides (the reference's setup/solve split,
    pbicgstab.cu:335-363 vs :366) through :meth:`PreparedSolver.solve`,
    its vectors through its :class:`MeshLayout`, ``op`` (the default x0
    the host's ones).  ``engine`` is the local engine that runs ("xla",
    "pallas" or "stencil"; an ELL partition's all-gather matvec is "xla"
    whatever was asked for); the kernel engines keep the loop vectors in
    the carry layout of pad blocks of ``carry_block`` (0: the plain
    partition-padded layout).  ``msolve_mode``: how ilu0_neumann applies
    M⁻¹ ("kernel", "mono", "series" or "exact"); ``operands``: the loop's
    sharded ``matvec``/``msolve``/``msolve_fma`` and the device arrays and
    terms its kernels take, for measurement."""

    def __init__(self, a, layout: MeshLayout, run, config: SolverConfig,
                 dt_setup: float, engine: str = "xla", msolve_mode=None,
                 operands=None):
        super().__init__(a, layout, None, config, dt_setup)
        self.part = layout.part
        self.mesh = layout.mesh
        self.carry_block = layout.carry_block
        self._run = run
        self.engine = engine
        self.msolve_mode = msolve_mode
        self.operands = operands or {}

    def _prep_vec(self, name: str, v) -> torch.Tensor:
        return self.op.put(v)

    def _ones(self, bd: torch.Tensor) -> torch.Tensor:
        return self.op.put(np.ones(self.n))

    def _download(self, out) -> tuple:
        x, status, iters, nrmr, nrmr0, hist = out
        return (self.op.fetch(x), int(status), int(iters), float(nrmr),
                float(nrmr0), hist.cpu().numpy())

    def _loop(self, x0d: torch.Tensor, bd: torch.Tensor):
        return self._run(x0d, bd)


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


@dataclasses.dataclass
class EnginePlan:
    """What :func:`plan_engine` chose: the local ``engine`` and the
    partition it runs on; ``block``/``sub`` the kernel engines' layout."""

    engine: str
    part: object
    block: int = 0
    sub: int = 0

    @property
    def banded(self) -> bool:
        return not isinstance(self.part, RowPartitionedELL)

    @property
    def stencil(self) -> bool:
        return isinstance(self.part, RowPartitionedStencil)


def _mode(config: SolverConfig) -> str:
    mode = config.precond or "none"
    if mode == "identity":
        mode = "none"
    if mode not in _PRECONDS:
        raise ValueError(
            f"distributed solver supports precond none/jacobi/bjacobi_ilu0/"
            f"ilu0_neumann, got {config.precond!r}")
    return mode


def plan_engine(a, ndev: int, config: SolverConfig = DEFAULT_CONFIG,
                device_type: str = "cuda", halo_mode: str = "auto",
                local_engine: str = "auto") -> EnginePlan:
    """The local engine and partition of ``a`` on ``ndev`` shards of a
    ``device_type`` mesh: a pure function of the device type, the matrix
    and the configuration, decided before any launch (dist_solver.py:
    705-783).

    "auto" on a CUDA mesh: "stencil" where :class:`RowPartitionedStencil`
    proves a constant grid stencil (for the const Neumann factors re-planned
    to the fused series' halo and block, :741-759), else "pallas", and
    always "pallas" for "bjacobi_ilu0" or ``halo_mode="allgather"``; on a
    CPU mesh "xla", the JAX package's rule off its accelerator (:711).  A
    matrix with no narrow band gets the ELL partition and the all-gather
    (its engine "xla": torch ops) unless ``halo_mode="ppermute"``.  An
    explicit "stencil" on a matrix that is not one, or with block-Jacobi
    or the all-gather, raises, as in JAX (:730-734, :765-766)."""
    if local_engine not in _ENGINES:
        raise ValueError(f"unknown local_engine {local_engine!r}")
    if halo_mode not in _HALO_MODES:
        raise ValueError(f"unknown halo_mode {halo_mode!r}")
    mode = _mode(config)
    auto = local_engine == "auto"
    if auto:
        local_engine = "pallas" if device_type == "cuda" else "xla"
    if local_engine == "stencil" or (auto and local_engine == "pallas"):
        if mode == "bjacobi_ilu0" or halo_mode == "allgather":
            if local_engine == "stencil":
                raise ValueError(
                    "local_engine='stencil' requires ppermute halos and"
                    " precond none/jacobi/ilu0_neumann")
            local_engine = "pallas"
        else:
            try:
                dia = a.to_dia(max_diags=128) if isinstance(a, CSRMatrix) \
                    else a
                part = RowPartitionedStencil.from_matrix(dia, ndev)
            except ValueError:
                if local_engine == "stencil":
                    raise
                local_engine = "pallas"   # auto: not a stencil, kernel B3
            else:
                if mode == "ilu0_neumann" and config.neumann_const_factors:
                    # widen the halo sub-block to the series polynomials'
                    # offsets and cap the block as the JAX package plans
                    plan = _st.plan_const_neumann_layout(
                        part.terms, config.neumann_terms, part.c_grid,
                        part.stride, prefer_mono=True,
                        fuse_blas1=config.fuse_blas1)
                    if plan is not None and (plan[0] > part.sub
                                             or part.block > plan[1]):
                        try:
                            part = RowPartitionedStencil.from_matrix(
                                dia, ndev, min_sub=plan[0],
                                block_target=plan[1])
                        except ValueError:
                            pass   # the restrided exact factors still apply
                return EnginePlan("stencil", part, part.block, part.sub)
    if halo_mode in ("auto", "ppermute"):
        try:
            blk = sub = 0
            if local_engine == "pallas":
                dia = a.to_dia(max_diags=128) if hasattr(a, "to_dia") else a
                blk, sub = _pallas_blocks(dia.bandwidth, device_type)
            part = RowPartitionedBanded.from_matrix(a, ndev, align=blk or 1)
            return EnginePlan(local_engine, part, blk, sub)
        except ValueError:
            if halo_mode == "ppermute":
                raise
    return EnginePlan("xla", RowPartitionedELL.from_matrix(a, ndev))


def _const_factor_msolve(low, up, diag_m, part: RowPartitionedStencil,
                         comm: ShardComm, config: SolverConfig, dt, gap,
                         inv_d, overlap: bool):
    """The constant-stencil Neumann factors on the stencil engine
    (dist_solver.py:884-983), in the first mode whose layout holds:

    - "kernel": the whole msolve one launch of B2 a shard (with
      ``fuse_blas1`` and a layout B5 takes, the loop's BLAS1 update folded
      into B5);
    - "mono": P_u·d*·P_l composed into one stencil, one launch of B1;
    - "series": P_l and P_u one B1 launch each, inv_d between.

    The layout test is kernel B1's and B2's/B5's own on the card
    (``_kernels.msolve_fits`` / ``msolve_fma_fits``, as one device's
    preconditioner takes them) and the JAX package's interpret rule on the
    CPU (no block cap), so that the CPU modes are the JAX package's.
    Returns ``(mode, msolve, msolve_fma, operands)``, the last the kernel
    mode's arrays and terms, or None where even the series leaves the
    layout (the restrided exact factors then apply)."""
    on_card = comm.mesh.device.type == "cuda"
    s, c_grid, stride = part.shard_rows, part.c_grid, part.stride
    itemsize = torch.empty((), dtype=dt).element_size()

    def fits(nterms, w_s):
        return w_s <= part.sub and w_s <= s and (
            not on_card or nterms <= _kernels.MAX_TERMS)

    try:
        polys, sts, mvs = [], [], []
        for f in (low, up):
            t, _ = _st.const_factor_terms(f.to_dia(max_diags=128), c_grid,
                                          stride)
            pt = _st.neumann_poly_terms(t, config.neumann_terms, c_grid,
                                        stride)
            sts_f = _st.strided_offsets(pt, c_grid, stride)
            w_s = max(abs(o) for o, _ in sts_f)
            if not fits(len(pt), w_s):
                raise ValueError("series exceeds the layout")
            polys.append(pt)
            sts.append(sts_f)
            mvs.append(_make_local_matvec_stencil(part, comm, overlap,
                                                  sterms=sts_f, halo=w_s))
    except ValueError:
        return None
    hpad = _st.msolve_halo(sts[1])
    w_k = max(abs(o) for o, _ in sts[0]) + hpad
    if hpad <= part.block and w_k <= part.sub and w_k <= s and (
            not on_card or _kernels.msolve_fits(part.block, sts[0], sts[1],
                                                itemsize)):
        ms = _make_local_msolve_kernel(part, comm, sts[0], sts[1], overlap)
        msf = None
        if config.fuse_blas1 and (not on_card or _kernels.msolve_fma_fits(
                part.block, sts[0], sts[1], itemsize)):
            msf = _make_local_msolve_kernel(part, comm, sts[0], sts[1],
                                            overlap, fma=True)
        gap_ext = _replicated(_st.extend_gapmask(part.gapmask, hpad),
                              comm.mesh, dt)
        # each shard's (s + 2 block) window of the global strided inv_d,
        # the neighbours' values in its pad blocks (the kernel reads inv_d
        # as far as P_u reaches past the shard), 1.0 past the ends
        invd_g = np.concatenate([np.ones(part.block),
                                 part.strided_scatter(1.0 / diag_m, fill=1.0),
                                 np.ones(part.block)])
        lo = comm.mesh.first
        d_pad = torch.from_numpy(np.stack([
            invd_g[i * s:i * s + s + 2 * part.block]
            for i in range(lo, lo + comm.local)])).to(
                device=comm.mesh.device, dtype=dt)
        fma = None if msf is None else (
            lambda a_, c1, b_, c2=None, c_=None:
            msf(gap_ext, d_pad, a_, c1, b_, c2, c_))
        return "kernel", (lambda f: ms(gap_ext, d_pad, f)), fma, {
            "gap_ext": gap_ext, "d_pad": d_pad, "terms_l": sts[0],
            "terms_u": sts[1]}
    r_grid = part.n // c_grid
    d_star = float(diag_m[(r_grid // 2) * c_grid + c_grid // 2])
    try:
        mt = _st.compose_stencil_terms(
            polys[1], tuple((o, d, v / d_star) for (o, d, v) in polys[0]),
            c_grid, stride)
        stm = _st.strided_offsets(mt, c_grid, stride)
        w_m = max(abs(o) for o, _ in stm)
        if fits(len(mt), w_m):
            mono = _make_local_matvec_stencil(part, comm, overlap, sterms=stm,
                                              halo=w_m)
            return "mono", (lambda f: mono(gap, f)), None, {"terms": stm}
    except ValueError:
        pass
    pl_mv, pu_mv = mvs
    return "series", (lambda f: pu_mv(gap, inv_d * pl_mv(gap, f))), None, {
        "terms_l": sts[0], "terms_u": sts[1]}


def make_dist_bicgstab(a, mesh: Mesh, config: SolverConfig = DEFAULT_CONFIG,
                       halo_mode: str = "auto",
                       local_engine: str = "auto") -> DistBicgstabSolver:
    """Partition ``a``, build the preconditioner and the sharded operators
    for row-partitioned BiCGSTAB over the mesh (dist_solver.py:673-1152).

    ``config.precond``: "none" (or "identity") runs the h-form loop;
    "jacobi" the preconditioned loop with a sharded 1/diag;
    "bjacobi_ilu0" with each shard's own ILU(0) (:mod:`.dist_precond`);
    "ilu0_neumann" with the truncated Neumann series of the *global*
    ILU(0) factors: on the "stencil" engine with ``neumann_const_factors``
    their constant stencils (:func:`_const_factor_msolve`), otherwise the
    exact factors, row-partitioned like A (restrided into the stencil's
    layout on that engine), each term a banded matvec through the same
    halos.  Exact global ILU(0) is a sequential recurrence: use the
    single-device solver for it.

    ``halo_mode`` and ``local_engine``: see :func:`plan_engine`.  The
    engine that runs is the solver's ``engine``; no engine runs in place of
    another, and a kernel that fails to build or launch raises.  Recorded
    as a ``make_solver`` (:mod:`~cuda_mat_tpu_torch.utils.timing`), whose
    span is ``dt_setup``."""
    with timing.record("make_solver") as rec:
        ds = _build_dist_bicgstab(a, mesh, config, halo_mode, local_engine)
    ds.dt_setup = rec.seconds("make_solver")
    return ds


def _build_dist_bicgstab(a, mesh: Mesh, config: SolverConfig, halo_mode: str,
                         local_engine: str) -> DistBicgstabSolver:
    dt = _dtype_of(config)
    comm = ShardComm(mesh)
    pl = plan_engine(a, mesh.ndev, config, mesh.device.type, halo_mode,
                     local_engine)
    mode = _mode(config)
    part, engine = pl.part, pl.engine
    s = part.shard_rows
    overlap = comm.world > 1
    cb = pl.block if engine in ("pallas", "stencil") else 0
    layout = MeshLayout(part, mesh, cb, dt)

    gap = None
    operands = {}
    if engine == "stencil":
        gap = _replicated(part.gapmask, mesh, dt)
        operands["gapmask"] = gap
        mv_st = _make_local_matvec_stencil(part, comm, overlap)
        matvec = lambda x: mv_st(gap, x)  # noqa: E731
        # a constant stencil's diagonal is its offset-0 scalar everywhere
        d0 = next((t[2] for t in part.terms if t[0] == 0), 0.0)
        diag = np.full(part.n, d0)
    elif engine == "pallas":
        data = put_global(part.data, mesh, dt, axis=1)
        mv_p = _make_local_matvec_pallas(part.offsets, part.halo, s, comm,
                                         pl.block, pl.sub, overlap)
        matvec = lambda x: mv_p(data, x)  # noqa: E731
        diag = part.data[part.offsets.index(0)][:part.n]
        operands.update(data=data, block=pl.block, sub=pl.sub)
    else:
        matvec = _sharded_matvec(part, comm, dt)
        diag = (part.data[part.offsets.index(0)] if pl.banded
                else part.diag)[:part.n]

    msolve = msolve_fma = msolve_mode = None
    if mode == "jacobi":
        if np.any(diag == 0):
            raise ValueError("Jacobi preconditioner requires a nonzero diagonal")
        # pad, gap and tail cells get 1, so that padding stays a fixed point
        inv_diag = layout.put(1.0 / diag, fill=1.0)
        msolve = lambda f: inv_diag * f  # noqa: E731
    elif mode == "ilu0_neumann":
        if not pl.banded:
            raise ValueError("ilu0_neumann requires a banded (DIA) partition;"
                             " use jacobi for general sparsity")
        if not isinstance(a, CSRMatrix):
            raise ValueError(
                "ilu0_neumann needs a CSRMatrix input (the ILU(0)"
                f" factorization runs on the CSR pattern); got {type(a).__name__}")
        from cuda_mat_tpu_torch.precond.preconditioners import neumann_factors

        low, up, diag_m = neumann_factors(a, config.milu_omega)
        # pad and gap rows: inv_d = 1 (the factors' identity padding and
        # zero slots keep zero pad entries a fixed point of every term)
        inv_d = layout.put(1.0 / diag_m, fill=1.0)
        got = None
        if pl.stencil and config.neumann_const_factors:
            got = _const_factor_msolve(low, up, diag_m, part, comm, config,
                                       dt, gap, inv_d, overlap)
        if got is not None:
            msolve_mode, msolve, msolve_fma, more = got
            operands.update(more)
        else:
            msolve_mode = "exact"
            nl_mv, nu_mv = (_factor_matvec(f, pl, comm, dt, overlap)
                            for f in (low, up))
            nterms = config.neumann_terms

            def msolve(f):
                # L⁻¹ ≈ Σ (−N_l)^j, U⁻¹ ≈ Σ (−N_u)^j D⁻¹: the update order
                # of the single-device NeumannILUPreconditioner.msolve
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
        if not pl.banded:
            raise ValueError("bjacobi_ilu0 requires a banded (DIA) partition;"
                             " use jacobi for general sparsity")
        from cuda_mat_tpu_torch.parallel.dist_precond import (
            build_block_jacobi_ilu, local_solver_from_stacked)

        tb = min(config.trisolve_block, s)
        stacked = build_block_jacobi_ilu(part, tb, dt,
                                         milu_omega=config.milu_omega)
        lo = mesh.first
        tri = local_solver_from_stacked(
            *(torch.from_numpy(a_[lo:lo + mesh.local]).to(mesh.device)
              for a_ in stacked), s, tb).msolve
        msolve = tri
        if cb:
            def msolve(f):
                # the blocked trisolve takes the (S, s) rows: slice the
                # carry, solve, pad again (dist_solver.py:1081-1090)
                return F.pad(tri(f[:, cb:cb + s].contiguous()), (cb, cb))

    cfg = config
    dot = _psum_dot(comm)

    def run(x0, b):
        if msolve is None:
            return hform_core(matvec, dot, x0, b, cfg.tol,
                              cfg.breakdown_tol, cfg.maxit, cfg.debug)
        return precond_core(matvec, msolve, dot, x0, b, cfg.tol,
                            cfg.maxit, msolve_fma=msolve_fma,
                            check_halves=cfg.check_halves, debug=cfg.debug)

    operands.update(matvec=matvec, msolve=msolve, msolve_fma=msolve_fma)
    device_sync(mesh.device)
    return DistBicgstabSolver(a, layout, run, config, 0.0, engine=engine,
                              msolve_mode=msolve_mode, operands=operands)


def _factor_matvec(f, pl: EnginePlan, comm: ShardComm, dt, overlap: bool):
    """``x ↦ N x`` for an exact ILU(0) factor ``f`` partitioned like A
    (dist_solver.py:984-1017): on the kernel engines kernel B3 a shard on
    the carry (restrided into the stencil's strided coordinates on the
    "stencil" engine, its zero slots masking gaps and tail), else the
    "xla" engine's torch ops."""
    ndev, s = comm.mesh.ndev, pl.part.shard_rows
    if pl.engine == "xla":
        return _sharded_matvec(RowPartitionedBanded.from_matrix(f, ndev),
                               comm, dt)
    if pl.stencil:
        part = pl.part
        fd = _st.restride_dia(f.to_dia(max_diags=128), part.c_grid,
                              part.stride)
        pf = RowPartitionedBanded.from_matrix(fd, ndev, align=s)
    else:
        pf = RowPartitionedBanded.from_matrix(f, ndev, align=pl.block)
    assert pf.npad == pl.part.npad and pf.shard_rows == s
    data = put_global(pf.data, comm.mesh, dt, axis=1)
    mv = _make_local_matvec_pallas(pf.offsets, pf.halo, s, comm, pl.block,
                                   pl.sub, overlap)
    return lambda x: mv(data, x)
