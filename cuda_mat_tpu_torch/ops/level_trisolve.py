"""Exact ILU(0) triangular solves by level scheduling, for a factor of any
pattern (kernel B8).

The reference applies ILU(0) with cuSPARSE's level-scheduled triangular
solves (analysis at reference pbicgstab.cu:338-345, solves at :92-98):
each triangle's rows are grouped into levels, a row's level one more than
the deepest row it depends on, so the rows of one level depend only on
rows of earlier levels and are solved at once.  Here the analysis runs
once per factor on the host (:func:`row_levels`, :func:`level_plan`,
timed as set-up), and a sweep walks the levels in order over the factor's
own rows of that triangle:

    y_i = f_i − Σ_j l_ij y_j              (forward, unit-lower L)
    x_i = (f_i − Σ_j u_ij x_j) / u_ii     (backward, U)

A sweep's depth is its level count: for a 27-point grid of N³ rows in
lexicographic order 7N − 6, whatever the bandwidth, so the route serves
any factor the banded routes (:mod:`.banded_trisolve`, bandwidth within
one block) do not.  The JAX package has no counterpart: it runs such a
factor on its blocked XLA loop (:mod:`.trisolve`).

A plan takes one of two layouts, by a rule on what it can observe:

- **chunked** (``plan.chunks``), where the triangle's bandwidth w is
  above 0 and w values of the sweep's dtype fit :data:`CHUNK_BYTES` of a
  block's shared memory (:func:`chunks_fit`; HPCG 104³: w = 10,921, 87
  KB in f64), beside a ring of at least two stages.  The rows are cut
  into chunks of w consecutive rows, taken in sweep order (backward for
  U), so a row depends only on rows of its own chunk or of the chunk just
  before it.  Rows sit at positions by (chunk, level); a level of a chunk
  is a group, cut into groups of at most :data:`CHUNK_THREADS` rows.
  Kernel B8 gives each chunk to one block, which keeps the chunk's values
  in shared memory and parts its levels by a block barrier (``bar.sync``)
  instead of the grid barrier.  A value crosses SMs only from a chunk to
  the next, through a hand-over buffer in position order, so the next
  chunk's rows of one level read it in a few whole lines.  A group waits
  only where it needs more of the previous chunk than that chunk's block
  has published (the group's ``need``, in groups of that chunk): each
  block releases its count of solved groups into a progress word (the
  plan's ``flags``, 0 between launches), which the next chunk's block
  acquires.  On the chain a sweep takes about (levels − chunks)·t +
  chunks·L, t a level inside a block and L a hand-over between SMs (HPCG
  104³: 722 levels, 104 chunks a sweep).  A group's
  entries sit slot-major (entry k of its row i at k·R + i), each row's in
  column order, so two bulk copies bring a group into the kernel's ring;
  their columns are coded as positions (:class:`Chunks`);
- **grid** (``plan.level_ptr``), every other triangle: positions by level,
  each row's entries in CSR order, and kernel B8's grid-barrier form walks
  every level across the whole card.  A band nearly as wide as the matrix
  (the shuffled 316² grid: w ≈ n) gives a chunk too wide for shared
  memory, and a handful of chunks would each be a chain on one SM, so
  such a triangle keeps every SM on every level.

The kernel front end :func:`level_sweep` (kernel B8, one launch a sweep)
sits beside its plain PyTorch twin :func:`level_sweep_plain` (a loop over
the levels, each a gather, a row sum and a divide, over either layout);
it sends a CPU tensor to the twin and a CUDA tensor to the hand-written
kernel (:mod:`._kernels`), or raises — it never falls back — and keeps a
plain-int ``launches`` count.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from cuda_mat_tpu_torch.ops import _kernels
from cuda_mat_tpu_torch.utils import timing

CHUNK_THREADS = 128      # a chunked block's compute threads: a group's rows
CHUNK_BYTES = 131072     # the most bytes of a chunk's solved values
MAX_STAGES = 8           # groups the chunked kernel's ring holds


def row_levels(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """int32 level of each of ``n`` rows in one triangle's dependency graph,
    row ``rows[e]`` depending on row ``cols[e]`` for each entry ``e``: 0 for
    a row that depends on none, else one more than the deepest row it
    depends on.  Kahn's wavefront: a round takes the rows whose
    dependencies are all placed, so it costs the entries once and the
    levels' count of rounds of numpy calls."""
    rows = rows.astype(np.int64, copy=False)
    cols = cols.astype(np.int64, copy=False)
    waiting = np.bincount(rows, minlength=n)
    # the dependents of each row: the entries sorted by the row they need
    dependents = rows[np.argsort(cols, kind="stable")]
    first = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(cols, minlength=n), out=first[1:])
    level = np.empty(n, dtype=np.int32)
    front = np.flatnonzero(waiting == 0)
    depth = 0
    while front.size:
        level[front] = depth
        starts, counts = first[front], first[front + 1] - first[front]
        total = int(counts.sum())
        if not total:
            break
        skip = np.cumsum(counts) - counts
        freed, times = np.unique(dependents[
            np.repeat(starts - skip, counts) + np.arange(total)],
            return_counts=True)
        waiting[freed] -= times
        front = freed[waiting[freed] == 0]
        depth += 1
    return level


@dataclasses.dataclass(frozen=True)
class Chunks:
    """The chunked layout's tables (see the module's docstring).  Rows sit
    at positions by (chunk, level), chunks in sweep order; group ``g``
    (``groups[g]`` = entry offset, first position, R | K << 16, need)
    holds the R rows of one level at positions ``pos0 .. pos0 + R`` and
    at most K entries a row, entry k of its row i at entry slot
    ``e_off + k·R + i`` (each group's slots padded to a multiple of 4, 16
    bytes of int32).  An entry's column is coded: c ≥ 0 the position
    ``c`` within the row's own chunk, c ≤ −2 the position −c − 2 of a row
    of the previous chunk, −1 no entry.  Chunk ``c`` is groups ``ptr[c]
    .. ptr[c + 1]``, rows ``[c·width, (c + 1)·width)`` counted in sweep
    order.  ``need``: the groups of the previous chunk below the group's
    level, which hold every row of that chunk the group's rows read."""

    width: int            # rows of a chunk: the triangle's bandwidth
    count: int            # chunks
    groups: torch.Tensor  # int32[G, 4]
    group_level: torch.Tensor   # int32[G], the twin's order
    ptr: torch.Tensor     # int32[count + 1]
    flags: torch.Tensor   # int32[count]: progress words, 0 between launches
    handover: torch.Tensor  # the sweep's dtype [n]: solved values by
                            # position, read by the next chunk's block
    stages: int           # ring stages of the kernel (a power of two)
    slot: int             # bytes of one stage
    most: int             # groups of the largest chunk


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """One triangle of the factor, on one device, in either layout.  Grid:
    position ``p`` holds row ``rows[p]``, whose entries (columns
    ascending) are ``cols``/``vals[ptr[p]:ptr[p + 1]]``; level ``l`` is
    positions ``level_ptr[l]:level_ptr[l + 1]``.  Chunked (``chunks``):
    ``rows`` and ``diag`` by position, ``cols`` (coded) and ``vals`` by
    entry slot, as :class:`Chunks` says; ``level_ptr`` and ``ptr``
    None."""

    level_ptr: Optional[torch.Tensor]  # int32[levels + 1]
    rows: torch.Tensor            # int32[n]
    ptr: Optional[torch.Tensor]   # int32[n + 1]
    cols: torch.Tensor            # int32[entries] or [entry slots]
    vals: torch.Tensor            # the sweep's dtype, as cols
    diag: Optional[torch.Tensor]  # U's diagonal, as rows; None: L
    levels: int
    widest: int                   # rows of the largest level
    blocks: int                   # kernel B8's grid on a card (1 off it)
    n: int
    chunks: Optional[Chunks] = None

    @functools.cached_property
    def twin(self):
        """The plain twin's view: level bounds (a list), and by position
        in level order the rows, entry pointers, columns, values and
        diagonal (None for L); the grid layout's own arrays, or decoded
        once from the chunked one."""
        if self.chunks is None:
            return (self.level_ptr.tolist(), self.rows.long(),
                    self.ptr.long(), self.cols.long(), self.vals, self.diag)
        ch, dev, n = self.chunks, self.rows.device, self.n
        desc = ch.groups.long()
        e_off, pos0, size = desc[:, 0], desc[:, 1], desc[:, 2]
        r, k = size & 0xFFFF, size >> 16
        grp = torch.repeat_interleave(torch.arange(len(r), device=dev), r)
        i = torch.arange(n, device=dev) - pos0[grp]
        # each position's chunk and that chunk's first position
        cptr = ch.ptr.long()
        gchunk = torch.repeat_interleave(torch.arange(ch.count, device=dev),
                                         cptr[1:] - cptr[:-1])
        base = pos0[cptr[:-1]][gchunk[grp]]
        # each position's K slots in column order, the padding dropped
        kk = k[grp]
        at = torch.repeat_interleave(torch.arange(n, device=dev), kk)
        step = torch.arange(len(at), device=dev) - (torch.cumsum(kk, 0)
                                                     - kk)[at]
        idx = e_off[grp][at] + step * r[grp][at] + i[at]
        code = self.cols[idx].long()
        keep = code != -1
        idx, at, code = idx[keep], at[keep], code[keep]
        cols = self.rows.long()[torch.where(code >= 0, base[at] + code,
                                            -code - 2)]
        # positions in level order, each with its entries
        order = torch.argsort(ch.group_level.long()[grp], stable=True)
        count = torch.bincount(at, minlength=n)[order]
        ptr = torch.zeros(n + 1, dtype=torch.long, device=dev)
        ptr[1:] = torch.cumsum(count, 0)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(n, device=dev)
        entry = torch.argsort(rank[at], stable=True)
        bounds = torch.zeros(self.levels + 1, dtype=torch.long)
        bounds[1:] = torch.cumsum(torch.bincount(
            ch.group_level.long().cpu().repeat_interleave(r.cpu()),
            minlength=self.levels), 0)
        return (bounds.tolist(), self.rows[order].long(), ptr,
                cols[entry], self.vals[idx[entry]],
                None if self.diag is None else self.diag[order])


def chunks_fit(width: int, itemsize: int) -> bool:
    """The route rule: a triangle of bandwidth ``width`` takes the chunked
    layout where a chunk's values (``width`` of ``itemsize`` bytes) fit
    :data:`CHUNK_BYTES`; :func:`level_plan` falls back to the grid layout
    where a group's entries leave no room for a ring of two stages
    beside them."""
    return 0 < width and width * itemsize <= CHUNK_BYTES


def chunk_smem(width: int, itemsize: int, stages: int, slot: int,
               most: int) -> int:
    """Dynamic shared memory of a chunked block (as the kernel lays it
    out): the chunk's values, the ring, the chunk's group table, the
    stages' and the table's mbarriers, two progress words."""
    return (-(-width * itemsize // 16) * 16 + stages * slot + 16 * most
            + 8 * (stages + 1) + 8)


def _chunked(n, rows, cols, vals, diag, level, width, itemsize):
    """The chunked layout as numpy arrays (rows and diagonal by position,
    entry slots' coded columns and values, and the :class:`Chunks` tables
    as keyword arguments), or None where it does not fit shared
    memory."""
    r = np.arange(n, dtype=np.int64)
    chunk = (r if diag is None else n - 1 - r) // width
    count = (n - 1) // width + 1
    levels = int(level.max()) + 1
    # positions: rows by (chunk, level), ascending within each
    key = chunk * levels + level
    order = np.argsort(key, kind="stable")
    key = key[order]
    pos = np.empty(n, dtype=np.int64)
    pos[order] = r
    run = np.ones(n, dtype=bool)
    run[1:] = key[1:] != key[:-1]
    run_first = np.flatnonzero(run)
    within = r - run_first[np.cumsum(run) - 1]
    start = within % CHUNK_THREADS == 0
    first = np.flatnonzero(start)
    gid = np.cumsum(start) - 1                    # group of each position
    size = np.diff(np.append(first, n))           # R
    at = r - first[gid]                           # row of its group
    gchunk = chunk[order[first]]
    ptr = np.searchsorted(gchunk, np.arange(count + 1))
    length = np.bincount(rows, minlength=n)
    most_k = np.maximum.reduceat(length[order], first)   # K
    e_size = (most_k * size + 3) & ~3
    slot = int(e_size.max()) * (itemsize + 4)
    most = int(np.diff(ptr).max())
    room = (_kernels.SMEM_LIMIT - chunk_smem(width, itemsize, 0, 0, most)
            ) // (slot + 8)
    if room < 2 or most_k.max() >= 2 ** 15 or e_size.sum() >= 2 ** 31:
        return None
    stages = 1 << (min(MAX_STAGES, room).bit_length() - 1)
    e_off = np.cumsum(e_size) - e_size
    # entry k of a row lands at e_off + k·R + i of its group (int32: the
    # slots are fewer than 2^31)
    k = np.arange(rows.size, dtype=np.int32) - np.repeat(
        (np.cumsum(length) - length).astype(np.int32), length)
    dst = np.repeat((e_off[gid] + at)[pos].astype(np.int32), length) \
        + k * np.repeat(size[gid][pos].astype(np.int32), length)
    # a column in the row's own chunk sits at or past the chunk's first
    # position, one in the chunk before it below
    src = pos.astype(np.int32)[cols]
    base = np.repeat(first[ptr[chunk]].astype(np.int32), length)
    e_cols = np.full(int(e_size.sum()), -1, dtype=np.int32)
    e_cols[dst] = np.where(src >= base, src - base, -src - 2)
    e_vals = np.zeros(e_cols.size, dtype=np.float64)
    e_vals[dst] = vals
    # need: the previous chunk's groups below the group's level
    gkey = key[first]
    need = np.searchsorted(gkey, gkey - levels) - ptr[np.maximum(
        gchunk - 1, 0)]
    need[gchunk == 0] = 0
    groups = np.stack([e_off, first, size | (most_k << 16), need], axis=1)
    return order, None if diag is None else diag[order], e_cols, e_vals, \
        dict(width=width, count=count, groups=groups,
             group_level=level[order[first]], ptr=ptr, stages=stages,
             slot=slot, most=most)


def level_plan(n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               diag: Optional[np.ndarray], dtype: torch.dtype, device,
               route: Optional[str] = None) -> LevelPlan:
    """The plan of one triangle from its entries (``rows``/``cols``/``vals``
    in CSR order: by row, then column) and, for U, its diagonal; arrays
    made on the host and uploaded to ``device`` in ``dtype``.  The layout
    follows the module's rule; ``route`` ``"grid"`` or ``"chunks"`` asks
    for one (``"chunks"`` raises where it does not fit).  Kernel B8's grid
    is a block a chunk, on at most one block an SM; in the grid layout it
    gives each row of the widest level a thread, its warps one to a block
    first."""
    if rows.size >= 2 ** 31:
        raise ValueError(f"{rows.size} entries in a triangle: kernel B8 takes"
                         " 32-bit entry indices")
    level = row_levels(n, rows, cols)
    sizes = np.bincount(level)
    device = torch.device(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    width = int(np.abs(rows - cols).max(initial=0))
    chunked = None
    if route != "grid" and chunks_fit(width, itemsize):
        chunked = _chunked(n, rows, cols, vals, diag, level, width, itemsize)
    if route == "chunks" and chunked is None:
        raise ValueError(f"a chunk of {width} rows does not fit the chunked"
                         " kernel's shared memory")
    sms = _kernels._sm_count(device) if device.type == "cuda" else 0

    def up(a, dt=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=dt)

    widest = int(sizes.max(initial=0))
    if chunked is not None:
        p_rows, p_diag, e_cols, e_vals, t = chunked
        tables = Chunks(t["width"], t["count"], up(t["groups"]),
                        up(t["group_level"]), up(t["ptr"]),
                        torch.zeros(t["count"], dtype=torch.int32,
                                    device=device),
                        torch.empty(n, dtype=dtype, device=device),
                        t["stages"], t["slot"], t["most"])
        return LevelPlan(None, up(p_rows), None, up(e_cols), up(e_vals, dtype),
                         None if p_diag is None else up(p_diag, dtype),
                         int(sizes.size), widest,
                         max(1, min(sms, t["count"])), n, tables)
    order = np.argsort(level, kind="stable")
    level_ptr = np.zeros(sizes.size + 1, dtype=np.int64)
    np.cumsum(sizes, out=level_ptr[1:])
    count = np.bincount(rows, minlength=n)
    start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(count, out=start[1:])
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(count[order], out=ptr[1:])
    # entry e of row r lands at ptr[pos[r]] + (its place within the row)
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    at = ptr[pos[rows]] + np.arange(rows.size) - start[rows]
    lvl_cols = np.empty(rows.size, dtype=np.int32)
    lvl_vals = np.empty(rows.size, dtype=np.float64)
    lvl_cols[at] = cols
    lvl_vals[at] = vals
    blocks = max(1, min(sms, -(-widest // 32)))
    return LevelPlan(up(level_ptr), up(order), up(ptr), up(lvl_cols),
                     up(lvl_vals, dtype),
                     None if diag is None else up(diag[order], dtype),
                     int(sizes.size), widest, blocks, n)


def _check(f: torch.Tensor, plan: LevelPlan) -> None:
    if f.dim() != 1 or f.shape[0] != plan.n:
        raise ValueError(f"want f of shape ({plan.n},), got {tuple(f.shape)}")
    if f.dtype != plan.vals.dtype or f.device != plan.vals.device:
        raise ValueError(f"f ({f.dtype}, {f.device}) must share the plan's"
                         f" dtype and device ({plan.vals.dtype},"
                         f" {plan.vals.device})")


def level_sweep_plain(f: torch.Tensor, plan: LevelPlan) -> torch.Tensor:
    """Plain PyTorch twin of kernel B8: the levels in order, each a gather
    of the solved rows, the products' sum a row (in the row's column
    order) and, backward, a divide by U's diagonal."""
    bounds, rows_, ptr, cols, vals, diag = plan.twin
    y = torch.zeros_like(f)
    length = ptr[1:] - ptr[:-1]
    for s, e, a, b in zip(bounds[:-1], bounds[1:], ptr[bounds[:-1]].tolist(),
                          ptr[bounds[1:]].tolist()):
        seg = torch.repeat_interleave(torch.arange(e - s, device=f.device),
                                      length[s:e])
        sums = torch.zeros(e - s, dtype=f.dtype, device=f.device).index_add_(
            0, seg, vals[a:b] * y[cols[a:b]])
        rows = rows_[s:e]
        v = f[rows] - sums
        y[rows] = v if diag is None else v / diag[s:e]
    return y


def level_sweep(f: torch.Tensor, plan: LevelPlan) -> torch.Tensor:
    """One triangular sweep ``f [n] → y [n]`` over ``plan``'s triangle:
    forward over unit-lower L (``plan.diag`` None) or backward over U.  CPU
    tensors run the plain twin, CUDA tensors kernel B8 (one launch,
    counted)."""
    _check(f, plan)
    if f.device.type == "cpu":
        return level_sweep_plain(f, plan)
    y = _kernels.level_sweep(f, plan)
    level_sweep.launches += 1
    return y


level_sweep.launches = 0


def reset_launch_counts() -> None:
    """Set the kernel's launch count to 0."""
    level_sweep.launches = 0


@dataclasses.dataclass(frozen=True)
class LevelTriSolver:
    """ILU(0) triangular-solve pair over true-n vectors on the plans'
    device, each triangle swept level by level (the ``"levels"`` route of
    :class:`~cuda_mat_tpu_torch.precond.preconditioners.
    ILU0Preconditioner`)."""

    lower: LevelPlan    # L's strict part, unit diagonal
    upper: LevelPlan    # U's strict part and its diagonal
    n: int

    @classmethod
    def from_factor(cls, csr, mvals: np.ndarray, *, dtype=torch.float64,
                    device, route: Optional[str] = None) -> "LevelTriSolver":
        """From a CSR combined ILU(0) factor (strict lower = L with unit
        diagonal, diag + upper = U), its values unchanged, in ``dtype`` on
        ``device``; ``route`` as :func:`level_plan`'s, for both triangles.
        Recorded as the span ``precond.levels``; the record open then
        (``make_solver``'s) counts both sweeps' levels and chunks."""
        with timing.span("precond.levels"):
            n = csr.n
            rows = np.repeat(np.arange(n, dtype=np.int64), csr.row_lengths)
            cols = csr.indices.astype(np.int64)
            m_ = np.asarray(mvals, dtype=np.float64)
            low, high = cols < rows, cols > rows
            diag = np.zeros(n)
            diag[rows[cols == rows]] = m_[cols == rows]
            tri = cls(level_plan(n, rows[low], cols[low], m_[low], None,
                                 dtype, device, route),
                      level_plan(n, rows[high], cols[high], m_[high], diag,
                                 dtype, device, route), n)
            timing.device_sync(device)
        rec = timing.current()
        if rec is not None:
            rec.levels += tri.levels
            rec.chunks += tri.chunks
        return tri

    @property
    def levels(self) -> int:
        """Levels of a forward and a backward sweep together."""
        return self.lower.levels + self.upper.levels

    @property
    def chunks(self) -> int:
        """Chunks of a forward and a backward sweep together (0 for a
        sweep in the grid layout)."""
        return sum(p.chunks.count for p in (self.lower, self.upper)
                   if p.chunks is not None)

    def solve_lower(self, f: torch.Tensor) -> torch.Tensor:
        """L y = f with the unit-diagonal lower factor (forward sweep)."""
        return level_sweep(f.contiguous(), self.lower)

    def solve_upper(self, f: torch.Tensor) -> torch.Tensor:
        """U x = f with the non-unit upper factor (backward sweep)."""
        return level_sweep(f.contiguous(), self.upper)

    def msolve(self, f: torch.Tensor) -> torch.Tensor:
        """``M⁻¹ f = U \\ (L \\ f)``: two launches of kernel B8 on a
        card."""
        return self.solve_upper(self.solve_lower(f))
