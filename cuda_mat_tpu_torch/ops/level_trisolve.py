"""Exact ILU(0) triangular solves by level scheduling, for a factor of any
pattern (kernel B8).

The reference applies ILU(0) with cuSPARSE's level-scheduled triangular
solves (analysis at reference pbicgstab.cu:338-345, solves at :92-98):
each triangle's rows are grouped into levels, a row's level one more than
the deepest row it depends on, so the rows of one level depend only on
rows of earlier levels and are solved at once.  Here the analysis runs
once per factor on the host (:func:`row_levels`, :func:`level_plan`,
timed as set-up), and a sweep walks the levels in order over the factor's
own CSR rows of that triangle, held in level order:

    y_i = f_i − Σ_j l_ij y_j              (forward, unit-lower L)
    x_i = (f_i − Σ_j u_ij x_j) / u_ii     (backward, U)

A sweep's depth is its level count: for a 27-point grid of N³ rows in
lexicographic order 7N − 6, whatever the bandwidth, so the route serves
any factor the banded routes (:mod:`.banded_trisolve`, bandwidth within
one block) do not.  The JAX package has no counterpart: it runs such a
factor on its blocked XLA loop (:mod:`.trisolve`).

The kernel front end :func:`level_sweep` (kernel B8, one launch a sweep)
sits beside its plain PyTorch twin :func:`level_sweep_plain` (a loop over
the levels, each a gather, a row sum and a divide); it sends a CPU tensor
to the twin and a CUDA tensor to the hand-written kernel (:mod:`._kernels`),
or raises — it never falls back — and keeps a plain-int ``launches``
count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cuda_mat_tpu_torch.ops import _kernels
from cuda_mat_tpu_torch.utils import timing


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
class LevelPlan:
    """One triangle of the factor in level order, on one device: position
    ``p`` holds row ``rows[p]``, whose entries of the triangle (columns in
    ascending order) are ``cols``/``vals[ptr[p]:ptr[p + 1]]``; level ``l``
    is positions ``level_ptr[l]:level_ptr[l + 1]``."""

    level_ptr: torch.Tensor       # int32[levels + 1]
    rows: torch.Tensor            # int32[n]
    ptr: torch.Tensor             # int32[n + 1]
    cols: torch.Tensor            # int32[entries]
    vals: torch.Tensor            # [entries], the sweep's dtype
    diag: Optional[torch.Tensor]  # [n] U's diagonal in level order; None: L
    levels: int
    widest: int                   # rows of the largest level
    blocks: int                   # kernel B8's grid on a card (1 off it)


def level_plan(n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               diag: Optional[np.ndarray], dtype: torch.dtype,
               device) -> LevelPlan:
    """The plan of one triangle from its entries (``rows``/``cols``/``vals``
    in CSR order: by row, then column) and, for U, its diagonal; arrays
    made on the host and uploaded to ``device`` in ``dtype``.  Kernel B8's
    grid gives each row of the widest level a thread, its warps one to a
    block first, on at most one block an SM."""
    if rows.size >= 2 ** 31:
        raise ValueError(f"{rows.size} entries in a triangle: kernel B8 takes"
                         " 32-bit entry indices")
    level = row_levels(n, rows, cols)
    order = np.argsort(level, kind="stable")
    sizes = np.bincount(level)
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
    device = torch.device(device)
    widest = int(sizes.max(initial=0))
    blocks = 1
    if device.type == "cuda":
        blocks = max(1, min(_kernels._sm_count(device), -(-widest // 32)))

    def up(a, dt=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=dt)

    return LevelPlan(up(level_ptr), up(order), up(ptr), up(lvl_cols),
                     up(lvl_vals, dtype),
                     None if diag is None else up(diag[order], dtype),
                     int(sizes.size), widest, blocks)


def _check(f: torch.Tensor, plan: LevelPlan) -> None:
    n = plan.rows.shape[0]
    if f.dim() != 1 or f.shape[0] != n:
        raise ValueError(f"want f of shape ({n},), got {tuple(f.shape)}")
    if f.dtype != plan.vals.dtype or f.device != plan.vals.device:
        raise ValueError(f"f ({f.dtype}, {f.device}) must share the plan's"
                         f" dtype and device ({plan.vals.dtype},"
                         f" {plan.vals.device})")


def level_sweep_plain(f: torch.Tensor, plan: LevelPlan) -> torch.Tensor:
    """Plain PyTorch twin of kernel B8: the levels in order, each a gather
    of the solved rows, the products' sum a row (in the row's column
    order) and, backward, a divide by U's diagonal."""
    y = torch.zeros_like(f)
    bounds = plan.level_ptr.long()
    ptr = plan.ptr.long()
    length = ptr[1:] - ptr[:-1]
    for s, e, a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist(),
                          ptr[bounds[:-1]].tolist(), ptr[bounds[1:]].tolist()):
        seg = torch.repeat_interleave(torch.arange(e - s, device=f.device),
                                      length[s:e])
        sums = torch.zeros(e - s, dtype=f.dtype, device=f.device).index_add_(
            0, seg, plan.vals[a:b] * y[plan.cols[a:b].long()])
        rows = plan.rows[s:e].long()
        v = f[rows] - sums
        y[rows] = v if plan.diag is None else v / plan.diag[s:e]
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
                    device) -> "LevelTriSolver":
        """From a CSR combined ILU(0) factor (strict lower = L with unit
        diagonal, diag + upper = U), its values unchanged, in ``dtype`` on
        ``device``.  Recorded as the span ``precond.levels``; the record
        open then (``make_solver``'s) counts both sweeps' levels."""
        with timing.span("precond.levels"):
            n = csr.n
            rows = np.repeat(np.arange(n, dtype=np.int64), csr.row_lengths)
            cols = csr.indices.astype(np.int64)
            m_ = np.asarray(mvals, dtype=np.float64)
            low, high = cols < rows, cols > rows
            diag = np.zeros(n)
            diag[rows[cols == rows]] = m_[cols == rows]
            tri = cls(level_plan(n, rows[low], cols[low], m_[low], None,
                                 dtype, device),
                      level_plan(n, rows[high], cols[high], m_[high], diag,
                                 dtype, device), n)
            timing.device_sync(device)
        rec = timing.current()
        if rec is not None:
            rec.levels += tri.levels
        return tri

    @property
    def levels(self) -> int:
        """Levels of a forward and a backward sweep together."""
        return self.lower.levels + self.upper.levels

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
