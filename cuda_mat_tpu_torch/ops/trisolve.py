"""Generic blocked sparse triangular solves (counterpart of
:mod:`cuda_mat_tpu.ops.trisolve`): exact ILU(0) for a factor of any
pattern, as the JAX package runs it where its banded engine needs the
bandwidth within one block.  Here the distributed block-Jacobi ILU(0)
(:mod:`cuda_mat_tpu_torch.parallel.dist_precond`) runs on it; one
device's exact ILU(0) takes the banded routes (:mod:`.banded_trisolve`)
or the level-scheduled one (:mod:`.level_trisolve`) instead.

The reference applies ILU(0) with cuSPARSE's level-scheduled triangular
solves (analysis at reference pbicgstab.cu:338-345, solves at :92-98,
:121-127).  Here the recurrence is blocked: rows fall into ``nb`` blocks of
B; within a block the dependency is a dense B×B triangular system whose
inverse ``W_b`` is made once on the host; across blocks each row depends on
earlier (forward) or later (backward) rows only through its off-block
entries, kept as a per-block ELL (``vals``/``cols``, global row indices).
A sweep is a loop of ``nb`` steps:

    y_b = W_b @ (f_b − Σ_k vals[b, :, k] · y[cols[b, :, k]])

The JAX package runs the loop in XLA, so here it is stock torch ops on the
arrays' device: a Python loop over the blocks, each step a gather, the row
sums, one GEMV (full precision: no TF32) written into y — five launches a
step, so on a card the sweep is paced by the host.

The arrays may carry a leading shard axis (the distributed block-Jacobi
ILU(0), :mod:`cuda_mat_tpu_torch.parallel.dist_precond`): then each shard
solves its own factor on its ``(S, n)`` row of the vectors, ``cols`` are
local row indices, and step b of every shard is one batched step (a
gather, the row sums and one batched GEMV), so a sweep takes the same
launches whatever S is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _block_setup_tri(csr, mvals: np.ndarray, block: int, lower: bool):
    """Host-side extraction of one triangle of the combined ILU factor (the
    JAX package's arrays, built without its per-row Python loop).

    ``lower``: the strict lower triangle with an implied unit diagonal
    (reference DIAG_TYPE_UNIT, pbicgstab.cu:93); else the diagonal and the
    strict upper triangle (DIAG_TYPE_NON_UNIT, :97).  Returns ``(W, vals,
    cols)``: the per-block inverse of the diagonal block, and the off-block
    entries of each row in column order as an ELL of width ``max(1, the
    longest row)``."""
    n = csr.n
    nb = -(-n // block)
    rows = np.repeat(np.arange(n, dtype=np.int64), csr.row_lengths)
    cols = csr.indices.astype(np.int64)
    vals = np.asarray(mvals, dtype=np.float64)
    keep = cols < rows if lower else cols >= rows
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    b, ii = np.divmod(rows, block)
    same = cols // block == b

    diag_blocks = np.tile(np.eye(block), (nb, 1, 1))
    diag_blocks[b[same], ii[same], cols[same] % block] = vals[same]

    orow, ocol, oval = rows[~same], cols[~same], vals[~same]
    per_row = np.bincount(orow, minlength=n)
    kmax = max(1, int(per_row.max(initial=0)))
    pos = np.arange(orow.shape[0]) - (np.cumsum(per_row) - per_row)[orow]
    ob, oi = np.divmod(orow, block)
    off_vals = np.zeros((nb, block, kmax), dtype=np.float64)
    off_cols = np.zeros((nb, block, kmax), dtype=np.int32)
    off_vals[ob, oi, pos] = oval
    off_cols[ob, oi, pos] = ocol
    return np.linalg.inv(diag_blocks), off_vals, off_cols


@dataclasses.dataclass(frozen=True)
class BlockTriangularSolver:
    """``x = U \\ (L \\ f)`` for a combined ILU(0) factor of any pattern,
    over true-n vectors on the arrays' device, by the blocked recurrence of
    the module docstring."""

    w_lo: torch.Tensor     # [(S,) nb, B, B] inverse of unit-lower diagonal blocks
    vals_lo: torch.Tensor  # [(S,) nb, B, Klo]
    cols_lo: torch.Tensor  # int32[nb, B, Klo] (global row indices) or
    #                        int64[S, nb, B, Klo] (each shard's own rows)
    w_up: torch.Tensor     # [(S,) nb, B, B] inverse of upper diagonal blocks
    vals_up: torch.Tensor  # [(S,) nb, B, Kup]
    cols_up: torch.Tensor  # as cols_lo
    n: int                 # true dimension
    block: int

    @classmethod
    def from_factor(cls, csr, mvals: np.ndarray, block: int = 256,
                    dtype=torch.float64, *,
                    device="cuda") -> "BlockTriangularSolver":
        """Build from the combined factor values ``mvals`` on ``csr``'s
        pattern: the host arrays in f64, then cast to ``dtype``."""
        def to(a):
            return torch.from_numpy(a).to(device=device, dtype=(
                dtype if a.dtype == np.float64 else torch.int32))

        lo = _block_setup_tri(csr, mvals, block, lower=True)
        up = _block_setup_tri(csr, mvals, block, lower=False)
        return cls(*map(to, lo + up), csr.n, block)

    @property
    def nb(self) -> int:
        return self.w_lo.shape[-3]

    def _sweep(self, f: torch.Tensor, w, vals, cols,
               forward: bool) -> torch.Tensor:
        if w.dim() == 4:
            return self._sweep_shards(f, w, vals, cols, forward)
        nb, block = self.nb, self.block
        fp = torch.zeros(nb * block, dtype=w.dtype, device=w.device)
        fp[: self.n] = f
        y = torch.zeros_like(fp)
        for b in (range(nb) if forward else range(nb - 1, -1, -1)):
            s = b * block
            gathered = y.index_select(0, cols[b].view(-1)).view(
                cols.shape[1:])
            rhs = fp[s:s + block] - (vals[b] * gathered).sum(1)
            torch.mv(w[b], rhs, out=y[s:s + block])
        return y[: self.n]

    def _sweep_shards(self, f: torch.Tensor, w, vals, cols,
                      forward: bool) -> torch.Tensor:
        shards, nb, block, k = w.shape[0], self.nb, self.block, cols.shape[-1]
        fp = f.new_zeros((shards, nb * block))
        fp[:, : self.n] = f
        y = torch.zeros_like(fp)
        for b in (range(nb) if forward else range(nb - 1, -1, -1)):
            s = b * block
            gathered = torch.gather(y, 1, cols[:, b].reshape(shards, -1))
            rhs = fp[:, s:s + block] - (
                vals[:, b] * gathered.view(shards, block, k)).sum(2)
            y[:, s:s + block] = torch.bmm(w[:, b], rhs.unsqueeze(2))[..., 0]
        return y[:, : self.n]

    def solve_lower(self, f: torch.Tensor) -> torch.Tensor:
        """L y = f with the unit-diagonal lower factor (forward sweep)."""
        return self._sweep(f, self.w_lo, self.vals_lo, self.cols_lo, True)

    def solve_upper(self, f: torch.Tensor) -> torch.Tensor:
        """U x = f with the non-unit upper factor (backward sweep)."""
        return self._sweep(f, self.w_up, self.vals_up, self.cols_up, False)

    def msolve(self, f: torch.Tensor) -> torch.Tensor:
        """``M⁻¹ f = U \\ (L \\ f)`` — the two csrsv_solve calls of the
        reference loop (pbicgstab.cu:92-98)."""
        return self.solve_upper(self.solve_lower(f))
