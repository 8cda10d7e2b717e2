"""COO (coordinate) sparse matrix — host container, base-0 indices.

Host-only numpy copy of :mod:`cuda_mat_tpu.formats.coo`, trimmed to what the
port's solve path uses (the JAX package cannot be imported without JAX).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class COOMatrix:
    """Coordinate-format sparse matrix with base-0 indices (reference
    mmio.c:271-337 triplets, sorted row-major as in mmio_wrapper.h:251-258)."""

    n: int  # rows
    m: int  # cols
    rows: np.ndarray  # int32[nnz]
    cols: np.ndarray  # int32[nnz]
    data: np.ndarray  # float64[nnz]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def __post_init__(self):
        self.rows = np.asarray(self.rows, dtype=np.int32)
        self.cols = np.asarray(self.cols, dtype=np.int32)
        self.data = np.asarray(self.data)
        if not (self.rows.shape == self.cols.shape == self.data.shape):
            raise ValueError("COO triplet arrays must have equal length")

    def sorted_row_major(self) -> "COOMatrix":
        """Stable sort entries by (row, col) — the CSR pre-pass."""
        order = np.lexsort((self.cols, self.rows))
        return COOMatrix(self.n, self.m, self.rows[order], self.cols[order],
                         self.data[order])

    def symmetrized(self, kind: str = "symmetric") -> "COOMatrix":
        """Mirror off-diagonal entries for MM symmetric/hermitian/skew files
        (reference mmio_wrapper.h:172-230): every stored strictly
        off-diagonal entry (i, j) gains a mirror (j, i); skew-symmetric
        mirrors are negated (reference mmio_wrapper.h:205-206)."""
        off = self.rows != self.cols
        mdata = self.data[off]
        if kind == "skew-symmetric":
            mdata = -mdata
        return COOMatrix(self.n, self.m,
                         np.concatenate([self.rows, self.cols[off]]),
                         np.concatenate([self.cols, self.rows[off]]),
                         np.concatenate([self.data, mdata]))
