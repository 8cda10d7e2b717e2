"""CSR (compressed sparse row) — the canonical host compute format.

Host-only numpy copy of :mod:`cuda_mat_tpu.formats.csr`, trimmed to what the
port's solve path uses: construction from COO with the reference's pattern
checks (reference mmio_wrapper.h:91-130), row lengths, the host SpMV oracle
and the DIA conversion.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def verify_pattern(n: int, nnz: int, indptr: np.ndarray, indices: np.ndarray,
                   m: Optional[int] = None) -> None:
    """Validate base-0 CSR invariants; raise ValueError on violation: nnz
    consistency, monotone row pointer, column indices in range and strictly
    increasing within each row (which also forbids duplicates)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    if m is None:
        m = n
    if indptr.shape[0] != n + 1:
        raise ValueError(f"indptr must have length n+1={n + 1}, got {indptr.shape[0]}")
    if indptr[0] != 0:
        raise ValueError(f"base-0 CSR requires indptr[0]==0, got {indptr[0]}")
    if indptr[-1] != nnz:
        raise ValueError(f"indptr[-1]={indptr[-1]} != nnz={nnz}")
    if np.any(np.diff(indptr) < 0):
        raise ValueError("indptr must be non-decreasing")
    if nnz and (indices.min() < 0 or indices.max() >= max(1, m)):
        raise ValueError(
            f"column index out of range [0, {m}): min={indices.min()},"
            f" max={indices.max()}")
    row_len = np.diff(indptr)
    if nnz:
        d = np.diff(indices)
        # the first element of each row is exempt from the ordering check
        starts = np.zeros(nnz, dtype=bool)
        starts[indptr[:-1][row_len > 0]] = True
        bad = (d <= 0) & ~starts[1:]
        if np.any(bad):
            k = int(np.argmax(bad))
            raise ValueError(
                f"columns not strictly increasing within a row at nnz index {k + 1}")


@dataclasses.dataclass
class CSRMatrix:
    """Base-0 CSR matrix over numpy arrays (``data`` float64 by default,
    ``indices``/``indptr`` int32, the reference's index type)."""

    n: int
    m: int
    data: np.ndarray     # [nnz]
    indices: np.ndarray  # int32[nnz] column indices
    indptr: np.ndarray   # int32[n+1]

    def __post_init__(self):
        self.data = np.asarray(self.data)
        self.indices = np.asarray(self.indices, dtype=np.int32)
        self.indptr = np.asarray(self.indptr, dtype=np.int32)

    @classmethod
    def from_coo(cls, coo) -> "CSRMatrix":
        coo = coo.sorted_row_major()
        indptr = np.zeros(coo.n + 1, dtype=np.int64)
        np.add.at(indptr, coo.rows + 1, 1)
        indptr = np.cumsum(indptr)
        out = cls(coo.n, coo.m, coo.data, coo.cols, indptr.astype(np.int32))
        out.verify()
        return out

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def verify(self) -> None:
        verify_pattern(self.n, self.nnz, self.indptr, self.indices, m=self.m)

    def diagonal(self) -> np.ndarray:
        """Dense main diagonal (zeros where not stored)."""
        d = np.zeros(min(self.n, self.m), dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.n), self.row_lengths)
        on = self.indices == rows
        d[rows[on]] = self.data[on]
        return d

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host (numpy) SpMV — the oracle for device kernels."""
        y = np.zeros(self.n, dtype=np.result_type(self.data, x))
        np.add.at(y, np.repeat(np.arange(self.n), self.row_lengths),
                  self.data * x[self.indices])
        return y

    def to_dia(self, max_diags: Optional[int] = None):
        from cuda_mat_tpu_torch.formats.dia import DIAMatrix

        return DIAMatrix.from_csr(self, max_diags=max_diags)
