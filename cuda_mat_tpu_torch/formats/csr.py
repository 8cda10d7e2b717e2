"""CSR (compressed sparse row) — the canonical host compute format.

Host-only numpy copy of :mod:`cuda_mat_tpu.formats.csr`, trimmed to what the
port's solve path uses: construction from COO or a dense array with the
reference's pattern checks (reference mmio_wrapper.h:91-130), row lengths,
the host SpMV oracle, the COO/dense/ELL/DIA/BSR conversions and the
transpose BiCG needs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from cuda_mat_tpu_torch.formats.coo import COOMatrix


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

    @classmethod
    def from_dense(cls, a: np.ndarray, eps: float = 0.0) -> "CSRMatrix":
        a = np.asarray(a)
        mask = np.abs(a) > eps
        rows, cols = np.nonzero(mask)
        return cls.from_coo(COOMatrix(a.shape[0], a.shape[1], rows, cols,
                                      a[mask]))

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

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.m), dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.n), self.row_lengths)
        out[rows, self.indices] = self.data
        return out

    def to_coo(self):
        rows = np.repeat(np.arange(self.n, dtype=np.int32), self.row_lengths)
        return COOMatrix(self.n, self.m, rows, self.indices.copy(),
                         self.data.copy())

    def to_ell(self, pad_col: Optional[int] = None):
        from cuda_mat_tpu_torch.formats.ell import ELLMatrix

        return ELLMatrix.from_csr(self, pad_col=pad_col)

    def to_bsr(self, block: int = 2):
        from cuda_mat_tpu_torch.formats.bsr import BSRMatrix

        return BSRMatrix.from_csr(self, block)

    def transpose(self) -> "CSRMatrix":
        """CSR transpose (a stable sort by column, as the JAX package's),
        the numpy equivalent of the OMP reference's ``Transpose2``
        (reference bicstab_omp/bicstab.cpp:35-66, whose int-truncation of
        values is not reproduced)."""
        coo = self.to_coo()
        return CSRMatrix.from_coo(
            COOMatrix(self.m, self.n, coo.cols, coo.rows, coo.data))
