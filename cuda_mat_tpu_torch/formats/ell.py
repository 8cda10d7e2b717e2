"""ELL (ELLPACK) row-padded sparse layout (host numpy copy of
:mod:`cuda_mat_tpu.formats.ell`).

Every row is padded to the maximum row length K, giving rectangular
``values[n, K]`` / ``cols[n, K]`` arrays: one gather and one row reduction
per SpMV instead of the irregular CSR inner loop of cuSPARSE's ``csrmv``
(reference pbicgstab.cu:104).  Padding entries carry value 0 and point at
column ``pad_col`` (default: the row's own index clamped to range, so
gathers stay in bounds).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ELLMatrix:
    n: int
    m: int
    values: np.ndarray  # [n, K]
    cols: np.ndarray    # int32[n, K]
    nnz: int            # true nnz (excluding padding)

    @property
    def k(self) -> int:
        return int(self.values.shape[1])

    @classmethod
    def from_csr(cls, csr, pad_col: Optional[int] = None) -> "ELLMatrix":
        n, m = csr.n, csr.m
        row_len = csr.row_lengths
        k = max(int(row_len.max()) if n else 0, 1)
        values = np.zeros((n, k), dtype=csr.data.dtype)
        if pad_col is None:
            cols = np.minimum(np.arange(n, dtype=np.int32), m - 1)[:, None]
            cols = np.broadcast_to(cols, (n, k)).copy()
        else:
            cols = np.full((n, k), pad_col, dtype=np.int32)
        # scatter the CSR entries into the padded layout: entry j of a row
        # goes to slot j
        rows = np.repeat(np.arange(n), row_len)
        pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], row_len)
        values[rows, pos] = csr.data
        cols[rows, pos] = csr.indices
        return cls(n, m, values, cols, csr.nnz)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        return np.einsum("nk,nk->n", self.values, x[self.cols])

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.m), dtype=self.values.dtype)
        np.add.at(out, (np.repeat(np.arange(self.n), self.k).reshape(
            self.n, self.k), self.cols), self.values)
        return out
