"""DIA (diagonal / banded) host layout, row-aligned:
``data[d, i] = A[i, i + offsets[d]]`` (0 where out of range).

Host-only numpy copy of :mod:`cuda_mat_tpu.formats.dia`, trimmed to what the
port's solve path uses (stencil detection, the Neumann factor stencils and
the banded DIA operator read the diagonals from here; ``matvec`` is the
host oracle of the tests).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DIAMatrix:
    n: int
    m: int
    offsets: np.ndarray  # int32[ndiag], sorted ascending
    data: np.ndarray     # [ndiag, n] row-aligned diagonal values
    nnz: int             # true nnz

    @property
    def ndiag(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def bandwidth(self) -> int:
        return int(max(abs(int(self.offsets[0])), abs(int(self.offsets[-1])))) \
            if self.ndiag else 0

    @classmethod
    def from_csr(cls, csr, max_diags: int | None = None) -> "DIAMatrix":
        rows = np.repeat(np.arange(csr.n, dtype=np.int64), csr.row_lengths)
        offs = csr.indices.astype(np.int64) - rows
        uniq = np.unique(offs)
        if max_diags is not None and uniq.shape[0] > max_diags:
            raise ValueError(
                f"matrix has {uniq.shape[0]} distinct diagonals > max_diags={max_diags};"
                " DIA would be wasteful — use ELL/CSR instead")
        data = np.zeros((uniq.shape[0], csr.n), dtype=csr.data.dtype)
        dpos = np.searchsorted(uniq, offs)
        data[dpos, rows] = csr.data
        return cls(csr.n, csr.m, uniq.astype(np.int32), data, csr.nnz)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        y = np.zeros(self.n, dtype=np.result_type(self.data, x))
        for d in range(self.ndiag):
            off = int(self.offsets[d])
            lo = max(0, -off)
            hi = min(self.n, self.m - off)
            if hi > lo:
                y[lo:hi] += self.data[d, lo:hi] * x[lo + off:hi + off]
        return y
