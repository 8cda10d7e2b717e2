"""BSR (block compressed sparse row) layout (host numpy copy of
:mod:`cuda_mat_tpu.formats.bsr`): CSR over dense ``bs × bs`` blocks, the
source of the blocked-ELL operator's blocks.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BSRMatrix:
    n: int              # rows (original, possibly not a multiple of bs)
    m: int              # cols
    bs: int             # block size
    blocks: np.ndarray  # [nblocks, bs, bs]
    indices: np.ndarray  # int32[nblocks] block-column indices
    indptr: np.ndarray  # int32[nbrows+1]
    nnz: int            # true scalar nnz

    @property
    def nbrows(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @classmethod
    def from_csr(cls, csr, bs: int = 2) -> "BSRMatrix":
        nbr = -(-csr.n // bs)
        nbc = -(-csr.m // bs)
        coo = csr.to_coo()
        key = (coo.rows // bs).astype(np.int64) * nbc + coo.cols // bs
        uniq, inv = np.unique(key, return_inverse=True)
        blocks = np.zeros((uniq.shape[0], bs, bs), dtype=csr.data.dtype)
        np.add.at(blocks, (inv, coo.rows % bs, coo.cols % bs), coo.data)
        ubrows = (uniq // nbc).astype(np.int32)
        ubcols = (uniq % nbc).astype(np.int32)
        indptr = np.zeros(nbr + 1, dtype=np.int64)
        np.add.at(indptr, ubrows + 1, 1)
        indptr = np.cumsum(indptr).astype(np.int32)
        return cls(csr.n, csr.m, bs, blocks, ubcols, indptr, csr.nnz)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        bs = self.bs
        nbc = -(-self.m // bs)
        xp = np.zeros(nbc * bs, dtype=x.dtype)
        xp[: self.m] = x
        xb = xp.reshape(nbc, bs)
        y = np.zeros((self.nbrows, bs), dtype=np.result_type(self.blocks, x))
        for i in range(self.nbrows):
            lo, hi = self.indptr[i], self.indptr[i + 1]
            if hi > lo:
                y[i] = np.einsum("kab,kb->a", self.blocks[lo:hi],
                                 xb[self.indices[lo:hi]])
        return y.reshape(-1)[: self.n]

    def to_dense(self) -> np.ndarray:
        bs = self.bs
        nbc = -(-self.m // bs)
        out = np.zeros((self.nbrows * bs, nbc * bs), dtype=self.blocks.dtype)
        for i in range(self.nbrows):
            for k in range(self.indptr[i], self.indptr[i + 1]):
                j = self.indices[k]
                out[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = self.blocks[k]
        return out[: self.n, : self.m]
