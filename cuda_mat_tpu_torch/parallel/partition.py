"""Row partitions of a matrix with halo metadata (counterpart of
:mod:`cuda_mat_tpu.parallel.partition`,
cuda_mat_tpu/parallel/partition.py:27-226), forked as numpy: the same fields, padding rules and errors, and
arrays equal to the JAX package's bit for bit on the same matrix.

Each of the ``ndev`` shards owns ``shard_rows`` contiguous rows.  Banded
matrices need a halo of ``w`` (the bandwidth) x entries from each
neighbouring shard; general ones gather all of x.  The matrix is padded to
``npad`` rows with identity rows and b/x0 with zeros, so the pad entries
stay exactly zero through every iteration and add nothing to a dot
(``pad_vector``'s ``fill`` puts 1 there for an inverse diagonal instead).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from cuda_mat_tpu_torch.formats.csr import CSRMatrix
from cuda_mat_tpu_torch.formats.dia import DIAMatrix


def _as_dia(a, max_diags: int, what: str) -> DIAMatrix:
    dia = a.to_dia(max_diags=max_diags) if isinstance(a, CSRMatrix) else a
    if not isinstance(dia, DIAMatrix):
        # ValueError, so that the solver's fallback to the all-gather
        # partition (which catches ValueError) also takes it
        raise ValueError(f"{what} needs a CSR or DIA matrix, got"
                         f" {type(a).__name__}")
    return dia


@dataclasses.dataclass
class RowPartitionedBanded:
    """Partition plan and padded DIA data for ``ndev`` row shards
    (partition.py:27-86)."""

    n: int                 # true dimension
    npad: int              # padded dimension (ndev * shard_rows)
    ndev: int
    shard_rows: int        # rows per shard
    halo: int              # bandwidth w
    offsets: Tuple[int, ...]
    data: np.ndarray       # [ndiag, npad] row-aligned, padded rows = identity

    @classmethod
    def from_matrix(cls, a, ndev: int, align: int = 1, max_diags: int = 128
                    ) -> "RowPartitionedBanded":
        """``align``: round ``shard_rows`` up to a multiple of it.
        ``max_diags`` bounds the DIA conversion, so that a matrix with no
        narrow band raises ValueError before an ``[ndiag, n]`` array is
        made; so does a band wider than a shard."""
        dia = _as_dia(a, max_diags, "RowPartitionedBanded")
        n = dia.n
        shard_rows = -(-n // ndev)
        shard_rows = -(-shard_rows // align) * align
        npad = shard_rows * ndev
        w = dia.bandwidth
        if w > shard_rows:
            raise ValueError(
                f"bandwidth {w} exceeds shard size {shard_rows}: neighbor-only"
                f" halo exchange impossible with {ndev} shards")
        offsets = tuple(int(o) for o in dia.offsets)
        if 0 not in offsets:
            offsets = tuple(sorted(offsets + (0,)))
        data = np.zeros((len(offsets), npad), dtype=dia.data.dtype)
        have = {int(o): d for d, o in enumerate(dia.offsets)}
        for k, off in enumerate(offsets):
            if off in have:
                data[k, :n] = dia.data[have[off]]
            if off == 0:
                data[k, n:] = 1.0  # identity padding rows
        return cls(n, npad, ndev, shard_rows, w, offsets, data)

    def pad_vector(self, v: np.ndarray, fill: float = 0.0) -> np.ndarray:
        out = np.full(self.npad, fill, dtype=v.dtype)
        out[: self.n] = v
        return out

    def unpad_vector(self, v: np.ndarray) -> np.ndarray:
        return np.asarray(v)[: self.n]

    def local_nnz(self) -> int:
        return int(np.count_nonzero(self.data))


@dataclasses.dataclass
class RowPartitionedStencil:
    """Row partition of a constant-coefficient grid stencil in the
    gap-strided layout of
    :class:`~cuda_mat_tpu_torch.ops.stencil.ConstStencilOperator`
    (partition.py:88-183): shard boundaries fall on whole blocks of the
    strided dimension, the halo is the largest strided offset, and the one
    array is the ``(block,)`` gap mask that every block shares.  The strided
    tail ``[np_true, npad)`` is zero.

    The distributed solver's "stencil" engine runs it: kernel B1 a shard,
    and the fused msolve B2/B5 on the const factors."""

    n: int                  # true dimension R*C
    c_grid: int             # grid row length C
    stride: int             # strided row length S (multiple of 128)
    np_true: int            # R*S — global strided length
    npad: int               # ndev * shard_rows (block-aligned strided length)
    ndev: int
    shard_rows: int         # strided rows per shard (multiple of block)
    halo: int               # max |strided offset| (<= sub)
    block: int
    sub: int
    terms: Tuple[Tuple[int, int, float], ...]   # true-coord (off, dc, scal)
    strided_terms: Tuple[Tuple[int, float], ...]  # (off', scal)
    gapmask: np.ndarray     # (block,) 0/1 — identical for every block/shard

    @classmethod
    def from_matrix(cls, a, ndev: int, block_target: int = 262144,
                    max_diags: int = 128, min_sub: int = 0
                    ) -> "RowPartitionedStencil":
        from cuda_mat_tpu_torch.ops.stencil import (detect_const_stencil,
                                                    stencil_layout)

        dia = _as_dia(a, max_diags, "RowPartitionedStencil")
        det = detect_const_stencil(dia)
        if det is None:
            raise ValueError(
                "matrix is not a constant-coefficient grid stencil; use"
                " RowPartitionedBanded / RowPartitionedELL instead")
        c_grid, terms = det
        # blocks no larger than one shard's rows keep the partition
        # balanced (stencil_layout never goes below its base block)
        block_target = min(block_target, max(1, -(-dia.n // ndev)))
        stride, sub, block, np_true, _, sterms = stencil_layout(
            c_grid, dia.n, terms, block_target, min_sub)
        shard_rows = -(-(-(-np_true // ndev)) // block) * block
        npad = shard_rows * ndev
        if npad >= 2 ** 31:
            raise ValueError(f"padded strided dimension {npad} overflows the"
                             " kernel's int32 row arithmetic")
        w = max(abs(t[0]) for t in sterms)
        if w > shard_rows:
            raise ValueError(
                f"strided halo {w} exceeds shard size {shard_rows}: neighbor"
                f"-only halo exchange impossible with {ndev} shards")
        gap = np.zeros(block, dtype=np.float32)
        gap.reshape(block // stride, stride)[:, :c_grid] = 1.0
        return cls(dia.n, c_grid, stride, np_true, npad, ndev, shard_rows,
                   w, block, sub, terms, sterms, gap)

    def pad_vector(self, v: np.ndarray, fill: float = 0.0) -> np.ndarray:
        return self.strided_scatter(v, fill)

    def unpad_vector(self, v: np.ndarray) -> np.ndarray:
        r = self.n // self.c_grid
        g = np.asarray(v)[: self.np_true].reshape(r, self.stride)
        return g[:, : self.c_grid].reshape(-1)

    def strided_scatter(self, v: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """A true-coordinate vector in the padded strided layout, ``fill``
        in the gap and tail cells (1.0 for an inverse diagonal)."""
        r = self.n // self.c_grid
        g = np.full((r, self.stride), fill, dtype=v.dtype)
        g[:, : self.c_grid] = np.asarray(v).reshape(r, self.c_grid)
        out = np.full(self.npad, fill, dtype=v.dtype)
        out[: self.np_true] = g.reshape(-1)
        return out


@dataclasses.dataclass
class RowPartitionedELL:
    """Row partition of a general sparse matrix in ELL layout
    (partition.py:185-226): the distributed SpMV gathers all of x over the
    mesh.  Padded rows are identity (diag 1)."""

    n: int
    npad: int
    ndev: int
    shard_rows: int
    values: np.ndarray   # [npad, K]
    cols: np.ndarray     # int32[npad, K]
    diag: np.ndarray     # [npad] (1.0 on padded rows)

    @classmethod
    def from_matrix(cls, csr: CSRMatrix, ndev: int) -> "RowPartitionedELL":
        n = csr.n
        shard_rows = -(-n // ndev)
        npad = shard_rows * ndev
        ell = csr.to_ell()
        k = ell.k
        values = np.zeros((npad, k), dtype=ell.values.dtype)
        cols = np.zeros((npad, k), dtype=np.int32)
        values[:n] = ell.values
        cols[:n] = ell.cols
        pad_rows = np.arange(n, npad)
        cols[n:] = pad_rows[:, None]
        values[n:, 0] = 1.0
        diag = np.ones(npad, dtype=values.dtype)
        diag[:n] = csr.diagonal()
        return cls(n, npad, ndev, shard_rows, values, cols, diag)

    def pad_vector(self, v: np.ndarray, fill: float = 0.0) -> np.ndarray:
        out = np.full(self.npad, fill, dtype=v.dtype)
        out[: self.n] = v
        return out

    def unpad_vector(self, v: np.ndarray) -> np.ndarray:
        return np.asarray(v)[: self.n]
