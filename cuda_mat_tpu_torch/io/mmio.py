"""Matrix Market (.mtx) reader, writer and the MM → CSR ingestion path
(numpy copy of :mod:`cuda_mat_tpu.io.mmio`: the same semantics and error
strings, and the writers' bytes).

The reference's NIST ``mmio.c`` low-level reader (banner parse at reference
mmio.c:102, size at :195, COO data at :271) plus the ``loadMMSparseMatrix``
pipeline of reference mmio_wrapper.h:133-348: read COO → reject unsupported
types → symmetrize → row-major sort → CSR compression → pattern
verification.  The native parser (:mod:`cuda_mat_tpu_torch.native.loader`)
is used when it builds; this module is the fallback and the semantics
oracle.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np

from cuda_mat_tpu_torch.formats.coo import COOMatrix
from cuda_mat_tpu_torch.formats.csr import CSRMatrix
from cuda_mat_tpu_torch.native import loader as _native


@dataclasses.dataclass(frozen=True)
class MMBanner:
    """Parsed ``%%MatrixMarket`` banner (reference mmio.h:34-52 typecode)."""

    object: str      # "matrix"
    format: str      # "coordinate" | "array"
    field: str       # "real" | "integer" | "complex" | "pattern"
    symmetry: str    # "general" | "symmetric" | "skew-symmetric" | "hermitian"


def _parse_banner(line: str) -> MMBanner:
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket":
        raise ValueError(f"not a Matrix Market file (bad banner: {line!r})")
    obj, fmt, field, sym = (p.lower() for p in parts[1:])
    if obj != "matrix":
        raise ValueError(f"unsupported MM object {obj!r}")
    if fmt not in ("coordinate", "array"):
        raise ValueError(f"unsupported MM format {fmt!r}")
    if field not in ("real", "integer", "complex", "pattern"):
        raise ValueError(f"unsupported MM field {field!r}")
    if sym not in ("general", "symmetric", "skew-symmetric", "hermitian"):
        raise ValueError(f"unsupported MM symmetry {sym!r}")
    return MMBanner(obj, fmt, field, sym)


def read_mm(path_or_file) -> Tuple[MMBanner, COOMatrix]:
    """Read a Matrix Market coordinate file into a base-0 COO matrix, with
    no symmetrization (the banner is returned so that the caller decides,
    as reference mmio_wrapper.h:172-230 does)."""
    if hasattr(path_or_file, "read"):
        f = path_or_file
        close = False
    else:
        f = open(path_or_file, "r")
        close = True
    try:
        banner = _parse_banner(f.readline())
        if banner.format != "coordinate":
            # reference rejects array (dense) files (mmio_wrapper.h:166-169)
            raise ValueError("dense ('array') Matrix Market files are not supported")
        if banner.field in ("pattern", "complex"):
            # reference rejects pattern/complex for the 'd' loader
            # (mmio_wrapper.h:166-169)
            raise ValueError(f"MM field {banner.field!r} is not supported")
        # skip comments/blank lines, then the size line
        line = f.readline()
        while line and (line.startswith("%") or not line.strip()):
            line = f.readline()
        n, m, nnz = (int(t) for t in line.split())
        vals = np.array(f.read().split(), dtype=np.float64)
        if vals.shape[0] != 3 * nnz:
            raise ValueError(
                f"expected {3 * nnz} tokens in MM body, got {vals.shape[0]}")
        vals = vals.reshape(nnz, 3)
        rows = vals[:, 0].astype(np.int64) - 1  # MM files are 1-based
        cols = vals[:, 1].astype(np.int64) - 1
        if rows.min(initial=0) < 0 or cols.min(initial=0) < 0:
            raise ValueError("index underflow: MM indices must be >= 1")
        return banner, COOMatrix(n, m, rows, cols, vals[:, 2])
    finally:
        if close:
            f.close()


def load_mm_sparse_matrix(path, symmetrize: bool = True,
                          prefer_native: bool = True) -> CSRMatrix:
    """``.mtx`` file → verified base-0 CSR (reference ``loadMMSparseMatrix``,
    mmio_wrapper.h:133-348): symmetric/hermitian/skew files are expanded by
    mirroring off-diagonal entries (skew mirrors negated), entries are
    sorted row-major, and the CSR pattern is verified.  mat900.mtx's stored
    nnz 4322 becomes 7744 (reference mat900.mtx:7)."""
    if prefer_native and _native.available():
        return _native.load_mm_sparse_matrix(str(path), symmetrize=symmetrize)
    banner, coo = read_mm(path)
    if symmetrize and banner.symmetry in ("symmetric", "hermitian",
                                          "skew-symmetric"):
        coo = coo.symmetrized(
            "skew-symmetric" if banner.symmetry == "skew-symmetric"
            else "symmetric")
    return CSRMatrix.from_coo(coo)


_WRITE_LINES = 1 << 16      # entries formatted by one string operation


def write_mm(path_or_file, matrix, symmetry: str = "general",
             comment: str = "") -> None:
    """Write a CSR/COO matrix as a 1-based Matrix Market coordinate file
    (reference writers: mmio.c:392-405), one ``row col value`` line an
    entry with the value as ``%.16e``.  The lines are formatted a chunk at
    a time (one ``%`` over a repeated line template); the bytes are those
    of formatting each line alone."""
    coo = matrix.to_coo() if isinstance(matrix, CSRMatrix) else matrix
    if hasattr(path_or_file, "write"):
        f = path_or_file
        close = False
    else:
        f = open(path_or_file, "w")
        close = True
    try:
        f.write(f"%%MatrixMarket matrix coordinate real {symmetry}\n")
        for line in comment.splitlines():
            f.write(f"% {line}\n")
        f.write(f"{coo.n} {coo.m} {coo.nnz}\n")
        rows = (np.asarray(coo.rows, np.int64) + 1).tolist()
        cols = (np.asarray(coo.cols, np.int64) + 1).tolist()
        vals = np.asarray(coo.data, np.float64).tolist()
        for i in range(0, coo.nnz, _WRITE_LINES):
            j = min(i + _WRITE_LINES, coo.nnz)
            f.write(("%d %d %.16e\n" * (j - i)) % tuple(
                itertools.chain.from_iterable(
                    zip(rows[i:j], cols[i:j], vals[i:j]))))
    finally:
        if close:
            f.close()


def write_mm_dense_vector(path_or_file, v: np.ndarray) -> None:
    """Write a dense vector as an n×1 sparse MM file (vec3.mtx style)."""
    v = np.asarray(v)
    idx = np.arange(v.shape[0])
    coo = COOMatrix(v.shape[0], 1, idx, np.zeros_like(idx), v)
    write_mm(path_or_file, coo)
