"""Bandwidth-reducing symmetric reordering, reverse Cuthill–McKee (host
numpy copy of :mod:`cuda_mat_tpu.formats.reorder`), and the bandwidth of a
CSR pattern.

The reference has no reordering; its banded fixtures come ordered.  A
matrix whose numbering is arbitrary (a mesh numbered at random) has a band
as wide as the matrix: RCM brings it back to a narrow band, which the
banded ILU(0) engine and the Neumann factors need.  ``rcm_permutation``
returns ``perm`` such that ``A[perm][:, perm]`` has a (heuristically)
minimal bandwidth; solving the permuted system and scattering the solution
back is exact:

    (P A Pᵀ)(P x) = (P b)   ⟹   x = scatter(x_perm, perm)

ILU(0) depends on the ordering, so a reordered solve may take another
iteration count than the unordered one; reordering is opt-in
(``SolverConfig.reorder``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _sym_adjacency(csr) -> Tuple[np.ndarray, np.ndarray]:
    """Undirected adjacency (pattern of A + Aᵀ, no self loops) as
    (indptr, indices), each row's neighbours sorted by degree."""
    rows = np.repeat(np.arange(csr.n, dtype=np.int64), csr.row_lengths)
    cols = csr.indices.astype(np.int64)
    mask = rows != cols
    u = np.concatenate([rows[mask], cols[mask]])
    v = np.concatenate([cols[mask], rows[mask]])
    uniq = np.unique(u * csr.n + v)          # dedup (u, v) pairs
    u = (uniq // csr.n).astype(np.int64)
    v = (uniq % csr.n).astype(np.int64)
    indptr = np.zeros(csr.n + 1, dtype=np.int64)
    np.add.at(indptr, u + 1, 1)
    indptr = np.cumsum(indptr)
    degree = np.diff(indptr)
    # neighbours come grouped by u (uniq is sorted); sort each row's list by
    # degree (the classic Cuthill–McKee tie-break) with a stable argsort
    order = np.lexsort((degree[v], u))
    return indptr, v[order]


def rcm_permutation(csr) -> np.ndarray:
    """Reverse Cuthill–McKee ordering of the symmetrized pattern of ``csr``.

    Returns ``perm`` (int64[n]): new index ``k`` holds old row ``perm[k]``.
    Disconnected components are each seeded at their min-degree node."""
    n = csr.n
    indptr, nbrs = _sym_adjacency(csr)
    degree = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    seeds = np.argsort(degree, kind="stable")
    si = 0
    while pos < n:
        while si < len(seeds) and visited[seeds[si]]:
            si += 1
        start = seeds[si]
        visited[start] = True
        order[pos] = start
        pos += 1
        # breadth-first, one level at a time, each level's expansion
        # vectorized: candidates in (parent position, then degree) order,
        # first occurrence wins — the sequential queue algorithm's order
        level = np.array([start], dtype=np.int64)
        while level.size:
            starts_ = indptr[level]
            counts = indptr[level + 1] - starts_
            total = int(counts.sum())
            if total == 0:
                break
            ends = np.cumsum(counts)
            flat = np.arange(total) + np.repeat(starts_ - (ends - counts),
                                                counts)
            cand = nbrs[flat]
            cand = cand[~visited[cand]]
            if cand.size == 0:
                break
            _, first = np.unique(cand, return_index=True)
            level = cand[np.sort(first)]
            visited[level] = True
            order[pos: pos + level.size] = level
            pos += level.size
    return order[::-1].copy()


def bandwidth(csr) -> int:
    """max |col − row| over the stored entries of ``csr`` (0 when it has
    none)."""
    if csr.nnz == 0:
        return 0
    rows = np.repeat(np.arange(csr.n, dtype=np.int64), csr.row_lengths)
    offs = csr.indices.astype(np.int64) - rows
    return int(max(-offs.min(), offs.max(), 0))


def permute_csr(csr, perm: np.ndarray):
    """Symmetric permutation ``P A Pᵀ``: row/col ``perm[k]`` becomes ``k``."""
    from cuda_mat_tpu_torch.formats.coo import COOMatrix
    from cuda_mat_tpu_torch.formats.csr import CSRMatrix

    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    coo = csr.to_coo()
    return CSRMatrix.from_coo(COOMatrix(csr.n, csr.m,
                                        inv[coo.rows].astype(np.int32),
                                        inv[coo.cols].astype(np.int32),
                                        coo.data.copy()))


def permute_vector(v: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """``(P v)[k] = v[perm[k]]``."""
    return np.asarray(v)[perm]


def unpermute_vector(v: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Inverse of :func:`permute_vector`."""
    out = np.empty_like(np.asarray(v))
    out[perm] = v
    return out
