"""Laplacian workload generators (host numpy copy of
:mod:`cuda_mat_tpu.models.problems`, trimmed to the solve path's matrices).

``grid_laplacian(100000, 100)`` is the 10M-row flagship;
``banded_laplacian(100)`` reproduces the symmetrized mat10000 fixture and
``laplacian_2d(30)`` the symmetrized mat900 fixture (reference
mat10000.mtx:1-5, mat900.mtx:1-7).
"""

from __future__ import annotations

import numpy as np

from cuda_mat_tpu_torch.formats.coo import COOMatrix
from cuda_mat_tpu_torch.formats.csr import CSRMatrix


def grid_laplacian(r: int, c: int) -> CSRMatrix:
    """5-point 2-D Laplacian on an ``r × c`` grid: n = r·c, diag 4,
    off-diagonals −1 at offsets ±1 (broken at grid-row boundaries) and ±c."""
    n = r * c
    idx = np.arange(n, dtype=np.int64)
    rows = [idx]
    cols = [idx]
    data = [np.full(n, 4.0)]
    # ±1 neighbors, skipped across grid-row boundaries
    left = idx[idx % c != 0]
    rows += [left, left - 1]
    cols += [left - 1, left]
    data += [np.full(left.shape[0], -1.0)] * 2
    # ±c neighbors
    up = idx[idx >= c]
    rows += [up, up - c]
    cols += [up - c, up]
    data += [np.full(up.shape[0], -1.0)] * 2
    return CSRMatrix.from_coo(COOMatrix(
        n, n, np.concatenate(rows), np.concatenate(cols), np.concatenate(data)))


def banded_laplacian(side: int) -> CSRMatrix:
    """5-point 2-D Laplacian on a ``side × side`` grid."""
    return grid_laplacian(side, side)


def laplacian_2d(side: int) -> CSRMatrix:
    """9-point 2-D Laplacian on a ``side × side`` grid (diag 8, all 8
    neighbors −1)."""
    n = side * side
    i = np.arange(n, dtype=np.int64)
    r, c = np.divmod(i, side)
    rows, cols, data = [i], [i], [np.full(n, 8.0)]
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr == 0 and dc == 0:
                continue
            rr, cc = r + dr, c + dc
            ok = (rr >= 0) & (rr < side) & (cc >= 0) & (cc < side)
            rows.append(i[ok])
            cols.append((rr * side + cc)[ok])
            data.append(np.full(int(ok.sum()), -1.0))
    return CSRMatrix.from_coo(COOMatrix(
        n, n, np.concatenate(rows), np.concatenate(cols), np.concatenate(data)))
