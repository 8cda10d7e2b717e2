"""Workload generators, named fixtures and the split form (host numpy copy
of :mod:`cuda_mat_tpu.models.problems`): the reference's random sparse
matrix and vector and the CLI's random system, made by the same numpy calls
in the same order as the JAX package's, so one seed gives both packages the
same arrays bit for bit; the Laplacians; the bundled ``.mtx`` fixtures.

``grid_laplacian(100000, 100)`` is the 10M-row flagship;
``banded_laplacian(100)`` reproduces the symmetrized mat10000 fixture and
``laplacian_2d(30)`` the symmetrized mat900 fixture (reference
mat10000.mtx:1-5, mat900.mtx:1-7); ``banded_laplacian_dia(3163)`` is the
bench's 10M-row SpMV matrix; ``hpcg27(104, 104, 104)`` is HPCG's problem at
its reference local grid.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from cuda_mat_tpu_torch.formats.coo import COOMatrix
from cuda_mat_tpu_torch.formats.csr import CSRMatrix
from cuda_mat_tpu_torch.formats.dia import DIAMatrix

# the repository's data/ directory, beside this package
_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "data")


def fixture_path(name: str) -> str:
    """Path of a bundled ``.mtx`` fixture (mat3, vec3, mat3_A0, vec3_d,
    mat900, mat10000)."""
    p = os.path.join(_DATA_DIR,
                     name if name.endswith(".mtx") else name + ".mtx")
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def gen_rand_csr_matrix(n: int, m: int, probability_of_zero: float,
                        vmin: float, vmax: float, eps: float = 1e-2,
                        seed: int = 0) -> CSRMatrix:
    """Random sparse matrix: each entry is zero with probability p, else
    uniform in [vmin, vmax] re-drawn until |v| >= eps (reference
    pbicgstab.h:33-55, vectorized)."""
    rng = np.random.default_rng(seed)
    keep = rng.random((n, m)) > probability_of_zero
    rows, cols = np.nonzero(keep)
    vals = rng.uniform(vmin, vmax, size=rows.shape[0])
    small = np.abs(vals) < eps
    while small.any():
        vals[small] = rng.uniform(vmin, vmax, size=int(small.sum()))
        small = np.abs(vals) < eps
    return CSRMatrix.from_coo(COOMatrix(n, m, rows, cols, vals))


def gen_rand_vector(n: int, probability_of_zero: float, vmin: float,
                    vmax: float, seed: int = 0) -> np.ndarray:
    """Random dense vector, each entry zero with probability p (reference
    pbicgstab.cu:1093-1097)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(vmin, vmax, size=n)
    v[rng.random(n) <= probability_of_zero] = 0.0
    return v


def random_diag_nonzero_system(n: int, prob_of_zero: float = 0.99,
                               seed: int = 0) -> Tuple[CSRMatrix, np.ndarray]:
    """The CLI's default random system: off-diagonal entries nonzero with
    probability 1 − p, in [1, 10]; the diagonal always nonzero in [1, 10]
    (reference example.cpp:274-286); b random in [1, 5] with P(zero) = 0.2
    (reference example.cpp:174,339)."""
    rng = np.random.default_rng(seed)
    keep = rng.random((n, n)) >= prob_of_zero
    np.fill_diagonal(keep, True)
    rows, cols = np.nonzero(keep)
    vals = rng.uniform(1.0, 10.0, size=rows.shape[0])
    a = CSRMatrix.from_coo(COOMatrix(n, n, rows, cols, vals))
    b = gen_rand_vector(n, 0.2, 1.0, 5.0, seed=seed + 1)
    return a, b


def split_form(csr: CSRMatrix):
    """Decompose ``A = A0 + diag(d)``: returns ``(A0, d)`` with A0 = A minus
    its stored diagonal (the identity the reference's paired fixtures
    encode, mat3 = mat3_A0 + diag(vec3_d); reference mat3_A0.mtx:7,
    vec3_d.mtx:7-9), for the split-form entry point
    (pbicgstab.cu:926-1088) on any square matrix."""
    if csr.n != csr.m:
        raise ValueError("split_form requires a square matrix")
    rows = np.repeat(np.arange(csr.n, dtype=np.int64), csr.row_lengths)
    cols = csr.indices.astype(np.int64)
    off = rows != cols
    d = np.zeros(csr.n, dtype=csr.data.dtype)
    d[rows[~off]] = csr.data[~off]
    a0 = CSRMatrix.from_coo(COOMatrix(csr.n, csr.m, rows[off], cols[off],
                                      csr.data[off]))
    return a0, d


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


def banded_laplacian_dia(side: int, dtype=np.float32) -> DIAMatrix:
    """Direct DIA construction of :func:`banded_laplacian` — no COO or CSR
    in between, so the 10M-row system builds in O(n) memory; equal to
    ``banded_laplacian(side).to_dia()`` up to ``dtype``."""
    n = side * side
    offsets = np.array([-side, -1, 0, 1, side], dtype=np.int32)
    data = np.zeros((5, n), dtype=dtype)
    data[2] = 4.0
    # row-aligned: data[d, i] = A[i, i + off]
    data[1, 1:] = -1.0          # off -1: rows 1..n-1 ...
    data[1, ::side] = 0.0       # ... except the first of each grid row
    data[3, : n - 1] = -1.0     # off +1
    data[3, side - 1::side] = 0.0
    data[0, side:] = -1.0       # off -side
    data[4, : n - side] = -1.0  # off +side
    return DIAMatrix(n, n, offsets, data, int(np.count_nonzero(data)))


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


def hpcg27(nx: int, ny: int, nz: int) -> CSRMatrix:
    """HPCG's problem matrix (github.com/hpcg-benchmark/hpcg,
    ``src/GenerateProblem_ref.cpp``): the 27-point stencil on an
    ``nx × ny × nz`` grid in lexicographic order (x fastest), 26 on the
    diagonal and −1 for each neighbour inside the grid, so boundary rows
    have fewer entries.  Built row by row in CSR order (each row's columns
    ascending, as HPCG's triple loop over the (z, y, x) offsets gives them),
    so the 104³ grid takes a few seconds."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    x, y, z = idx % nx, idx // nx % ny, idx // (nx * ny)
    step = np.array([-1, 0, 1], dtype=np.int64)
    dz, dy, dx = (a.ravel() for a in np.meshgrid(step, step, step,
                                                 indexing="ij"))
    keep = ((x[:, None] + dx >= 0) & (x[:, None] + dx < nx)
            & (y[:, None] + dy >= 0) & (y[:, None] + dy < ny)
            & (z[:, None] + dz >= 0) & (z[:, None] + dz < nz))
    col = idx[:, None] + (dz * ny + dy) * nx + dx
    vals = np.where((dx == 0) & (dy == 0) & (dz == 0), 26.0, -1.0)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    return CSRMatrix(n, n,
                     np.broadcast_to(vals, keep.shape)[keep].astype(
                         np.float64),
                     col[keep].astype(np.int32), indptr.astype(np.int32))
