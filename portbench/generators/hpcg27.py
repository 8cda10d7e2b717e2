"""``hpcg27``: HPCG's problem matrix (github.com/hpcg-benchmark/hpcg,
``src/GenerateProblem_ref.cpp``), the 27-point stencil on an
``nx x ny x nz`` grid in lexicographic order (x fastest): 26 on the
diagonal and -1 for each neighbour inside the grid, so boundary rows have
fewer entries.  The reference's triple loop over (z, y, x) offsets gives
each row's columns in ascending order; here all rows at once in numpy, in
CSR order, so the 104^3 grid takes a few seconds."""

import numpy as np

from portbench.matrices import CSR


def make(nx: int, ny: int, nz: int) -> CSR:
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
    return CSR(n, indptr.astype(np.int32), col[keep].astype(np.int32),
               np.broadcast_to(vals, keep.shape)[keep].astype(np.float64))
