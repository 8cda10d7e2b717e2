"""``grid_laplacian``: a frozen copy of the port's generator of that name,
the 5-point Laplacian on a ``rows x cols`` grid (4 on the diagonal, -1 at
offsets +-1 within a grid row and at +-cols), built row by row in CSR order
directly instead of through a sorted COO, so the 10M-row matrix takes about
a second."""

import numpy as np

from portbench.matrices import CSR


def make(rows: int, cols: int) -> CSR:
    n = rows * cols
    idx = np.arange(n, dtype=np.int64)
    offsets = np.array([-cols, -1, 0, 1, cols], dtype=np.int64)
    col = idx[:, None] + offsets
    keep = (col >= 0) & (col < n)
    keep[:, 1] &= idx % cols != 0            # no -1 neighbour across rows
    keep[:, 3] &= idx % cols != cols - 1     # no +1 neighbour across rows
    vals = np.where(offsets == 0, 4.0, -1.0)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    return CSR(n, indptr.astype(np.int32), col[keep].astype(np.int32),
               np.broadcast_to(vals, keep.shape)[keep].astype(np.float64))
