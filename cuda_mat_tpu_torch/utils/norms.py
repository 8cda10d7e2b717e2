"""Infinity norms (numpy copy of :mod:`cuda_mat_tpu.utils.norms`) —
equivalents of the reference's helper_cusolver.h utilities (``vec_norminf``
:33, ``mat_norminf`` :46, ``csr_mat_norminf`` :67)."""

from __future__ import annotations

import numpy as np


def vec_norminf(v) -> float:
    v = np.asarray(v)
    return float(np.max(np.abs(v))) if v.size else 0.0


def mat_norminf(a) -> float:
    """Matrix infinity norm (max absolute row sum) of a dense matrix."""
    a = np.asarray(a)
    return float(np.max(np.sum(np.abs(a), axis=1))) if a.size else 0.0


def csr_mat_norminf(csr) -> float:
    """Matrix infinity norm of a CSR matrix."""
    if csr.nnz == 0:
        return 0.0
    sums = np.zeros(csr.n)
    np.add.at(sums, np.repeat(np.arange(csr.n), csr.row_lengths),
              np.abs(csr.data))
    return float(sums.max())


def display_matrix(csr, stream=None) -> str:
    """Pretty-print a small sparse matrix densely (reference
    helper_cusolver.h:94-116 ``display_matrix``).  Returns the string; also
    writes to ``stream`` when given."""
    d = csr.to_dense() if hasattr(csr, "to_dense") else np.asarray(csr)
    out = "\n".join(" ".join(f"{v:10.4g}" for v in row) for row in d)
    if stream is not None:
        stream.write(out + "\n")
    return out
