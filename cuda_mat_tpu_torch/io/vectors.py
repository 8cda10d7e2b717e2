"""Dense-vector helpers mirroring the reference's (numpy copy of
:mod:`cuda_mat_tpu.io.vectors`)."""

from __future__ import annotations

import numpy as np


def to_dense_vector(vec_csr) -> np.ndarray:
    """Sparse n×1 matrix (as loaded from vec3.mtx-style files) → dense
    vector, as the reference's ``toDenseVector`` (pbicgstab.cu:1101-1115):
    walk the row pointer; rows with at least one stored entry take the next
    stored value, empty rows get 0."""
    n = vec_csr.n
    out = np.zeros(n, dtype=vec_csr.data.dtype)
    count = 0
    indptr = vec_csr.indptr
    for i in range(n):
        if indptr[i + 1] - indptr[i] > 0:
            out[i] = vec_csr.data[count]
            count += 1
    return out


def dump_vector(v: np.ndarray) -> str:
    """Format a vector as ``(v0 v1 ... )`` — the reference's debug dump
    (reference pbicgstab.h:81-88)."""
    return "(" + "".join(f"{float(x):.6f} " for x in np.asarray(v)) + ")"
