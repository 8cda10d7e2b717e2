"""Readers/writers for the OMP side-module's custom text formats (numpy
copy of :mod:`cuda_mat_tpu.io.omp_format`, the same bytes).

The reference's CPU BiCG binary consumes two ad-hoc whitespace text formats
(reference bicstab_omp/bicstab.cpp:198-227, produced by
bicstab_omp/generator.cpp:16-56):

Matrix file:  ``NZ N`` then ``NZ`` pairs ``value col`` then ``N+1`` row-pointer
entries (base 0).  Vector file: ``N`` then ``N`` values.
"""

from __future__ import annotations

import numpy as np

from cuda_mat_tpu_torch.formats.csr import CSRMatrix


def read_matrix(path) -> CSRMatrix:
    """Parse the generator's matrix format (reference bicstab.cpp:198-214)."""
    with open(path) as f:
        tok = f.read().split()
    nz = int(tok[0])
    n = int(tok[1])
    pairs = tok[2:2 + 2 * nz]
    data = np.array(pairs[0::2], dtype=np.float64)
    cols = np.array(pairs[1::2], dtype=np.int32)
    indptr = np.array(tok[2 + 2 * nz:2 + 2 * nz + n + 1], dtype=np.int32)
    mat = CSRMatrix(n, n, data, cols, indptr)
    mat.verify()
    return mat


def matrix_text(csr: CSRMatrix) -> str:
    """The generator's matrix format as text (reference
    generator.cpp:37-46)."""
    return (f"{csr.nnz} {csr.n}\n"
            + " ".join(f"{v:.17g} {int(c)}"
                       for v, c in zip(csr.data, csr.indices))
            + "\n" + " ".join(str(int(p)) for p in csr.indptr) + "\n")


def write_matrix(path, csr: CSRMatrix) -> None:
    """Emit the generator's matrix format (reference generator.cpp:37-46)."""
    with open(path, "w") as f:
        f.write(matrix_text(csr))


def read_vector(path) -> np.ndarray:
    """Parse the generator's vector format (reference bicstab.cpp:216-227)."""
    with open(path) as f:
        tok = f.read().split()
    n = int(tok[0])
    return np.array(tok[1:1 + n], dtype=np.float64)


def vector_text(v: np.ndarray) -> str:
    """The generator's vector format as text."""
    return f"{len(v)} " + " ".join(f"{float(x):.17g}" for x in v) + "\n"


def write_vector(path, v: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(vector_text(v))
