"""Matrix Market files, the OMP side module's text formats and dense
vectors (the exports of :mod:`cuda_mat_tpu.io`)."""

from cuda_mat_tpu_torch.io import omp_format
from cuda_mat_tpu_torch.io.mmio import load_mm_sparse_matrix, read_mm, write_mm
from cuda_mat_tpu_torch.io.vectors import to_dense_vector

__all__ = [
    "load_mm_sparse_matrix",
    "read_mm",
    "write_mm",
    "to_dense_vector",
    "omp_format",
]
