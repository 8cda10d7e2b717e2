"""Host sparse-matrix containers (numpy) and their conversions: COO, CSR,
ELL, DIA, BSR (the exports of :mod:`cuda_mat_tpu.formats`)."""

from cuda_mat_tpu_torch.formats.bsr import BSRMatrix
from cuda_mat_tpu_torch.formats.coo import COOMatrix
from cuda_mat_tpu_torch.formats.csr import CSRMatrix, verify_pattern
from cuda_mat_tpu_torch.formats.dia import DIAMatrix
from cuda_mat_tpu_torch.formats.ell import ELLMatrix

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "ELLMatrix",
    "DIAMatrix",
    "BSRMatrix",
    "verify_pattern",
]
