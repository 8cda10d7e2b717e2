"""Problem generators and named fixtures (the exports of
:mod:`cuda_mat_tpu.models`)."""

from cuda_mat_tpu_torch.models.problems import (banded_laplacian,
                                                fixture_path,
                                                gen_rand_csr_matrix,
                                                gen_rand_vector, laplacian_2d,
                                                random_diag_nonzero_system)

__all__ = [
    "gen_rand_csr_matrix",
    "gen_rand_vector",
    "random_diag_nonzero_system",
    "laplacian_2d",
    "banded_laplacian",
    "fixture_path",
]
