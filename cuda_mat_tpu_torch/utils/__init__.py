"""Timers, norms, checkpointing, dense QR and the kernels' build helper."""

from cuda_mat_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
from cuda_mat_tpu_torch.utils.norms import (csr_mat_norminf, display_matrix,
                                            mat_norminf, vec_norminf)
from cuda_mat_tpu_torch.utils.timing import PhaseTimer, second

__all__ = [
    "PhaseTimer",
    "second",
    "vec_norminf",
    "mat_norminf",
    "csr_mat_norminf",
    "display_matrix",
    "save_checkpoint",
    "load_checkpoint",
]
