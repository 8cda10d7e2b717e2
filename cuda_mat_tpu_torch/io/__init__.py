"""Part of cuda_mat_tpu_torch (see the package docstring)."""
