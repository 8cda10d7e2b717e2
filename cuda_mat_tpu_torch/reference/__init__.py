"""The numpy oracles, in the reference's update order (the exports of
:mod:`cuda_mat_tpu.reference`)."""

from cuda_mat_tpu_torch.reference.cpu_solvers import (bicg_cpu,
                                                      bicgstab_hform_cpu,
                                                      bicgstab_ilu_cpu,
                                                      bicgstab_split_cpu,
                                                      ilu0_factorize,
                                                      solve_lower_unit,
                                                      solve_upper)

__all__ = [
    "bicg_cpu",
    "bicgstab_hform_cpu",
    "bicgstab_split_cpu",
    "bicgstab_ilu_cpu",
    "ilu0_factorize",
    "solve_lower_unit",
    "solve_upper",
]
