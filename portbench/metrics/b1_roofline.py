"""Kernel B1's share of the stencil SpMV's roofline in the traced solves
(roofline/stencil_spmv.py), in %."""

from portbench import peaks, spec

KERNELS = ("const_stencil_spmv_kernel",)


def read(rec):
    return peaks.roofline_pct(rec, spec.load_module("roofline",
                                                    "stencil_spmv"), KERNELS)
