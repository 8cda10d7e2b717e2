"""Kernel B2's share of the Neumann-series msolve's roofline in the traced
solves (roofline/neumann_msolve.py), in %."""

from portbench import peaks, spec

KERNELS = ("const_series_msolve_kernel",)


def read(rec):
    return peaks.roofline_pct(rec, spec.load_module("roofline",
                                                    "neumann_msolve"),
                              KERNELS)
