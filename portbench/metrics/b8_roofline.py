"""Kernel B8's share of the exact ILU(0) msolve's roofline in the traced
solves (roofline/ilu0_msolve.py), in %: the level-scheduled sweep, over
every launch of a forward and a backward sweep."""

from portbench import peaks, spec

KERNELS = ("level_sweep_kernel",)


def read(rec):
    return peaks.roofline_pct(rec, spec.load_module("roofline",
                                                    "ilu0_msolve"), KERNELS)
