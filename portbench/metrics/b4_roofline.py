"""Kernels B4a/B4b's share of the exact ILU(0) msolve's roofline in the
traced solves (roofline/ilu0_msolve.py), in %: the chunked sweep's two
kernels, over every launch of a forward and a backward sweep."""

from portbench import peaks, spec

KERNELS = ("chunk_walk_kernel", "chunk_carry_kernel")


def read(rec):
    return peaks.roofline_pct(rec, spec.load_module("roofline",
                                                    "ilu0_msolve"), KERNELS)
