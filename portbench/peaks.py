"""The published peaks of the card (``peaks.json``) and the least time an
operation's bytes and operations need at them."""

from __future__ import annotations

import json
import os

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def least_seconds(nbytes: int, nflops: int, dtype: str) -> float:
    """The larger of the bytes over the HBM peak and the operations over
    the dtype's peak outside the tensor cores."""
    with open(PATH) as f:
        peaks = json.load(f)
    return max(nbytes / peaks["hbm_bytes_per_s"],
               nflops / peaks["flops_per_s"][dtype])


def roofline_pct(rec, op, kernels) -> float:
    """A kernel's share of its roofline in the traced solves: the least
    time of the operation ``op`` (a ``roofline/<op>.py`` module) times its
    applications, over the device time of the ``kernels`` that implement
    it; None where no such kernel ran."""
    device_s = rec.trace.seconds(kernels) if rec.trace else 0.0
    if device_s <= 0:
        return None
    apps = sum(op.per_solve(row) for row in rec.traced)
    least = least_seconds(op.nbytes(rec), op.nflops(rec),
                          rec.config["solver"]["dtype"])
    return 100.0 * least * apps / device_s
