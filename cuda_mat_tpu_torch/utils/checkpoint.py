"""Solver checkpoint/resume (numpy copy of
:mod:`cuda_mat_tpu.utils.checkpoint`: the same ``.npz`` keys, so a
checkpoint written by either package loads in the other).

BiCGSTAB restarts from its current iterate, so a checkpoint is (x,
iteration count, residual); the restart re-derives the Krylov state from
``r = b - A x``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SolverCheckpoint:
    x: np.ndarray
    iters: int
    residual: float
    meta: dict


def save_checkpoint(path: str, result_or_x, iters: Optional[int] = None,
                    residual: Optional[float] = None, **meta) -> None:
    """Save a solve's iterate.  Accepts a SolveResult or a raw x vector."""
    if hasattr(result_or_x, "x"):
        x = np.asarray(result_or_x.x)
        iters = result_or_x.iters if iters is None else iters
        residual = (result_or_x.residual if residual is None else residual)
    else:
        x = np.asarray(result_or_x)
        iters = 0 if iters is None else iters
        residual = float("nan") if residual is None else residual
    np.savez(path, x=x, iters=np.int64(iters), residual=np.float64(residual),
             **{f"meta_{k}": np.asarray(v) for k, v in meta.items()})


def load_checkpoint(path: str) -> SolverCheckpoint:
    with np.load(path) as z:
        meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
        return SolverCheckpoint(x=z["x"], iters=int(z["iters"]),
                                residual=float(z["residual"]), meta=meta)
