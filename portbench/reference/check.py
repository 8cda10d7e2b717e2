"""The numbers that judge a run's answers, and their limits.

Each sampled answer of the window is judged by what it says, in float64 on
the benchmark's own matrix: A x = b to the configuration's tolerance,
relative to the starting residual ||b - A x0||, with status CONVERGED, and
its reported residual the residual of the x it returns.  The numbers:

- ``unconverged``: the window's solves whose status is not CONVERGED
  (an exact comparison: limit 0);
- ``res_true``: the largest ||b - A x|| / ||b - A x0|| over the sample;
- ``res_gap``: the largest | ||b - A x|| - reported residual | /
  ||b - A x0|| over the sample: how far the residual the solve reports
  lies from the residual of the answer it returns.

``limits/<cell>.json`` holds each number's limit, the readings it was set
from and the control they were read against (see PERF.md).
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Tuple

import torch

from portbench.reference.operator import CSROperator

NAMES = ("unconverged", "res_true", "res_gap")


def answer_readings(a: CSROperator, x0, answers) -> Dict[str, float]:
    """``answers``: ``[(b, x, reported_residual)]``, host arrays and
    floats.  Returns the largest ``res_true`` and ``res_gap`` over them; an
    answer with a NaN reads infinity."""
    dev = a.vals.device
    x0d = torch.as_tensor(x0, device=dev).double()
    worst = {"res_true": 0.0, "res_gap": 0.0}
    for b, x, reported in answers:
        bd = torch.as_tensor(b, device=dev).double()
        r0 = float(torch.linalg.vector_norm(bd - a.matvec(x0d)))
        xd = torch.as_tensor(x, device=dev).double()
        true = float(torch.linalg.vector_norm(bd - a.matvec(xd)))
        gap = abs(true - reported)
        worst["res_true"] = max(worst["res_true"],
                                true / r0 if true == true else math.inf)
        worst["res_gap"] = max(worst["res_gap"],
                               gap / r0 if gap == gap else math.inf)
    return worst


def judge(numbers: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, List[str], dict]:
    """``correct`` (every number at or under its limit), one printable line
    a number, and ``{name: {"value", "limit"}}`` for the result line."""
    ok, lines, table = True, [], {}
    for name in NAMES:
        value, limit = numbers[name], limits[name]
        good = value <= limit
        ok &= good
        lines.append(f"check {name} = {value!r} limit {limit!r}"
                     f" {'ok' if good else 'FAILED'}")
        # JSON has no infinity: a NaN answer reads the largest float
        table[name] = {"value": min(value, sys.float_info.max),
                       "limit": limit}
    return ok, lines, table
