"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math
from typing import Sequence


def window_ms(window_s: float, count: int) -> float:
    """Milliseconds a solve: the window's seconds over the solves completed
    in it."""
    return window_s * 1e3 / count


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q`` percent of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100 * len(ordered)), 1) - 1]

