"""The program's own records of a run (``cuda_mat_tpu_torch.utils.timing``),
matched to the harness's solves.

A run leaves, after its one ``make_solver`` record, a ``solve`` record for
the warm-up, one for each solve of the window and one for each traced
solve, in that order.  The readers of the ``program_span`` metrics take
the window's records from :func:`window` and the set-up's from
:func:`make_solver`; each returns None where the program keeps no records
(a checkout older than the recorder) or where the records do not match the
harness's solves, so that a metric is left out and never misattributed.
"""

from __future__ import annotations

from typing import List, Optional


def program_records() -> Optional[list]:
    """The program's closed records, oldest first; None where the program
    has no recorder."""
    try:
        from cuda_mat_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "records", None)
    return None if read is None else read()


def _last_make_solver(records) -> Optional[int]:
    for k in range(len(records) - 1, -1, -1):
        if records[k].kind == "make_solver":
            return k
    return None


def window(rec, records=None) -> Optional[List]:
    """The window's solve records: those after the last ``make_solver``
    record, if they are exactly the warm-up, the window and the traced
    solves and each window record's ``iters`` is its solve's; else None."""
    records = program_records() if records is None else records
    if not records or not rec.solves:
        return None
    last = _last_make_solver(records)
    if last is None:
        return None
    solves = [r for r in records[last + 1:] if r.kind == "solve"]
    if len(solves) != 1 + len(rec.solves) + len(rec.traced):
        return None
    kept = solves[1:1 + len(rec.solves)]
    if any(r.iters != row.iters for r, row in zip(kept, rec.solves)):
        return None
    return kept


def make_solver(records=None):
    """The last ``make_solver`` record, or None."""
    records = program_records() if records is None else records
    if not records:
        return None
    last = _last_make_solver(records)
    return None if last is None else records[last]


def mean_ms(rec, name: str, records=None) -> Optional[float]:
    """The mean of span ``name`` over the window's solves, in ms."""
    kept = window(rec, records)
    if not kept:
        return None
    vals = [r.seconds(name) for r in kept]
    if any(v is None for v in vals):
        return None
    return sum(vals) * 1e3 / len(vals)


def ms_per_iter(rec, name: str, records=None) -> Optional[float]:
    """Span ``name`` summed over the window's solves over their summed
    iterations, in ms."""
    kept = window(rec, records)
    iters = sum(r.iters for r in kept) if kept else 0
    if not iters:
        return None
    vals = [r.seconds(name) for r in kept]
    if any(v is None for v in vals):
        return None
    return sum(vals) * 1e3 / iters
