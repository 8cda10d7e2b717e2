"""Seconds of make_solver's preconditioner less its factorization (layout
re-plan, the factors' operators or block inverses, uploads): the span
``make_solver.precond`` of the program's last ``make_solver`` record, less
its ``precond.factor``."""

from portbench import program_spans


def read(rec):
    r = program_spans.make_solver()
    total = None if r is None else r.seconds("make_solver.precond")
    if total is None:
        return None
    return total - (r.seconds("precond.factor") or 0.0)
