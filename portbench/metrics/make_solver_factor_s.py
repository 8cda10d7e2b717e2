"""Seconds of the host ILU(0) / MILU(0) factorization: the span
``precond.factor`` of the program's last ``make_solver`` record."""

from portbench import program_spans


def read(rec):
    r = program_spans.make_solver()
    return None if r is None else r.seconds("precond.factor")
