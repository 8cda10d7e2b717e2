"""Seconds of the level analysis of both triangles of the ILU(0) factor and
its upload (the ``"levels"`` route): the span ``precond.levels`` of the
program's last ``make_solver`` record; None where the program keeps no
such span."""

from portbench import program_spans


def read(rec):
    r = program_spans.make_solver()
    return None if r is None else r.spans.get("precond.levels")
