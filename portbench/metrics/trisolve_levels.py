"""Levels of a forward and a backward triangular sweep together on the
``"levels"`` route, the chain each msolve walks: the count ``levels`` of
the program's last ``make_solver`` record; None where the program keeps no
such count or took another route."""

from portbench import program_spans


def read(rec):
    r = program_spans.make_solver()
    return getattr(r, "levels", None) or None
