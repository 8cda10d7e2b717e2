"""Seconds of make_solver's operator (DIA conversion, stencil proof,
layout, upload): the span ``make_solver.operator`` of the program's last
``make_solver`` record."""

from portbench import program_spans


def read(rec):
    r = program_spans.make_solver()
    return None if r is None else r.seconds("make_solver.operator")
