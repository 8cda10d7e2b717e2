"""Chunks of a forward and a backward triangular sweep together on the
``"levels"`` route's chunked layout, each a hand-over of the level chain
from one SM to the next: the count ``chunks`` of the program's last
``make_solver`` record (0 where the sweeps walk the grid-barrier layout);
None where the program keeps no such count."""

from portbench import program_spans


def read(rec):
    return getattr(program_spans.make_solver(), "chunks", None)
