"""The solve's vector boundary on the way in, from the program's records:
the mean over the window's solves of the span ``solve.prep`` (b and x0
cast, padded and uploaded, and the wait for the uploads), in ms."""

from portbench import program_spans


def read(rec):
    return program_spans.mean_ms(rec, "solve.prep")
