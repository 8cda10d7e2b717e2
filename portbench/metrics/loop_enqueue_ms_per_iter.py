"""The host's queueing of the loop's steps, from the program's records:
the span ``loop.step`` (each step from its start to its poll) summed over
the window's solves, over their summed iterations, in ms."""

from portbench import program_spans


def read(rec):
    return program_spans.ms_per_iter(rec, "loop.step")
