"""The solve's vector boundary on the way out, from the program's records:
the mean over the window's solves of the span ``solve.finish`` (x
unpadded and downloaded, the history and scalars read back), in ms."""

from portbench import program_spans


def read(rec):
    return program_spans.mean_ms(rec, "solve.finish")
