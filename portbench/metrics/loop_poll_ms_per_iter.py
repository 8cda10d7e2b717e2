"""The loop's blocking poll, from the program's records: the span
``loop.poll`` (the read of status and counter that waits for the step to
finish on the device) summed over the window's solves, over their summed
iterations, in ms."""

from portbench import program_spans


def read(rec):
    return program_spans.ms_per_iter(rec, "loop.poll")
