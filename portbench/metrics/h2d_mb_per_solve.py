"""Megabytes (10^6 bytes) of vectors a solve stages up to the card: the
mean over the window's solves of their records' ``h2d_bytes`` (b, and x0
where the caller gives one); None where the program keeps no such count."""

from portbench import program_spans


def read(rec):
    kept = program_spans.window(rec)
    if not kept:
        return None
    counts = [getattr(r, "h2d_bytes", None) for r in kept]
    if any(c is None for c in counts):
        return None
    return sum(counts) / len(counts) / 1e6
