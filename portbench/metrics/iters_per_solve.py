"""Iterations a solve: the window's summed iteration counts over its
solves."""


def read(rec):
    return sum(r.iters for r in rec.solves) / len(rec.solves) \
        if rec.solves else None
