"""Seconds of make_solver (the benchmark's span around the call, which ends
with a device synchronise): operator, preconditioner factors, their
layouts and uploads."""


def read(rec):
    return rec.spans.get("make_solver")
