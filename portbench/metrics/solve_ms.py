"""Milliseconds a solve: the window's seconds x 1000 over the solves
completed in it (a solve runs from the call with a host b until x is back
on the host)."""

from portbench import stats


def read(rec):
    return stats.window_ms(rec.window_s, len(rec.solves)) if rec.solves \
        else None
