"""Seconds from the process's start to the window's opening: imports and
the card's context, the matrix and the right-hand sides, make_solver, the
warm-up solve, and in a checkout's first run the kernels' builds."""


def read(rec):
    return rec.setup_s
