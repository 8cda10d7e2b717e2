"""The loop's time an iteration: the window's summed dt_alg over its summed
iteration counts, in ms."""


def read(rec):
    iters = sum(r.iters for r in rec.solves)
    return sum(r.dt_alg_s for r in rec.solves) * 1e3 / iters if iters \
        else None
