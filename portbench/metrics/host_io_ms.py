"""The solve's vector boundary: the mean over the window's solves of the
solve's wall time less its dt_alg (b cast, padded and uploaded, x0 made,
x unpadded and downloaded), in ms."""


def read(rec):
    if not rec.solves:
        return None
    return sum(r.wall_s - r.dt_alg_s for r in rec.solves) * 1e3 \
        / len(rec.solves)
