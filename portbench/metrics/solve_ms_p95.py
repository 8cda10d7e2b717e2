"""The 95th percentile (nearest rank) of every solve's wall time in the
window, in ms."""

from portbench import stats


def read(rec):
    return stats.percentile([r.wall_s * 1e3 for r in rec.solves], 95) \
        if rec.solves else None
