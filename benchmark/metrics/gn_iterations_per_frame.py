"""Gauss-Newton iterations of the odometry per frame (`outs.iterations`,
summed over frames and robots)."""

UNIT = "count"


def read(rec):
    return rec.gn_iterations / rec.frames if rec.frames else None
