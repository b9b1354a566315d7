"""Host wall of the odometry spans (`run_batch` / `run_batch_multi` and
the block's one host read), per frame."""

UNIT = "ms"


def read(rec):
    t = rec.wall_s.get("odometry")
    return t / rec.frames * 1e3 if t and rec.frames else None
