"""Every frame of the window over all of its time, as `frames_per_s`
reads it, in a cell where the host's pace spreads it too widely to
bound it end to end."""

UNIT = "frames/s"


def read(rec):
    return rec.frames / rec.window_s if rec.frames and rec.window_s else None
