"""Host wall of the spans around a block's `process_scan` calls, per
frame."""

UNIT = "ms"


def read(rec):
    t = rec.wall_s.get("ingest")
    return t / rec.frames * 1e3 if t and rec.frames else None
