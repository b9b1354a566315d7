"""Device time under the odometry spans, per traced frame."""

UNIT = "ms"


def read(rec):
    t = (rec.trace or {}).get("layer_device_s", {}).get("odometry")
    return t / rec.trace_frames * 1e3 if t and rec.trace_frames else None
