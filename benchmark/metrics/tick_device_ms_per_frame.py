"""Device time under the tick spans (loop closure and the graph solve),
per traced frame."""

UNIT = "ms"


def read(rec):
    t = (rec.trace or {}).get("layer_device_s", {}).get("tick")
    return t / rec.trace_frames * 1e3 if t and rec.trace_frames else None
