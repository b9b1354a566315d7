"""Device time under the prefilter spans, per traced frame (the
prefilter ends in no host read, so its host wall would time the
enqueue)."""

UNIT = "ms"


def read(rec):
    t = (rec.trace or {}).get("layer_device_s", {}).get("prefilter")
    return t / rec.trace_frames * 1e3 if t and rec.trace_frames else None
