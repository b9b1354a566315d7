"""`TickStats.loop_closure_us`, the pair program and loop selection,
mean over the ticks that had work."""

UNIT = "ms"


def read(rec):
    if not rec.ticks:
        return None
    return sum(t.loop_closure_us for t in rec.ticks) / len(rec.ticks) / 1e3
