"""`TickStats.optimization_us`, the LM solve and its packed read, mean
over the ticks that had work."""

UNIT = "ms"


def read(rec):
    if not rec.ticks:
        return None
    return sum(t.optimization_us for t in rec.ticks) / len(rec.ticks) / 1e3
