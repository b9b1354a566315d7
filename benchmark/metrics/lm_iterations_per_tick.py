"""`TickStats.iterations`, the LM iterations of a tick's solve (each one
`lm.iteration` span of the program, ending in its one host read), mean
over the ticks that had work."""

UNIT = "count"


def read(rec):
    if not rec.ticks:
        return None
    return sum(t.iterations for t in rec.ticks) / len(rec.ticks)
