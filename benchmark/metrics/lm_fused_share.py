"""Share of the window's LM iterations that ran the dense LM kernels
(`TickStats.lm_fused_iterations` over `TickStats.iterations`, summed over
the ticks that had work), in %. None where the program keeps no such
counter or no tick iterated."""

UNIT = "%"


def read(rec):
    total = sum(t.iterations for t in rec.ticks)
    if not total or not all(hasattr(t, "lm_fused_iterations")
                            for t in rec.ticks):
        return None
    return 100.0 * sum(t.lm_fused_iterations for t in rec.ticks) / total
