"""The share of the traced window in which no operation ran on the card
(1 minus the union of device activity over the window)."""

UNIT = "%"


def read(rec):
    tr = rec.trace
    if not tr or not tr["busy_s"] or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
