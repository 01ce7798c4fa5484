"""Share of the traced window in which nothing runs on the card, in percent:
one minus the union of the device activity intervals over the window."""


def read(rec):
    if rec["window_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
