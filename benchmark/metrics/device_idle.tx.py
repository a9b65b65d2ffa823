"""Share (%) of the traced window in which no kernel ran on the card (copies
count as idle here: they do no compute)."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or not r.trace.in_window():
        return None
    return 100.0 * (1.0 - r.trace.busy_s(("kernel",)) / r.trace.window_s)
