"""Share of the traced epoch's window with nothing on the card, in %."""


def read(rec):
    t = rec.traced
    if t is None or not t.window_s > 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
