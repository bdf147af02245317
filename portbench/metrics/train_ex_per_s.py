"""Examples trained over the window, per second of it (host clock, synced)."""


def read(rec):
    if not rec.work.examples or not rec.window_s > 0:
        return None
    return rec.work.examples / rec.window_s
