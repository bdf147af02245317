"""Seconds from the start of the run to the first timed epoch."""


def read(rec):
    return rec.setup_s
