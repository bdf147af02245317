"""DR examples per second of the DR phases (host clock, each phase ended by
a sync), over the phase-timed window."""


def read(rec):
    ex, s = rec.phase_work.phase_examples.get("dr", 0), rec.phase_s.get("dr", 0.0)
    if not ex or not s > 0:
        return None
    return ex / s
