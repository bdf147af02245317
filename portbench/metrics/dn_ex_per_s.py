"""DN examples per second of the DN phases (host clock, each phase ended by
a sync), over the phase-timed window."""


def read(rec):
    ex, s = rec.phase_work.phase_examples.get("dn", 0), rec.phase_s.get("dn", 0.0)
    if not ex or not s > 0:
        return None
    return ex / s
