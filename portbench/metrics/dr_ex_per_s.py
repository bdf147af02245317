"""DR examples per second of the DR phases (host clock, each phase ended by
a sync), over the phase-timed window."""


def read(rec):
    if not rec.phase_work.dr_examples or not rec.dr_s > 0:
        return None
    return rec.phase_work.dr_examples / rec.dr_s
