"""DN examples per second of the DN phases (host clock, each phase ended by
a sync), over the phase-timed window."""


def read(rec):
    if not rec.phase_work.dn_examples or not rec.dn_s > 0:
        return None
    return rec.phase_work.dn_examples / rec.dn_s
