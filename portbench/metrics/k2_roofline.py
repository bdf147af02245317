"""The field gather K2's least time over its device time in the traced
epoch, in %: each call's bytes (every table row its real ids touch read
once, the ids, the output, the trained fields' row ids) at the HBM rate, as
the configuration's work count gives it (``least_s["k2"]``)."""


def read(rec):
    t = rec.traced
    least = rec.traced_work.least_s.get("k2", 0.0)
    if t is None or least <= 0:
        return None
    busy = t.time_of(lambda n: "gather_fields_kernel" in n)
    if busy <= 0:
        return None
    return 100.0 * least / busy
