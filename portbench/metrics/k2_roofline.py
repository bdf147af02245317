"""The field gather K2's least time over its device time in the traced
epoch, in %: each call's bytes (every table row its real ids touch read
once, the ids, the output, the trained fields' row ids) at the HBM rate."""


def read(rec):
    t = rec.traced
    if t is None:
        return None
    busy = t.time_of(lambda n: "gather_fields_kernel" in n)
    if busy <= 0 or rec.traced_work.k2_least_s <= 0:
        return None
    return 100.0 * rec.traced_work.k2_least_s / busy
