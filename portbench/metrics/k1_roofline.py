"""The tower kernel K1's least time over its device time in the traced
epoch, in %: the least time of each call is the larger of its operations
at the TF32 peak and its bytes at the HBM rate, as the configuration's work
count gives it (``least_s["k1"]``); None where the program runs no K1."""


def _k1(name):
    return "slab_kernel" in name or "dw_kernel" in name


def read(rec):
    t = rec.traced
    least = rec.traced_work.least_s.get("k1", 0.0)
    if t is None or least <= 0:
        return None
    busy = t.time_of(_k1)
    if busy <= 0:
        return None
    return 100.0 * least / busy
