"""The tower kernel K1's least time over its device time in the traced
epoch, in %: the least time of each call is the larger of its operations
at the TF32 peak and its bytes at the HBM rate (yardstick.k1_least_s)."""


def _k1(name):
    return "slab_kernel" in name or "dw_kernel" in name


def read(rec):
    t = rec.traced
    if t is None:
        return None
    busy = t.time_of(_k1)
    if busy <= 0 or rec.traced_work.k1_least_s <= 0:
        return None
    return 100.0 * rec.traced_work.k1_least_s / busy
