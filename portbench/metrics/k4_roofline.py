"""The Adam pass K4's least time over its device time in the traced epoch,
in %: 28 bytes an element of every trainable leaf (p, g, mu and nu read,
p', mu' and nu' written), in each lane that holds data, in each Adam step
of the epoch, at the HBM rate (``yardstick.adam_least_s``)."""

from portbench.yardstick import adam_least_s


def read(rec):
    t = rec.traced
    if t is None or not rec.trainable or not rec.traced_work.lane_steps:
        return None
    busy = t.time_of(lambda n: "adam_update_kernel" in n)
    if busy <= 0:
        return None
    return 100.0 * adam_least_s(rec.trainable, rec.traced_work.lane_steps) / busy
