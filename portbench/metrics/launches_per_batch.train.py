"""Kernels launched on the card over the traced epoch, per 1024-row batch
stepped (a DN step or a DR lane-step)."""


def read(rec):
    t = rec.traced
    if t is None or not rec.traced_work.batches:
        return None
    return t.launches / rec.traced_work.batches
