"""The share of the traced epoch's device busy time spent in the kernels
that compute the model's products (``work/ple_mamdr.py``'s ``gemm_kernel``,
by name), in %."""

from portbench.work.ple_mamdr import gemm_kernel


def read(rec):
    t = rec.traced
    if t is None or not t.busy_s > 0:
        return None
    busy = t.time_of(gemm_kernel)
    if busy <= 0:
        return None
    return 100.0 * busy / t.busy_s
