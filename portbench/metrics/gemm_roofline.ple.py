"""The roofline of the model's products in the traced epoch, in %: the
least time of the products the loss depends on (``least_s["gemm"]``, the
configuration's work count: their operations at the float32-accurate rate
of the tensor cores) over the device time of the kernels that compute the
model's products, found by name (``work/ple_mamdr.py``'s ``gemm_kernel``);
None where the run has no such count or no such kernel."""

from portbench.work.ple_mamdr import gemm_kernel


def read(rec):
    t = rec.traced
    least = rec.traced_work.least_s.get("gemm", 0.0)
    if t is None or least <= 0:
        return None
    busy = t.time_of(gemm_kernel)
    if busy <= 0:
        return None
    return 100.0 * least / busy
