"""The whole step's share of the card's TF32 peak, in %: the model's forward
and backward operations for the examples trained in the phase-timed window,
over its seconds (host clock), against 495 TFLOP/s."""

from portbench.yardstick import PEAK_TF32_FLOPS, example_flops


def read(rec):
    if rec.traced is None or not rec.phase_work.examples or not rec.phase_window_s > 0:
        return None
    flops = rec.phase_work.examples * example_flops(rec.dims)
    return 100.0 * flops / rec.phase_window_s / PEAK_TF32_FLOPS
