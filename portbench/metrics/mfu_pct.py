"""The whole step's share of the card's TF32 peak, in %: the model's forward
and backward operations for the examples trained in the phase-timed window
(as the configuration's work count gives them), over its seconds (host
clock), against 495 TFLOP/s."""

from portbench.yardstick import PEAK_TF32_FLOPS


def read(rec):
    if rec.traced is None or not rec.phase_work.flops or not rec.phase_window_s > 0:
        return None
    return 100.0 * rec.phase_work.flops / rec.phase_window_s / PEAK_TF32_FLOPS
