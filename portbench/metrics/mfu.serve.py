"""The model's share, %, of the card's float32 peak over the traced
sub-window: the yardstick's count of a request's forward (the reference's matrix
products and FFTs as it runs them, the oscillator at K1's count a live
term, and in training the backward at twice the products and transforms
and K4's count a cell; elementwise work not counted) over the sub-window's
wall seconds, against 67 TFLOP/s."""

from portbench import yardstick


def read(trace):
    if trace.kind != 'serve' or not trace.model_flops:
        return None
    return (100.0 * trace.model_flops / trace.window_s
            / yardstick.PEAK_F32_FLOPS)
