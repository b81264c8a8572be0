"""The whole step's share of the card's float32 peak over the traced
window of a standard-sampler cell: the operations of every coupling of
the flow (each conditioner net and transform on the rows the harness
recorded around ``affine_coupling_layer``, three times that where a
backward followed) and of every likelihood evaluation (the
configuration's operations a row), over the window's seconds and
67 TFLOP/s (495 with TF32 matmuls on)."""

from portbench.readers import step_mfu

UNIT = "%"


def read(window):
    return step_mfu(window)
