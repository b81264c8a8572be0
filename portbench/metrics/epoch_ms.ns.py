"""Milliseconds a training epoch of the standard sampler's flow: the
seconds of the trainings that ended inside the window over their epochs
(the flow's loss history), from the harness's spans around
``train_proposal``. Nothing where no training ended in the window."""

from portbench.readers import epoch_ms

UNIT = "ms"


def read(window):
    return epoch_ms(window)
