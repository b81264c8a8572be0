"""Share of the traced window of a standard-sampler cell in which no
kernel, copy or memset ran on the card: one minus the union of the
trace's device intervals over the window's length."""

from portbench.readers import idle_share

UNIT = "%"


def read(window):
    return idle_share(window)
