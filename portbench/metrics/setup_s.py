"""Seconds from the process's start to the window's: imports, the kernels
loaded from the checkout's build, the model and its data on the card,
and the warm-up of the cell's shapes. Host clock."""

UNIT = "s"


def read(window):
    return window.setup_s
