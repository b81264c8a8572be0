"""Nested-sampling iterations a second: the dead points committed to the
evidence by the window's end, over the window's seconds (host clock)."""

UNIT = "iterations/s"


def read(window):
    return window.iterations / window.seconds
