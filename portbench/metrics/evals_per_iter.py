"""Likelihood evaluations a committed iteration in the window (the
model's own count, which the device populate loop raises by each
buffer it evaluates)."""

UNIT = "evals/iteration"


def read(window):
    if not window.iterations:
        return None
    return window.evaluations / window.iterations
