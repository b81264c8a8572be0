"""Share of the window spent populating the proposal's pool (the flow's
device populate loop, or the prior populated on the device), from the
harness's spans around the proposals' ``populate``."""

from portbench.readers import span_share

UNIT = "%"


def read(window):
    return span_share(window, ("populate",))
