"""Share of the window in which the standard sampler was neither training
its flow nor populating a pool: the host loop, the commits of consumed
pools, checkpoints and the runs' set-up and result files (the harness's
spans around the sampler's calls)."""

from portbench.readers import host_share

UNIT = "%"


def read(window):
    return host_share(window, ("training", "populate"))
