"""The coupling kernel's (K1: forward, inverse and backward) share of its
roofline over the traced window of a standard-sampler cell: the least
time of every launch, from the shapes the harness recorded around
``affine_coupling_layer`` and ``portbench.yardstick.k1_cost``, over the
device time of the kernels named ``affine_coupling_kernel`` and
``affine_coupling_backward_kernel`` in the trace."""

from portbench.readers import k1_roofline

UNIT = "%"


def read(window):
    return k1_roofline(window)
