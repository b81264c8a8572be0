"""The consume/insert scan kernel's share of its roofline over the traced
window: the least time of every scan the window launched
(``portbench.yardstick.scan_cost`` on the shapes and accepted insertion
indices the harness recorded around ``ns_scan``), over the device time of
the kernels whose names hold ``ns_scan`` in the trace."""

from portbench.yardstick import least_seconds, scan_cost

UNIT = "%"


def read(window):
    if window.trace is None or not window.rec.scan_shapes:
        return None
    device = sum(t for name, t in window.trace.seconds_by_name(window.t0, window.t_close).items() if "ns_scan" in name)
    if device <= 0:
        return None
    bound = 0.0
    for n, k, mask, ins in window.rec.scan_shapes:
        places = int(ins[mask.bool()].clamp(min=0).sum().item())
        bound += least_seconds(*scan_cost(n, k, places))
    return 100.0 * bound / device
