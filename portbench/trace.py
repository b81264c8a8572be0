"""Reading the device's work out of a ``torch.profiler`` trace.

The traced run profiles the card alone (no host operator records), so
that a window of millions of kernels stays cheap to record and to read.
The host's clock and the trace's clock are tied by a marker kernel
launched at a known host time at the window's start. What the host was
doing during an idle gap comes from the harness's own spans (training,
populate, the rest of the sampler's loop), which are on the host's clock.
"""

import time

__all__ = ["DeviceTrace", "union_seconds", "idle_gaps", "label_gaps"]

#: the marker's name in the trace (``torch.cuda._sleep``'s kernel)
MARKER = "spin_kernel"


def union_seconds(intervals):
    """Seconds covered by the union of ``(start, end)`` intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start, end):
    """The ``(start, end)`` gaps in ``[start, end]`` that no interval covers."""
    gaps = []
    cursor = start
    for s, e in sorted(intervals):
        if e <= cursor:
            continue
        s = max(s, start)
        if s > end:
            break
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < end:
        gaps.append((cursor, end))
    return gaps


def label_gaps(gaps, spans, top=10):
    """The ``top`` longest gaps, each named by the host span that holds
    its midpoint (the innermost, that is the latest to start), else
    ``"host loop"``: ``[[name, seconds], ...]``."""
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        name = "host loop"
        best = None
        for span in spans:
            if span[1] <= mid <= span[2] and (best is None or span[1] >= best):
                best, name = span[1], span[0]
        out.append([name, e - s])
    return out


class DeviceTrace:
    """The kernels of a profiled window, on the host's clock, in seconds."""

    def __init__(self):
        self.kernels = []  # (name, start, end) on the host clock
        self._prof = None
        self._host_marker = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._host_marker = time.perf_counter()
        torch.cuda._sleep(1)

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        dev = [
            e
            for e in events
            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()
        ]
        marker = [e for e in dev if MARKER in e.name()]
        if not marker:
            self.kernels = []
            return
        offset = self._host_marker - marker[0].start_ns() * 1e-9
        self.kernels = [
            (e.name(), e.start_ns() * 1e-9 + offset, e.end_ns() * 1e-9 + offset)
            for e in dev
            if e is not marker[0]
        ]
        self._prof = None

    def clipped(self, start, end):
        """The kernels' intervals clipped to ``[start, end]``."""
        return [(max(s, start), min(e, end)) for _, s, e in self.kernels if e > start and s < end]

    def seconds_by_name(self, start, end):
        out = {}
        for name, s, e in self.kernels:
            if e > start and s < end:
                out[name] = out.get(name, 0.0) + (min(e, end) - max(s, start))
        return out
