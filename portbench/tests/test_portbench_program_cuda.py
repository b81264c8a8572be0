"""On the card: the program's spans (``nessai_tpu_torch.utils.profiling``)
and the device trace (``portbench.trace.DeviceTrace``) share one clock. A
span around a sleep kernel and a synchronisation holds that kernel, as
the trace's marker places it on the host's clock, to within 50 us.

``DeviceTrace.start`` reads the host's clock before it launches the
marker, and the first launch under a profiler just started takes tens to
hundreds of microseconds, so the trace places every kernel early by that
launch. The test reads the clock again as soon as ``start`` returns, and
ties the marker there: between the two readings the launch was made, and
the card, idle after a synchronisation, starts the marker within some
microseconds of it. The test reports the launch beside its check.

Run on a CUDA machine with ``python -m pytest portbench/tests -m cuda``;
without a card the test skips.
"""

import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench.trace import MARKER, DeviceTrace  # noqa: E402

pytestmark = pytest.mark.cuda

#: how far the span's and the trace's clocks may disagree, in seconds
TOLERANCE_S = 50e-6

#: spans a trace holds, each around one sleep kernel
SPANS = 4


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("cycles", [2_000_000, 20_000_000, 2_000_000, 20_000_000])
def test_a_span_holds_its_kernel_on_the_trace_clock(card, cycles):
    import torch

    from nessai_tpu_torch.utils import profiling

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    trace = DeviceTrace()
    trace.start()
    launched = time.perf_counter()
    profiling.start_tracing()
    try:
        for _ in range(SPANS):
            with profiling.annotate("sleep"):
                torch.cuda._sleep(cycles)
                torch.cuda.synchronize()
    finally:
        record = profiling.stop_tracing()
        trace.stop()
    kernels = [(s, e) for name, s, e in trace.kernels if MARKER in name]
    assert len(record.spans) == len(kernels) == SPANS
    # the marker's launch: how early the trace places every kernel
    early = launched - trace._host_marker
    ends = []
    for span, kernel in zip(record.spans, kernels):
        start, end = span.start * 1e-9, span.end * 1e-9
        placed = (kernel[0] + early, kernel[1] + early)
        where = dict(span=(start, end), kernel=placed, marker_launch_us=early * 1e6)
        # the kernel starts after the span does and ends before it
        assert start - TOLERANCE_S <= placed[0] < placed[1] <= end + TOLERANCE_S, where
        ends.append(end - placed[1])
    # the synchronisation that ends a span returns as its kernel ends,
    # unless the host stalls, which only lengthens the gap: the shortest
    # gap bounds how early the trace places the kernels
    assert min(ends) <= TOLERANCE_S, (ends, early)
