"""On the card: the control of each cell's ``correct`` fails its limits,
and the program passes them, at the cell's own size with a short window.

Run on a CUDA machine with ``python -m pytest portbench/tests -m cuda``;
without a card every test here skips.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import harness  # noqa: E402

pytestmark = pytest.mark.cuda

SPEC = harness.load_spec()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("workload", [c["name"] for c in SPEC["workloads"]])
def test_the_control_fails_and_the_program_passes(card, workload):
    from portbench.control import readings

    result, control = readings(workload, 2**31 + 101, 10.0, device=card)
    limits = harness.load_limits(workload)
    assert result["correct"], result["checks"]
    failed = [k for k, v in control.items() if v > limits[k]]
    assert failed, control
