"""The rest of a measured run, with the program broken underneath, comes out
not correct; and a sound run comes out correct.

These drive ``harness.run_cell`` past its look for a card: on the CPU, at
a small size of ``gw_basic.ns`` (nlive 100, a window of a few seconds),
judged by the cell's own limits. Each fault is planted in the program's
modules from outside and taken out again. The faults are those a nested
sampler on one card can have: a step that returns its state unchanged
(the scan leaves the live set as it was),
half of a batch left out (the likelihood's second half of each batch
copied from its first), and an answer altered where it is produced (the
coupling kernel's log-determinant, a likelihood value); and those of
:mod:`portbench.faults`: a training step that leaves the weights as they
were, a training loss over half of its batch, and a populate whose
rejection weight leaves out part of the prior. The exchange between chips
has no place in a cell on one chip.
"""

import contextlib
import importlib
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import harness  # noqa: E402

SMALL = dict(
    sampler_kwargs=dict(
        harness.load_config("gw_basic")["sampler_kwargs"], nlive=100, flow_config=dict(n_blocks=2, n_neurons=8)
    )
)


def _run(workload="gw_basic.ns", seconds=20.0):
    return harness.run_cell(workload, 2**31 + 77, seconds, False, device="cpu", config_override=SMALL)


def test_a_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0


def _unchanged_live_set(monkeypatch):
    mod = importlib.import_module("nessai_tpu_torch.ops.ns_scan")

    plain = mod.ns_scan_plain

    def broken(live, pool, max_accepts):
        mask, consumed, ins, final_ids, n_acc = plain(live, pool, max_accepts)
        return mask, consumed, ins, torch.arange(live.shape[0], dtype=final_ids.dtype), n_acc

    monkeypatch.setattr(mod, "ns_scan_plain", broken)


def _half_batch(monkeypatch):
    from nessai_tpu_torch.examples.gw.basic_gw_example import BasicGWModel

    fn = BasicGWModel.torch_log_likelihood

    def broken(self, x, data):
        out = fn(self, x, data)
        h = out.shape[0] // 2
        if h:
            out = out.clone()
            out[h : 2 * h] = out[:h]
        return out

    monkeypatch.setattr(BasicGWModel, "torch_log_likelihood", broken)


def _altered_log_det(monkeypatch):
    coupling = importlib.import_module("nessai_tpu_torch.ops.coupling")

    plain = coupling.affine_coupling_layer_plain

    def broken(*args, **kwargs):
        y, ld = plain(*args, **kwargs)
        return y, ld + 0.05

    monkeypatch.setattr(coupling, "affine_coupling_layer_plain", broken)


def _altered_likelihood(monkeypatch):
    from nessai_tpu_torch.examples.gw.basic_gw_example import BasicGWModel

    fn = BasicGWModel.torch_log_likelihood

    def broken(self, x, data):
        out = fn(self, x, data).clone()
        # raised, so that the altered point is accepted and committed
        out[-1:] = out[-1:] * (1 - 1e-3)
        return out

    monkeypatch.setattr(BasicGWModel, "torch_log_likelihood", broken)


def _planted(name):
    """A fault of :mod:`portbench.faults`: its context manager."""
    from portbench.faults import FAULTS

    return lambda monkeypatch: FAULTS[name]()


@pytest.mark.parametrize(
    "fault,number",
    [
        (_unchanged_live_set, "ordering_mismatches"),
        (_half_batch, "likelihood_gap"),
        (_altered_log_det, "flow_logp_gap"),
        (_altered_likelihood, "likelihood_gap"),
        (_planted("training_state_unchanged"), "train_change_gap"),
        (_planted("training_half_batch"), "train_loss_gap"),
        (_planted("populate_prior_dropped"), "populate_flips"),
    ],
    ids=[
        "state_unchanged",
        "half_batch",
        "altered_log_det",
        "altered_likelihood",
        "training_state_unchanged",
        "training_half_batch",
        "populate_prior_dropped",
    ],
)
def test_a_broken_program_is_not_correct(monkeypatch, fault, number):
    with fault(monkeypatch) or contextlib.nullcontext():
        result = _run()
    assert not result["correct"]
    check = result["checks"][number]
    assert check["value"] > check["limit"], result["checks"]
