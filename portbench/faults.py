"""Faults planted under the program from outside, for the check of
``correct``: each is a context manager that breaks one step of the timed
path while its block runs and restores it after.

- ``training_half_batch``: every training step takes its loss over the
  first half of its batch alone;
- ``training_state_unchanged``: the optimiser's step leaves the weights
  and its moments as they were;
- ``populate_prior_dropped``: the device populate loop's rejection
  weight leaves out the auxiliary radii's prior.
"""

import contextlib

__all__ = ["FAULTS", "training_half_batch", "training_state_unchanged", "populate_prior_dropped"]


@contextlib.contextmanager
def _patched(owner, name, make):
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def training_half_batch():
    from nessai_tpu_torch.flowmodel.base import FlowModel

    def make(loss):
        def broken(self, x, w=None, context=None):
            h = max(x.shape[0] // 2, 1)
            return loss(self, x[:h], None if w is None else w[:h], *(() if context is None else (context[:h],)))

        return broken

    return _patched(FlowModel, "_loss", make)


def training_state_unchanged():
    import torch

    return _patched(torch.optim.AdamW, "step", lambda step: lambda self, closure=None: None)


def populate_prior_dropped():
    from nessai_tpu_torch.proposal.flowproposal.flowproposal import FlowProposal

    def make(constants):
        def broken(self, *args, **kwargs):
            loop = constants(self, *args, **kwargs)
            loop.aux_prior = lambda cols: 0.0
            return loop

        return broken

    return _patched(FlowProposal, "_device_loop_constants", make)


FAULTS = {
    "training_half_batch": training_half_batch,
    "training_state_unchanged": training_state_unchanged,
    "populate_prior_dropped": populate_prior_dropped,
}
