"""Capped runs of the toy, full and calibration GW examples in both
packages, with the JAX tests' settings (``tests/test_gw_example.py``,
``tests/test_examples_smoke.py:179-200``): finite logZ, the same prime
parameters (the angles' Cartesian pairs, the angle pair's three), the
device likelihood in use, and for the calibration's non-box host prior
the populate the JAX package takes (no device populate loop)."""

import numpy as np
import pytest
import torch

from tests.test_torch_gw import SMALL, _plain_live_points, run_both  # noqa: F401 (an autouse fixture)

#: ``tests/test_examples_smoke.py``'s capped settings
CAPPED = dict(
    nlive=100,
    plot=False,
    checkpointing=False,
    resume=False,
    max_iteration=120,
    maximum_uninformed=40,
    poolsize=100,
    flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
    training_config=dict(max_epochs=3, patience=2, batch_size=50),
)


@pytest.fixture(autouse=True)
def _threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _proposals(runs):
    return runs["torch"][0].ns._flow_proposal, runs["jax"][0].ns._flow_proposal


def test_toy_cbc_capped(tmp_path, monkeypatch):
    runs = run_both(
        "toy_cbc",
        tmp_path,
        monkeypatch,
        nlive=200,
        seed=9,
        max_iteration=250,
        maximum_uninformed=100,
        poolsize=200,
        reparameterisations={"phi0": {"reparameterisation": "angle-2pi"}},
        **SMALL,
    )
    ours, theirs = _proposals(runs)
    assert ours.training_count >= 1 and theirs.training_count >= 1
    assert "phi0_x" in ours.prime_parameters
    assert list(ours.prime_parameters) == list(theirs.prime_parameters)
    assert runs["torch"][1].has_torch_likelihood and runs["jax"][1].has_jax_likelihood


def test_full_gw_example_capped(tmp_path, monkeypatch):
    """The 9-parameter model: 12 prime dimensions, the angle pair's three
    among them, and the device populate loop in both packages."""
    from nessai_tpu_torch.examples.gw.full_gw_example import SAMPLER_KWARGS

    runs = run_both(
        "full_gw_example",
        tmp_path,
        monkeypatch,
        seed=42,
        reparameterisations=SAMPLER_KWARGS["reparameterisations"],
        **CAPPED,
    )
    ours, theirs = _proposals(runs)
    assert list(ours.prime_parameters) == list(theirs.prime_parameters)
    assert len(ours.prime_parameters) == 12
    assert {"ra_x", "ra_y", "ra_z", "phase_x", "psi_x"} <= set(ours.prime_parameters)
    assert ours._can_device_loop and theirs._can_device_loop
    samples = runs["torch"][0].posterior_samples
    assert np.all(runs["torch"][1].in_bounds(samples))


def test_calibration_example_capped(tmp_path, monkeypatch):
    """The calibration nodes' Gaussian host prior keeps both packages off
    the device populate loop; the device likelihood still evaluates."""
    runs = run_both("calibration_example", tmp_path, monkeypatch, seed=42, **CAPPED)
    ours, theirs = _proposals(runs)
    assert list(ours.prime_parameters) == list(theirs.prime_parameters)
    assert not ours._can_device_loop and not theirs._can_device_loop
    assert runs["torch"][1].has_torch_likelihood and runs["jax"][1].has_jax_likelihood
