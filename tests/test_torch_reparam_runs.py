"""Whole runs of the standard sampler through the reparameterisations, in
each package on the CPU: the four reparameterisation examples with their
specs (``reparam_examples.SPECS``).

Cut for the CPU from the examples' defaults: nlive 2000 -> 300, the
RealNVP of 4 blocks of 2 layers ("auto" neurons) -> 2 blocks of one
8-neuron layer, 500 -> 30 epochs at most, patience 20 -> 10, batches of
1000 -> 300. The seed stays 1234. Each run's logZ is within 3σ of the
analytic value where one is known, and the two packages are within 3σ of
each other. The packages agree at the statistical level only: their flow
weights start from different generators, and the JAX package pads its
training batches to a power-of-two count where the port does not (the
inversion's duplicates and the angle's radii change the row counts).
"""

import jax
import numpy as np
import pytest
import torch
from reparam_examples import ANALYTIC, SPECS, example_models

import nessai_tpu.livepoint as jax_livepoint
from nessai_tpu.flowsampler import FlowSampler as JaxFlowSampler
from nessai_tpu.model import Model as JaxModelBase
from nessai_tpu_torch import livepoint
from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.model import Model
from nessai_tpu_torch.utils.testing import AngleModel, HalfGaussianModel

TORCH_MODELS = dict(
    example_models(Model, livepoint.empty_structured_array, livepoint.numpy_array_to_live_points),
    half_gaussian=HalfGaussianModel,
    angle=AngleModel,
)
JAX_MODELS = example_models(
    JaxModelBase, jax_livepoint.empty_structured_array, jax_livepoint.numpy_array_to_live_points
)
CPU_RUN = dict(
    nlive=300,
    seed=1234,
    flow_config=dict(n_blocks=2, n_neurons=8, n_layers=1),
    training_config=dict(max_epochs=30, patience=10, batch_size=300),
)


def _in_bounds(samples, model):
    return len(samples) and all(
        np.all((samples[n] >= model.bounds[n][0]) & (samples[n] <= model.bounds[n][1])) for n in model.names
    )


@pytest.mark.parametrize("example", list(SPECS))
def test_example_runs_agree_with_jax(tmp_path, example):
    torch.set_float32_matmul_precision("highest")
    spec = SPECS[example]
    model = TORCH_MODELS[example]()
    fs = FlowSampler(model, output=str(tmp_path / "torch"), device="cpu", reparameterisations=spec,
                     plot=False, checkpointing=False, **CPU_RUN)
    t_logz, nested = fs.run(plot=False, save=False)
    t_err = fs.logZ_error
    with jax.default_device(jax.devices("cpu")[0]):
        jfs = JaxFlowSampler(JAX_MODELS[example](), output=str(tmp_path / "jax"), resume=False, plot=False,
                             checkpointing=False, reparameterisations=spec, **CPU_RUN)
        j_logz, _ = jfs.run(plot=False, save=False)
    j_err = jfs.logZ_error
    if example in ANALYTIC:
        assert abs(t_logz - ANALYTIC[example]) < 3 * t_err, (t_logz, t_err)
        assert abs(j_logz - ANALYTIC[example]) < 3 * j_err, (j_logz, j_err)
    assert abs(t_logz - j_logz) < 3 * np.hypot(t_err, j_err), (t_logz, j_logz)
    # the stack the spec asked for, and model-space samples
    stack = fs.ns.flow_proposal._reparameterisation
    jax_stack = jfs.ns.flow_proposal._reparameterisation
    assert {k: type(r).__name__ for k, r in stack.items()} == {k: type(r).__name__ for k, r in jax_stack.items()}
    assert fs.ns.train_count > 0
    assert nested.dtype.names == fs.posterior_samples.dtype.names
    assert set(model.names) <= set(nested.dtype.names)
    if example != "unbounded_prior":
        assert _in_bounds(nested, model) and _in_bounds(fs.posterior_samples, model)
    if example == "half_gaussian":
        assert stack["rescaletobounds_x"]._edges["x"] == "lower"
    if example == "angle":
        assert "theta_radial" not in nested.dtype.names
        assert fs.ns.flow_proposal.prime_parameters == ["theta_x", "theta_y", "amp_prime"]
    if example == "discrete":
        np.testing.assert_array_equal(nested["w"], np.round(nested["w"]))
