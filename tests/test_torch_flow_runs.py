"""Whole standard-sampler runs with the flows that the flagships do not
build (MAF, LU and SVD linear layers, a LARS base, a scaled Gaussian
base), in both packages on the CPU: each within 3 sigma of the analytic
evidence and of the other. And the populate's latent draws: the
truncated Gaussian for a unit-Gaussian base, the base's own draws (cut
at the latent radius) for any other, as the JAX package's device
populate loop draws them."""

import numpy as np
import pytest
import torch

from nessai_tpu.flowsampler import FlowSampler as JaxFlowSampler
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch.flows import distributions
from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.utils.testing import IntegrationTestModel

FLOWS = {
    "maf": dict(ftype="maf"),
    "realnvp_lu": dict(linear_transform="lu"),
    "nsf_svd": dict(ftype="nsf", linear_transform="svd"),
    "realnvp_lars": dict(distribution="lars", distribution_kwargs=dict(n_neurons=8)),
    "realnvp_mvn": dict(distribution="mvn", distribution_kwargs=dict(var=1.5)),
}


def _kwargs(flow):
    return dict(
        nlive=200,
        seed=1234,
        plot=False,
        checkpointing=False,
        flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1, **flow),
        training_config=dict(max_epochs=20, patience=10, batch_size=200),
        poolsize=200,
    )


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_run_agrees_with_jax(name, tmp_path):
    torch.set_float32_matmul_precision("highest")
    kwargs = _kwargs(FLOWS[name])
    model = IntegrationTestModel(2)
    tfs = FlowSampler(model, output=str(tmp_path / "torch"), device="cpu", **kwargs)
    t_logz, nested = tfs.run(plot=False, save=False)
    jfs = JaxFlowSampler(JaxModel(2), output=str(tmp_path / "jax"), resume=False, **kwargs)
    j_logz, _ = jfs.run(plot=False, save=False)
    t_err, j_err = tfs.logZ_error, jfs.logZ_error
    analytic = model.analytic_log_evidence
    assert abs(t_logz - analytic) < 3 * t_err
    assert abs(j_logz - analytic) < 3 * j_err
    assert abs(t_logz - j_logz) < 3 * np.hypot(t_err, j_err)
    assert tfs.ns.train_count > 0 and len(nested) == tfs.ns.iteration + 200
    flow = tfs.ns.flow_proposal.flow.flow
    assert type(flow.base).__name__ == type(jfs.ns.flow_proposal.flow.flow.base).__name__


@pytest.mark.parametrize("name", ["realnvp_lars", "realnvp_mvn", None])
def test_populate_draws_from_the_base(name, tmp_path, monkeypatch):
    """A unit-Gaussian base takes the host's truncated Gaussian; any other
    base is sampled on the device, from the flow model's generator."""
    calls = []
    for cls in (distributions.StandardNormal, distributions.MultivariateNormal, distributions.ResampledGaussian):
        sample = cls.sample

        def recording(self, n, generator=None, _sample=sample):
            calls.append((type(self).__name__, generator is not None))
            return _sample(self, n, generator)

        monkeypatch.setattr(cls, "sample", recording)
    kwargs = _kwargs(FLOWS[name] if name else {})
    fs = FlowSampler(IntegrationTestModel(2), output=str(tmp_path), device="cpu", **kwargs)
    proposal = fs.ns.flow_proposal
    proposal.initialise()
    x = np.random.default_rng(0).normal(size=(300, 2))
    live = np.zeros(300, dtype=[("x_0", "f8"), ("x_1", "f8"), ("logP", "f8"), ("logL", "f8"), ("it", "i4")])
    live["x_0"], live["x_1"] = x[:, 0], x[:, 1]
    live["logL"] = fs.ns.model.log_likelihood(live)
    proposal.train(live, plot=False)
    rule = proposal.get_truncation_rule("latent_radius")
    truncated = rule.sample_latent
    host = []

    def host_draws(p, n):
        z = truncated(p, n)
        if z is not None:
            host.append(n)
        return z

    rule.sample_latent = host_draws
    proposal.populate(live[np.argmin(live["logL"])], n_samples=100)
    assert len(proposal.samples) == 100
    if name is None:
        assert host and not calls
    else:
        assert not host and calls and all(with_generator for _, with_generator in calls)
        assert proposal.flow._device_generator is not None
