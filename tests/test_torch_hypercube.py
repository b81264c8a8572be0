"""Flows on the unit hypercube through the importance nested sampler:
the port's run of the configuration of
``examples/importance_nested_sampler/nsf_unit_hypercube.py`` (a neural
spline flow with ``tails=None`` on a uniform base, no logit map), its
model and log-evidence, and the documented LU configuration
(``docs/normalising-flows-configuration.md``), against the JAX
package's. Tolerances: a level's log-density atol 1e-4 + rtol 1e-5 (a
float32 chain in both packages); the model's host functions 1e-12, its
device likelihood 1e-5 of 1 + |logL| (float32)."""

import ast
import importlib.util
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import integrate

from nessai_tpu.flows.utils import configure_model as jax_configure_model
from nessai_tpu.livepoint import numpy_array_to_live_points as jax_live_points
from nessai_tpu_torch import config
from nessai_tpu_torch.flowmodel import ImportanceFlowModel
from nessai_tpu_torch.flows import params_to_jax
from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.livepoint import numpy_array_to_live_points
from nessai_tpu_torch.utils.profiling import FLAGSHIP_INS_HYPERCUBE, FLAGSHIP_LU
from nessai_tpu_torch.utils.testing import IntegrationTestModel, RosenbrockModel, rosenbrock_log_evidence

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "examples" / "importance_nested_sampler" / "nsf_unit_hypercube.py"


@pytest.fixture(autouse=True)
def _highest_precision_and_clean_fields():
    torch.set_float32_matmul_precision("highest")
    yield
    config.livepoints.reset()


def _example_module():
    spec = importlib.util.spec_from_file_location("nsf_unit_hypercube_example", EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _example_sampler_kwargs():
    """The keyword arguments of the example's ``FlowSampler`` call, as
    literals (the model and the names it refers to as their source)."""
    tree = ast.parse(EXAMPLE.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "FlowSampler":
            out = {}
            for kw in node.keywords:
                try:
                    out[kw.arg] = ast.literal_eval(kw.value)
                except ValueError:
                    out[kw.arg] = ast.unparse(kw.value)
            return ast.unparse(node.args[0]), out
    raise AssertionError("no FlowSampler call in the example")


def test_flagship_ins_hypercube_is_the_example():
    model, kwargs = _example_sampler_kwargs()
    assert model == "RosenbrockModel(4)"
    ours = dict(FLAGSHIP_INS_HYPERCUBE)
    # the port's runs write no plots and no checkpoints (the card's
    # machine has no matplotlib); the example writes to its own output
    assert ours.pop("plot") is False and ours.pop("checkpointing") is False
    assert kwargs.pop("output") == "output"
    assert kwargs.pop("flow_config") == "flow_config"
    flow_config = ours.pop("flow_config")
    assert ours == kwargs
    assert flow_config == _example_module().flow_config


def test_flagship_lu_is_the_documented_example():
    """The documented code block, run with a stand-in ``FlowSampler``."""
    text = (ROOT / "docs" / "normalising-flows-configuration.md").read_text()
    block = re.search(r"## Example\s+```python\n(.*?)```", text, re.S).group(1)
    seen = {}
    exec(block, {"FlowSampler": lambda model, **kw: seen.update(kw), "model": None})
    assert FLAGSHIP_LU["flow_config"] == seen["flow_config"]
    assert FLAGSHIP_LU["training_config"] == seen["training_config"]
    assert FLAGSHIP_LU["nlive"] == 1000 and FLAGSHIP_LU["seed"] == 1234


def test_rosenbrock_model_is_the_examples():
    """Likelihood, prior and unit-hypercube maps equal the example
    model's on the same points (1e-12); the device likelihood the host's
    in float32 (1e-5 of 1 + |logL|)."""
    theirs = _example_module().RosenbrockModel(4)
    ours = RosenbrockModel(4)
    assert ours.names == theirs.names
    for n in ours.names:
        np.testing.assert_array_equal(ours.bounds[n], theirs.bounds[n])
    x = np.random.default_rng(0).uniform(-6.0, 6.0, (500, 4))
    a, b = numpy_array_to_live_points(x, ours.names), jax_live_points(x, theirs.names)
    np.testing.assert_allclose(ours.log_likelihood(a), theirs.log_likelihood(b), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ours.log_prior(a), theirs.log_prior(b))
    for f in ("to_unit_hypercube", "from_unit_hypercube"):
        ua, ub = getattr(ours, f)(a), getattr(theirs, f)(b)
        for n in ours.names:
            np.testing.assert_allclose(ua[n], ub[n], rtol=1e-12, atol=1e-12)
    device = ours.torch_log_likelihood(torch.as_tensor(x, dtype=torch.float32)).double().numpy()
    host = ours.log_likelihood(numpy_array_to_live_points(x.astype(np.float32).astype(np.float64), ours.names))
    assert np.all(np.abs(device - host) <= 1e-5 * (1 + np.abs(host)))


def test_rosenbrock_log_evidence():
    """The quadrature: -15.1016907 in 4 dimensions at any grid from 4001
    points; in 2 dimensions, the adaptive double integral's value."""
    assert math.isclose(rosenbrock_log_evidence(4), -15.1016907, abs_tol=1e-6)
    assert math.isclose(rosenbrock_log_evidence(4, n=2001), rosenbrock_log_evidence(4), abs_tol=1e-5)
    two, _ = integrate.dblquad(
        lambda y, x: math.exp(-100.0 * (y - x * x) ** 2 - (1.0 - x) ** 2), -5, 5, -5, 5, epsabs=1e-13, epsrel=1e-11
    )
    assert math.isclose(rosenbrock_log_evidence(2), math.log(two) - 2 * math.log(10.0), abs_tol=1e-7)
    assert RosenbrockModel(2).analytic_log_evidence == rosenbrock_log_evidence(2)


#: the example's flow, at a smaller width for the CPU
SMALL_HYPERCUBE_FLOW = dict(FLAGSHIP_INS_HYPERCUBE["flow_config"], n_neurons=8)


def test_hypercube_ins_on_the_integration_model(tmp_path):
    """The example's sampler configuration with a narrower flow on the
    2-D unit Gaussian: |pull| < 3 with the sampler's error, samples in
    the prior box, and the first level's flow on its weights converted to
    the JAX package gives the JAX package's log-density on the run's
    unit-hypercube samples."""
    model = IntegrationTestModel(2)
    cfg = dict(FLAGSHIP_INS_HYPERCUBE, nlive=500, flow_config=SMALL_HYPERCUBE_FLOW)
    fs = FlowSampler(model, output=str(tmp_path), device="cpu", **cfg)
    fs.run(plot=False, save=False)
    pull = (fs.logZ - model.analytic_log_evidence) / fs.logZ_error
    assert abs(pull) < 3, pull
    samples = fs.nested_samples
    for n in model.names:
        assert np.all((samples[n] >= -10) & (samples[n] <= 10))
    flows = fs.ns.proposal.flow
    x = np.stack([fs.ns.samples_unit[n] for n in model.names], axis=1)
    assert np.all((x >= 0) & (x <= 1))
    jflow, _, _ = jax_configure_model(dict(SMALL_HYPERCUBE_FLOW, n_inputs=2))
    for i in (0, flows.n_models - 1):
        params = jax.tree.map(np.asarray, params_to_jax(flows.models[i]))
        theirs = np.asarray(jflow.log_prob(params, jnp.asarray(x, dtype=jnp.float32)))
        ours = flows.log_prob_ith(x, i)
        assert np.all(np.isfinite(ours)) and np.all(np.isfinite(theirs))
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-5)


def test_level_draws_come_from_the_level_base(tmp_path):
    """A level's draws: for a uniform base, points of the unit box with
    their log-density; for the unit Gaussian, one ``torch.randn`` on the
    sampling generator (the bits the importance sampler's pins rest on)."""
    fm = ImportanceFlowModel(dict(SMALL_HYPERCUBE_FLOW, n_inputs=3), output=str(tmp_path / "u"),
                             rng=np.random.default_rng(0), device="cpu")
    fm.initialise()
    fm.add_new_flow(reset=True)
    with torch.no_grad():
        for p in fm.flow.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    fm.add_level(fm.flow)
    x, log_q = fm.sample_and_log_prob_ith(0, 400)
    assert x.shape == (400, 3) and np.all((x >= 0) & (x <= 1))
    np.testing.assert_allclose(log_q, fm.log_prob_ith(x, 0), atol=1e-4, rtol=1e-4)
    fm = ImportanceFlowModel(dict(n_inputs=2, n_blocks=2, n_neurons=4), output=str(tmp_path / "n"),
                             rng=np.random.default_rng(0), device="cpu")
    fm.initialise()
    fm.add_new_flow(reset=True)
    fm.add_level(fm.flow)
    state = fm._sample_generator.get_state()
    x, _ = fm.sample_and_log_prob_ith(0, 50)
    gen = torch.Generator()
    gen.set_state(state)
    z = torch.randn(50, 2, generator=gen)
    with torch.no_grad():
        expected = fm.models[0].inverse(z)[0].double().numpy()
    np.testing.assert_array_equal(x, expected)
