"""The port's helper modules and the public names the port adds so that
every name the JAX package exports has a counterpart, each against the
JAX function: ``utils/distance``, ``utils/distributions``,
``flowmodel/utils``, ``config.compute``, the live-point conversions, the
``utils`` re-exports, ``utils/sampling.draw_*``, ``rolling_mean``,
``bonferroni_correction``, ``flows.reset_weights`` and
``reset_permutations``, ``get_activation_function``, ``Bijector``,
``samplers/ns_device.scan_consume`` and the profiler's ``profile_region``
and ``annotate``.

Tolerances: numpy helpers bit for bit (the same numpy calls on the same
generator states); log-densities in float32 to 1e-6; the scan bit for
bit.
"""

import copy
import dataclasses
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import nessai_tpu.livepoint as jax_livepoint
import nessai_tpu.utils as jax_utils
from nessai_tpu import config as jax_config
from nessai_tpu.flowmodel.utils import update_config as jax_update_config
from nessai_tpu.samplers.ns_device import scan_consume as jax_scan_consume
from nessai_tpu.utils import distance as jax_distance
from nessai_tpu.utils import distributions as jax_distributions
from nessai_tpu.utils import indices as jax_indices
from nessai_tpu.utils import sampling as jax_sampling
from nessai_tpu.utils import stats as jax_stats
from nessai_tpu_torch import config, livepoint
from nessai_tpu_torch import utils as port_utils
from nessai_tpu_torch.flowmodel import FlowModel
from nessai_tpu_torch.flowmodel.utils import update_config
from nessai_tpu_torch.utils import distributions, indices, profiling, sampling, stats
from nessai_tpu_torch.utils.distance import compute_minimum_distances


@pytest.fixture(autouse=True)
def _same_live_point_fields():
    """Both packages' live points without extra fields; restored after."""
    saved = [copy.deepcopy(c.livepoints.__dict__) for c in (config, jax_config)]
    for c in (config, jax_config):
        c.livepoints.reset()
    yield
    for c, state in zip((config, jax_config), saved):
        c.livepoints.__dict__.update(state)


@pytest.mark.parametrize("metric", ["euclidean", "cityblock"])
def test_compute_minimum_distances_matches_jax(metric):
    x = np.random.default_rng(0).normal(size=(40, 3))
    np.testing.assert_array_equal(
        compute_minimum_distances(x, metric), jax_distance.compute_minimum_distances(x, metric)
    )


def test_adaptive_noise_takes_compute_minimum_distances(tmp_path):
    """``FlowModel._noise_sigma`` with adaptive noise is ``noise_scale``
    times each training row's distance to its nearest other row, bit for
    bit the helper's."""
    fm = FlowModel(
        dict(n_inputs=2, n_blocks=1, n_neurons=4, n_layers=1),
        dict(noise_type="adaptive", noise_scale=0.3),
        output=str(tmp_path),
        rng=np.random.default_rng(1),
        device="cpu",
    )
    x = np.random.default_rng(2).normal(size=(50, 2)).astype(np.float32)
    batches = list(torch.split(torch.as_tensor(x), 16))
    sigma = torch.cat(fm._noise_sigma(batches))[:, 0]
    expected = torch.as_tensor((0.3 * compute_minimum_distances(x)).astype(np.float32))
    assert torch.equal(sigma, expected)


@pytest.mark.parametrize("cls, arg", [("BoxUniform", 1.5), ("DiagonalNormal", 2.0)])
def test_distributions_log_prob_match_jax(cls, arg):
    z = np.random.default_rng(3).uniform(-2.0, 2.0, (64, 3)).astype(np.float32)
    ours = getattr(distributions, cls)(3, arg).log_prob(torch.as_tensor(z)).numpy()
    theirs = np.asarray(getattr(jax_distributions, cls)(3, arg).log_prob(jnp.asarray(z)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)
    assert np.isneginf(ours).any() == (cls == "BoxUniform")


def test_distribution_getters_and_samplers():
    box = distributions.get_uniform_distribution(2, 0.5)
    normal = distributions.get_multivariate_normal(2, var=4.0)
    assert isinstance(box, distributions.BoxUniform) and box.r == 0.5
    assert isinstance(normal, distributions.DiagonalNormal) and normal.var == 4.0
    for dist in (box, normal):
        a = dist.sample(torch.Generator().manual_seed(4), 2000)
        b = dist.sample(torch.Generator().manual_seed(4), 2000)
        assert a.shape == (2000, 2) and torch.equal(a, b)
        assert torch.isfinite(dist.log_prob(a)).all()
    assert box.sample(torch.Generator().manual_seed(5), 500).abs().max() <= 0.5
    assert abs(float(normal.sample(torch.Generator().manual_seed(6), 20000).std()) - 2.0) < 0.05
    # the JAX samplers draw from a key, ours from a generator: the same law
    j = np.asarray(jax_distributions.DiagonalNormal(2, 4.0).sample(jax.random.PRNGKey(0), 20000))
    assert abs(j.std() - 2.0) < 0.05


@pytest.mark.parametrize(
    "d",
    [
        None,
        dict(n_blocks=3, lr=1e-2, max_epochs=7),
        dict(model_config=dict(n_blocks=5, n_neurons=8), batch_size=50, patience=3),
    ],
)
def test_update_config_matches_jax(d):
    ours = update_config(copy.deepcopy(d))
    theirs = jax_update_config(copy.deepcopy(d))
    for a, b in zip(ours, theirs):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        for key in set(a) & set(b):
            assert a[key] == b[key], key


def test_compute_config_matches_jax():
    assert config.compute.data_axis == jax_config.compute.data_axis == "data"
    assert config.compute.default_dtype == jax_config.compute.default_dtype == "float32"


def test_live_point_conversions_match_jax():
    names = ["x", "y"]
    for nsp in (True, False):
        ours = livepoint.parameters_to_live_point([1.0, 2.0], names, non_sampling_parameters=nsp)
        theirs = jax_livepoint.parameters_to_live_point([1.0, 2.0], names, non_sampling_parameters=nsp)
        assert ours.dtype == theirs.dtype and ours.tobytes() == theirs.tobytes()
    assert livepoint.parameters_to_live_point([], names).size == 0
    d = {"x": np.arange(4.0), "y": -np.arange(4.0), "logL": np.ones(4)}
    for nsp in (True, False):
        ours = livepoint.dict_to_live_points(d, non_sampling_parameters=nsp)
        theirs = jax_livepoint.dict_to_live_points(d, non_sampling_parameters=nsp)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours.tobytes(), theirs.tobytes())
    df = pd.DataFrame(d)
    ours = livepoint.dataframe_to_live_points(df)
    theirs = jax_livepoint.dataframe_to_live_points(df)
    assert ours.dtype == theirs.dtype and ours.tobytes() == theirs.tobytes()


def test_utils_re_exports_every_name_of_the_jax_utils():
    assert set(jax_utils.__all__) <= set(port_utils.__all__)
    for name in port_utils.__all__:
        assert callable(getattr(port_utils, name)), name
    assert port_utils.rolling_mean is stats.rolling_mean
    assert port_utils.bonferroni_correction is indices.bonferroni_correction
    assert port_utils.draw_nsphere is sampling.draw_nsphere


@pytest.mark.parametrize(
    "name, kwargs",
    [
        ("draw_nsphere", dict(dims=3, r=2.0, N=50, fuzz=1.5)),
        ("draw_uniform", dict(dims=2, N=30)),
        ("draw_gaussian", dict(dims=4, N=20, temperature=2.0)),
        ("draw_truncated_gaussian", dict(dims=3, r=1.2, N=40, fuzz=1.1, var=2.0)),
    ],
)
def test_draws_match_jax(name, kwargs):
    ours = getattr(sampling, name)(rng=np.random.default_rng(7), **kwargs)
    theirs = getattr(jax_sampling, name)(rng=np.random.default_rng(7), **kwargs)
    np.testing.assert_array_equal(ours, theirs)
    assert inspect.signature(getattr(sampling, name)) == inspect.signature(getattr(jax_sampling, name))


@pytest.mark.parametrize("N", [1, 4, 10])
def test_rolling_mean_matches_jax(N):
    x = np.random.default_rng(8).normal(size=37)
    np.testing.assert_array_equal(stats.rolling_mean(x, N), jax_stats.rolling_mean(x, N))
    assert stats.rolling_mean(x, N).shape == x.shape


def test_bonferroni_correction_matches_jax():
    p = np.array([0.001, 0.01, 0.02, 0.2, 0.9])
    for alpha in (0.05, 0.1):
        for a, b in zip(indices.bonferroni_correction(p, alpha), jax_indices.bonferroni_correction(p, alpha)):
            np.testing.assert_array_equal(a, b)


def test_flow_helpers_are_exported():
    from nessai_tpu_torch import flows
    from nessai_tpu_torch.flows import bijectors, nets
    from nessai_tpu_torch.flows import utils as flow_utils

    assert flows.reset_weights is flow_utils.reset_weights
    assert flows.reset_permutations is flow_utils.reset_permutations
    assert flow_utils.get_activation_function("tanh") is nets.ACTIVATIONS["tanh"]
    with pytest.raises(ValueError, match="Unknown activation"):
        flow_utils.get_activation_function("nope")
    for name in bijectors.__all__:
        assert issubclass(getattr(bijectors, name), bijectors.Bijector), name
    flow = flows.configure_model(dict(n_inputs=2, n_blocks=2, n_neurons=4, n_layers=1, seed=0))
    assert all(isinstance(b, flows.Bijector) for b in flow.bijector.bijectors)


def test_scan_consume_matches_jax():
    rng = np.random.default_rng(9)
    live = np.sort(rng.normal(size=40)).astype(np.float32)
    pool = (rng.normal(size=64) * 2.0 + live[8]).astype(np.float32)
    from nessai_tpu_torch.samplers.ns_device import scan_consume

    ours = scan_consume(torch.from_numpy(live), torch.from_numpy(pool), 2**31 - 1)
    theirs = jax.jit(jax_scan_consume)(jnp.asarray(live), jnp.asarray(pool), jnp.int32(2**31 - 1))
    for a, b in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_profile_region_and_annotate(tmp_path):
    logdir = tmp_path / "profile"
    # a span reaches the profiler's timeline while tracing is on
    with profiling.tracing(), profiling.profile_region(str(logdir)):
        with profiling.annotate("region_under_test"):
            torch.ones(8).sum()
    trace = json.loads((logdir / "trace.json").read_text())
    assert any(e.get("name") == "region_under_test" for e in trace["traceEvents"])
    with profiling.profile_region(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
