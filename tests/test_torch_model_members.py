"""The port's ``Model`` members against the JAX package's
(``nessai_tpu/model.py``): the device likelihood's data and callback hooks
(``torch_likelihood_data``, ``likelihood_callback``,
``device_log_likelihood_fn``, ``get_device_log_likelihood``), the data's
per-device cache and its absence from a pickle, a callback model's
populate (the JAX package's ``tests/test_proposal.py:226-259``), and the
members ``allow_vectorised_prior``, ``check_new_point_methods``,
``parameter_in_bounds``, ``sample_parameter`` and ``batch_evaluate_dtype``,
with ``utils.errors.SamplingError``."""

import pickle

import numpy as np
import pytest
import torch

from nessai_tpu import config as jax_config
from nessai_tpu.model import Model as JaxModelBase
from nessai_tpu.model import ModelError as JaxModelError
from nessai_tpu.model import UniformPriorMixin as JaxUniformPriorMixin
from nessai_tpu.proposal import FlowProposal as JaxFlowProposal
from nessai_tpu.utils.errors import SamplingError as JaxSamplingError
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch import config
from nessai_tpu_torch.model import Model, ModelError, UniformPriorMixin
from nessai_tpu_torch.parallel import get_mesh
from nessai_tpu_torch.proposal import FlowProposal
from nessai_tpu_torch.utils.errors import SamplingError
from nessai_tpu_torch.utils.testing import IntegrationTestModel

FLOW = dict(n_blocks=2, n_neurons=4, n_layers=1)
TRAIN = dict(max_epochs=5, batch_size=64, patience=3)


@pytest.fixture(autouse=True)
def _threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


class DataModel(IntegrationTestModel):
    """A Gaussian likelihood centred on ``mu`` from its data; records the
    devices of the rows and of the data it was given."""

    def __init__(self, dims=2, mu=0.5):
        super().__init__(dims)
        self.torch_likelihood_data = {"mu": np.full(dims, mu), "scale": np.float64(1.0)}
        self.seen = []

    def log_likelihood(self, x):
        x = self.unstructured_view(x)
        mu = self.torch_likelihood_data["mu"]
        return -0.5 * np.sum((x - mu) ** 2, axis=-1) - 0.5 * x.shape[-1] * np.log(2 * np.pi)

    def torch_log_likelihood(self, x, data):
        self.seen.append((x.device, {k: (v.device, v.dtype) for k, v in data.items()}))
        d = x - data["mu"][None, :]
        return -0.5 * torch.sum(d * d, dim=-1) / data["scale"] ** 2 - 0.5 * x.shape[-1] * np.log(2 * np.pi)


def _jax_data_model(mu=0.5):
    import jax.numpy as jnp

    class JaxDataModel(JaxModel):
        def __init__(self):
            super().__init__(2)
            self.jax_likelihood_data = {"mu": np.full(2, mu), "scale": np.float64(1.0)}

        def jax_log_likelihood(self, x, data):
            d = x - data["mu"][None, :]
            return -0.5 * jnp.sum(d * d, axis=-1) / data["scale"] ** 2 - np.log(2 * np.pi)

    return JaxDataModel()


def _points(model, n=16, seed=4):
    model.set_rng(np.random.default_rng(seed))
    return model.new_point(n)


# ---------------------------------------------------------------------------
# the device likelihood's hooks
# ---------------------------------------------------------------------------
def test_device_log_likelihood_fn_order_matches_jax():
    """The device hook first, then the callback, else None; data only with
    a data hook."""

    class Callback(IntegrationTestModel):
        torch_log_likelihood = None
        likelihood_callback = True

    class JaxCallback(JaxModel):
        jax_log_likelihood = None
        likelihood_callback = True

    class Neither(IntegrationTestModel):
        torch_log_likelihood = None

    class JaxNeither(JaxModel):
        jax_log_likelihood = None

    pairs = [
        (DataModel(), _jax_data_model()),
        (IntegrationTestModel(2), JaxModel(2)),
        (Callback(2), JaxCallback(2)),
        (Neither(2), JaxNeither(2)),
    ]
    for ours, theirs in pairs:
        ours.device = "cpu"
        a, b = ours.device_log_likelihood_fn(), theirs.device_log_likelihood_fn()
        assert (a is None) == (b is None)
        assert (ours.get_device_log_likelihood() is None) == (theirs.get_device_log_likelihood() is None)
        if a is not None:
            assert (a[1] is None) == (b[1] is None)


@pytest.mark.parametrize("kind", ["data", "plain", "callback"])
def test_device_likelihood_values_match_jax(kind):
    """``fn(x, data)`` of both packages on the same rows, float32, to
    rtol 1e-6; the callback gives float32 host values on the rows' device
    and counts nothing."""
    import jax.numpy as jnp

    if kind == "data":
        ours, theirs = DataModel(), _jax_data_model()
    elif kind == "plain":
        ours, theirs = IntegrationTestModel(2), JaxModel(2)
    else:

        class Callback(IntegrationTestModel):
            torch_log_likelihood = None
            likelihood_callback = True

        class JaxCallback(JaxModel):
            jax_log_likelihood = None
            likelihood_callback = True

        ours, theirs = Callback(2), JaxCallback(2)
    ours.device = "cpu"
    for m in (ours, theirs):
        m.set_rng(np.random.default_rng(0))
    x = np.random.default_rng(2).uniform(-3, 3, (33, 2)).astype(np.float32)
    fn, data = ours.device_log_likelihood_fn("cpu")
    out = fn(torch.as_tensor(x), data)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    if kind == "callback":
        expected = theirs._callback_log_likelihood(x)
        np.testing.assert_array_equal(out.numpy(), expected)
        assert ours._callback_log_likelihood(x).dtype == np.float32
        assert ours.likelihood_evaluations == 0
    else:
        jfn, jdata = theirs.device_log_likelihood_fn()
        expected = np.asarray(jfn(jnp.asarray(x), jdata))
        np.testing.assert_allclose(out.numpy(), expected, rtol=1e-6)
    bound = ours.get_device_log_likelihood("cpu")
    np.testing.assert_array_equal(bound(torch.as_tensor(x)).numpy(), out.numpy())


def test_batch_evaluate_passes_the_data_and_counts():
    model = DataModel()
    model.device = "cpu"
    x = _points(model)
    out = model.batch_evaluate_log_likelihood(x)
    np.testing.assert_allclose(out, model.log_likelihood(x), rtol=1e-5)
    assert model.likelihood_evaluations == len(x)
    device, data = model.seen[-1]
    assert device.type == "cpu"
    assert data == {"mu": (device, torch.float32), "scale": (device, torch.float32)}


# ---------------------------------------------------------------------------
# the data's device cache
# ---------------------------------------------------------------------------
def test_the_data_moves_once_a_device():
    model = DataModel()
    first = model.device_log_likelihood_fn("cpu")[1]
    again = model.device_log_likelihood_fn("cpu")[1]
    assert again is first and again["mu"] is first["mu"]
    assert first["mu"].dtype == torch.float32
    np.testing.assert_array_equal(first["mu"].numpy(), np.float32(model.torch_likelihood_data["mu"]))
    # a second device gets its own copy, the first stays
    meta = model.device_log_likelihood_fn("meta")[1]
    assert meta["mu"].device.type == "meta"
    assert model.device_log_likelihood_fn("cpu")[1] is first
    assert set(model._ll_data_device_cache[1]) == {torch.device("cpu"), torch.device("meta")}


def test_rebinding_the_data_invalidates_the_cache():
    model = DataModel()
    first = model.device_log_likelihood_fn("cpu")[1]
    model.torch_likelihood_data = {"mu": np.full(2, -1.0), "scale": np.float64(2.0)}
    second = model.device_log_likelihood_fn("cpu")[1]
    assert second is not first
    np.testing.assert_array_equal(second["mu"].numpy(), [-1.0, -1.0])
    assert float(second["scale"]) == 2.0
    # mutating the bound dict in place is not a rebinding, as in the JAX package
    model.torch_likelihood_data["mu"] = np.zeros(2)
    assert model.device_log_likelihood_fn("cpu")[1] is second


def test_the_jax_cache_has_the_same_rule():
    theirs = _jax_data_model()
    first = theirs._device_likelihood_data()
    assert theirs._device_likelihood_data() is first
    theirs.jax_likelihood_data = {"mu": np.zeros(2), "scale": np.float64(1.0)}
    assert theirs._device_likelihood_data() is not first


def test_a_pickle_holds_the_numpy_data_and_no_tensor():
    model = DataModel()
    model.device_log_likelihood_fn("cpu")
    assert "_ll_data_device_cache" in model.__dict__
    state = model.__getstate__()
    assert "_ll_data_device_cache" not in state
    restored = pickle.loads(pickle.dumps(model))
    assert "_ll_data_device_cache" not in restored.__dict__
    assert isinstance(restored.torch_likelihood_data["mu"], np.ndarray)
    # rebuilt on first use, with the same values
    data = restored.device_log_likelihood_fn("cpu")[1]
    assert torch.equal(data["mu"], model.device_log_likelihood_fn("cpu")[1]["mu"])


def _proposal(tmp_path, model, name, mesh=None, **kwargs):
    model.set_rng(np.random.default_rng(909))
    model.device = "cpu"
    fp = FlowProposal(
        model,
        output=str(tmp_path / name),
        poolsize=64,
        flow_config=FLOW,
        training_config=TRAIN,
        rng=np.random.default_rng(909),
        plot=False,
        device="cpu",
        mesh=mesh,
        **kwargs,
    )
    fp.initialise()
    x = model.new_point(128)
    x["logL"] = model.batch_evaluate_log_likelihood(x)
    fp.train(x, plot=False)
    return fp, x


def test_each_mesh_shard_gets_the_data_on_its_device(tmp_path):
    """The rounds populate's device call on a two-entry mesh: every shard's
    likelihood sees the data on the shard's device, and the pool's logL
    is the host likelihood's."""
    model = DataModel()
    fp, x = _proposal(tmp_path, model, "mesh", mesh=get_mesh(devices=["cpu"] * 2))
    model.seen.clear()
    fp.populate(x[:1], n_samples=32)
    assert len(model.seen) >= 2
    for device, data in model.seen:
        assert all(d == device and t == torch.float32 for d, t in data.values())
    np.testing.assert_allclose(fp.samples["logL"], model.log_likelihood(fp.samples), rtol=1e-5)


@pytest.mark.parametrize("populate_mode", ["auto", "rounds"])
def test_the_device_loop_and_the_rounds_pass_the_data(tmp_path, populate_mode):
    model = DataModel()
    fp, x = _proposal(tmp_path, model, populate_mode, populate_mode=populate_mode)
    assert fp._use_device_loop() == (populate_mode == "auto")
    model.seen.clear()
    fp.populate(x[:1], n_samples=32)
    assert model.seen
    np.testing.assert_allclose(fp.samples["logL"], model.log_likelihood(fp.samples), rtol=1e-5)


# ---------------------------------------------------------------------------
# a callback model's populate, against the JAX package's
# ---------------------------------------------------------------------------
class CallbackModel(IntegrationTestModel):
    torch_log_likelihood = None
    likelihood_callback = True


class JaxCallbackModel(JaxModel):
    jax_log_likelihood = None
    likelihood_callback = True


def _jax_proposal(tmp_path, model, name, **kwargs):
    model.set_rng(np.random.default_rng(909))
    fp = JaxFlowProposal(
        model,
        output=str(tmp_path / name),
        poolsize=64,
        flow_config=FLOW,
        training_config=TRAIN,
        rng=np.random.default_rng(909),
        plot=False,
        **kwargs,
    )
    fp.initialise()
    x = model.new_point(128)
    x["logL"] = model.batch_evaluate_log_likelihood(x)
    fp.train(x, plot=False)
    return fp, x


@pytest.mark.parametrize("populate_mode", ["auto", "rounds"])
def test_callback_populate_matches_jax(tmp_path, populate_mode):
    """Stored logL equal to a direct evaluation (float32), and the
    likelihood evaluated on the pool alone in both packages: the same
    count on the same pool size."""
    ours, x = _proposal(tmp_path, CallbackModel(2), "t", populate_mode=populate_mode)
    theirs, jx = _jax_proposal(tmp_path, JaxCallbackModel(2), "j", populate_mode=populate_mode)
    assert not ours.model.has_torch_likelihood and not theirs.model.has_jax_likelihood
    assert ours.model.get_device_log_likelihood() is not None
    assert theirs.model.get_device_log_likelihood() is not None
    assert ours._can_fuse_populate and theirs._can_fuse_populate
    counts = []
    for fp, pts in ((ours, x), (theirs, jx)):
        before = fp.model.likelihood_evaluations
        fp.populate(pts[np.argmin(pts["logL"])], n_samples=50)
        counts.append(fp.model.likelihood_evaluations - before)
        np.testing.assert_allclose(fp.samples["logL"], fp.model.log_likelihood(fp.samples), rtol=1e-5, atol=1e-5)
    assert not ours._resolve_fuse_likelihood() and not theirs._resolve_fuse_likelihood()
    assert counts[0] == counts[1] == 50


def test_callback_fused_on_request_evaluates_every_draw(tmp_path):
    """``fuse_likelihood=True`` runs the callback in the rounds populate's
    device call, on every draw that reaches it, as the JAX package
    counts; the stored logL is the host likelihood in float32."""
    ours, x = _proposal(tmp_path, CallbackModel(2), "t", populate_mode="rounds", fuse_likelihood=True)
    theirs, _ = _jax_proposal(tmp_path, JaxCallbackModel(2), "j", populate_mode="rounds", fuse_likelihood=True)
    assert ours._resolve_fuse_likelihood() and theirs._resolve_fuse_likelihood()
    before = ours.model.likelihood_evaluations
    ours.populate(x[np.argmin(x["logL"])], n_samples=50)
    assert ours.model.likelihood_evaluations - before > 50
    np.testing.assert_array_equal(
        ours.samples["logL"], ours.model.log_likelihood(ours.samples).astype(np.float32).astype(np.float64)
    )


def test_callback_on_a_mesh_stays_on_the_host(tmp_path):
    """On a mesh the callback never runs inside the sharded call, even
    when fusing is asked for (``flowproposal.py:420-430``)."""
    ours, x = _proposal(
        tmp_path, CallbackModel(2), "m", mesh=get_mesh(devices=["cpu"] * 2), fuse_likelihood=True
    )
    assert not ours._resolve_fuse_likelihood()
    before = ours.model.likelihood_evaluations
    ours.populate(x[np.argmin(x["logL"])], n_samples=50)
    assert ours.model.likelihood_evaluations - before == 50


# ---------------------------------------------------------------------------
# the other members
# ---------------------------------------------------------------------------
def _both(allow=True):
    class Ours(IntegrationTestModel):
        allow_vectorised_prior = allow

    class Theirs(JaxModel):
        allow_vectorised_prior = allow

    out = []
    for cls in (Ours, Theirs):
        m = cls(2)
        m.set_rng(np.random.default_rng(5))
        out.append(m)
    return out


@pytest.mark.parametrize("allow", [True, False])
def test_allow_vectorised_prior_matches_jax(allow):
    ours, theirs = _both(allow)
    assert Model.allow_vectorised_prior is JaxModelBase.allow_vectorised_prior is True
    assert ours.vectorised_prior == theirs.vectorised_prior == allow
    assert ours.vectorised_prior_unit_hypercube == theirs.vectorised_prior_unit_hypercube == allow
    x = ours.new_point(10)
    np.testing.assert_array_equal(ours.batch_evaluate_log_prior(x), theirs.batch_evaluate_log_prior(x))


def test_vectorised_flags_can_be_set_as_in_jax():
    ours, theirs = _both()
    for m in (ours, theirs):
        m.vectorised_likelihood = False
        m.vectorised_prior = False
        m.vectorised_prior_unit_hypercube = False
        assert not (m.vectorised_likelihood or m.vectorised_prior or m.vectorised_prior_unit_hypercube)


@pytest.mark.parametrize("redefined", ["new_point", "new_point_log_prob", "both", "neither"])
def test_check_new_point_methods_matches_jax(redefined):
    def make(base, err):
        body = {}
        if redefined in ("new_point", "both"):
            body["new_point"] = lambda self, N=1: base.new_point(self, N)
        if redefined in ("new_point_log_prob", "both"):
            body["new_point_log_prob"] = lambda self, x: np.zeros(x.size)
        return type("M", (base,), body), err

    for cls, err in (make(IntegrationTestModel, ModelError), make(JaxModel, JaxModelError)):
        model = cls(2)
        model.set_rng(np.random.default_rng(1))
        if redefined in ("new_point", "new_point_log_prob"):
            with pytest.raises(err, match="has been redefined but"):
                cls.check_new_point_methods()
            with pytest.raises(err, match="has been redefined but"):
                model.verify_model()
        else:
            cls.check_new_point_methods()
            model.verify_model()


def test_parameter_in_bounds_matches_jax():
    ours, theirs = _both()
    v = np.array([-11.0, -10.0, 0.0, 10.0, 10.5, np.nan])
    np.testing.assert_array_equal(ours.parameter_in_bounds(v, "x_0"), theirs.parameter_in_bounds(v, "x_0"))
    np.testing.assert_array_equal(ours.parameter_in_bounds(v, "x_0"), [False, True, True, True, False, False])


def test_sample_parameter_matches_jax():
    ours, theirs = _both()
    for m in (ours, theirs):
        with pytest.raises(NotImplementedError, match="User must implement"):
            m.sample_parameter("x_0")

    class Ours(UniformPriorMixin, Model):
        def __init__(self):
            self.names = ["a", "b"]
            self.bounds = {"a": [-1.0, 3.0], "b": [0.0, 1.0]}

        def log_likelihood(self, x):
            return np.zeros(len(np.atleast_1d(x)))

    class Theirs(JaxUniformPriorMixin, JaxModelBase):
        __init__ = Ours.__init__
        log_likelihood = Ours.log_likelihood

    draws = []
    for cls in (Ours, Theirs):
        m = cls()
        m.set_rng(np.random.default_rng(17))
        draws.append((m.sample_parameter("a", 5), m.sample_parameter("b"), m.sample_parameter("a", n=2.0)))
    for a, b in zip(*draws):
        np.testing.assert_array_equal(a, b)
    assert draws[0][0].shape == (5,) and draws[0][1].shape == (1,)
    assert np.all((draws[0][0] >= -1.0) & (draws[0][0] <= 3.0))


def test_batch_evaluate_dtype_matches_jax():
    """The live points' float dtype in both packages; restored after (the
    configs' ``reset`` leaves it as it is)."""
    ours, theirs = _both()
    assert ours.batch_evaluate_dtype() == theirs.batch_evaluate_dtype() == "f8"
    saved = config.livepoints.default_float_dtype, jax_config.livepoints.default_float_dtype
    config.livepoints.default_float_dtype = jax_config.livepoints.default_float_dtype = "f4"
    try:
        assert ours.batch_evaluate_dtype() == theirs.batch_evaluate_dtype() == "f4"
    finally:
        config.livepoints.default_float_dtype, jax_config.livepoints.default_float_dtype = saved
        jax_config.livepoints.reset_properties()


def test_sampling_error_matches_jax():
    assert issubclass(SamplingError, RuntimeError) and issubclass(JaxSamplingError, RuntimeError)
    assert SamplingError.__doc__ == JaxSamplingError.__doc__
    with pytest.raises(SamplingError, match="stuck"):
        raise SamplingError("stuck")


# ---------------------------------------------------------------------------
# a checkpoint of a run with likelihood data
# ---------------------------------------------------------------------------
def test_a_gw_checkpoint_holds_no_data_tensor_and_resumes_bit_for_bit(tmp_path):
    """The basic GW example's run, checkpointed after each training: the
    sampler's pickle reaches no model and no tensor of the data (the model
    is given again at resume, with its numpy data); a resume from the
    last checkpoint before the end restores the iteration, the live points
    and the nested samples bit for bit, rebuilds the data's tensors on
    first use and runs on."""
    from nessai_tpu_torch.examples.gw.basic_gw_example import SAMPLER_KWARGS, BasicGWModel
    from nessai_tpu_torch.flowsampler import FlowSampler
    from nessai_tpu_torch.utils.testing import pickled_types

    records = []
    kwargs = dict(
        nlive=150,
        seed=4,
        max_iteration=400,
        maximum_uninformed=80,
        poolsize=150,
        flow_config=dict(n_blocks=2, n_neurons=8, n_layers=1),
        training_config=dict(max_epochs=10, batch_size=128, patience=5),
        reparameterisations=SAMPLER_KWARGS["reparameterisations"],
        plot=False,
        device="cpu",
        signal_handling=False,
    )

    def record(sampler):
        records.append(
            (
                pickle.dumps(sampler),
                sampler.iteration,
                sampler.live_points.tobytes(),
                np.asarray(sampler.nested_samples_array).tobytes(),
            )
        )

    model = BasicGWModel()
    fs = FlowSampler(model, output=str(tmp_path / "a"), resume=False, checkpoint_on_training=True,
                     checkpoint_callback=record, **kwargs)
    fs.run(plot=False, save=False)
    assert "_ll_data_device_cache" in model.__dict__ and len(records) >= 2
    data, iteration, live, nested = [r for r in records if r[1] < fs.ns.iteration][-1]
    reached = pickled_types(pickle.loads(data))
    assert not [o for o in reached if isinstance(o, Model)]
    assert not [o for o in reached if isinstance(o, torch.Tensor) and o.dtype == torch.float32]
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "nested_sampler_resume.pkl").write_bytes(data)
    resumed_model = BasicGWModel()
    fs2 = FlowSampler(resumed_model, output=str(tmp_path / "b"), resume=True, **kwargs)
    ns = fs2.ns
    assert ns.iteration == iteration
    assert ns.live_points.tobytes() == live
    assert np.asarray(ns.nested_samples_array).tobytes() == nested
    assert ns.model is resumed_model and "_ll_data_device_cache" not in resumed_model.__dict__
    fs2.run(plot=False, save=False)
    assert np.isfinite(fs2.logZ) and fs2.ns.iteration > iteration
    assert "_ll_data_device_cache" in resumed_model.__dict__
