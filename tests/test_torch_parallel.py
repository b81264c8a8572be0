"""The port's device mesh (``nessai_tpu_torch/parallel``) against the JAX
package's (``tests/test_parallel.py``), on a virtual mesh of eight
``"cpu"`` entries beside the JAX tests' eight virtual CPU devices
(``tests/conftest.py``).

Tolerances: host functions (padding, sharded evaluation of a numpy
function) are exact or 1e-6 in float32; the data-parallel loss to 1e-6
relative of the single-device loss and 1e-5 of the JAX package's at the
same converted weights; one Adam step (lr 1e-3) to 1e-6 of the
single-device step and 1e-5 of the JAX step in every parameter; epoch
losses of a mesh run to 1e-5 relative of the single-device run's; sharded
inference to 1e-5 of the single-device model and of the JAX package's;
the sharded populate to 1e-5 of the single-device populate. The shards'
sums and the replicas' summed gradients round otherwise than one pass
over the batch (within 1e-7 on these inputs).
"""

import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nessai_tpu.flowmodel import FlowModel as JaxFlowModel
from nessai_tpu.flowmodel.base import _partition_params
from nessai_tpu.parallel import get_mesh as jax_get_mesh
from nessai_tpu.parallel import make_dp_train_step as jax_make_dp_train_step
from nessai_tpu.parallel import pad_to_multiple as jax_pad_to_multiple
from nessai_tpu.parallel import replicated_sharding as jax_replicated
from nessai_tpu.parallel import shard_batch as jax_shard_batch
from nessai_tpu.parallel import sharded_batch_evaluate as jax_sharded_batch_evaluate
from nessai_tpu_torch import config
from nessai_tpu_torch.flowmodel import FlowModel, ImportanceFlowModel
from nessai_tpu_torch.flows import params_from_jax, params_to_jax
from nessai_tpu_torch.parallel import (
    Mesh,
    data_sharding,
    get_mesh,
    make_dp_train_step,
    pad_to_multiple,
    replicated_sharding,
    shard_batch,
    sharded_batch_evaluate,
)
from nessai_tpu_torch.utils.testing import IntegrationTestModel

FLOW_CONFIG = dict(n_inputs=2, n_blocks=2, n_neurons=4, n_layers=1)
LOSS_RTOL = 1e-6
JAX_RTOL = 1e-5
STEP_ATOL = 1e-6
JAX_STEP_ATOL = 1e-5
INFERENCE_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")


@pytest.fixture(autouse=True)
def _threads():
    """Two intra-op threads: the mesh's eight shards run one after
    another, and the sampler runs contend for the cores with the other
    test processes otherwise."""
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(autouse=True)
def _no_extra_live_point_fields():
    """The standard sampler's fields without the extra live-point fields
    an importance nested sampler run earlier in the process registers;
    restored after."""
    saved = copy.deepcopy(config.livepoints.__dict__)
    config.livepoints.reset()
    yield
    config.livepoints.__dict__.update(saved)


@pytest.fixture()
def mesh():
    return get_mesh(devices=["cpu"] * 8)


@pytest.fixture()
def jax_mesh():
    cpus = jax.devices("cpu")
    if len(cpus) < 8:
        pytest.skip("needs the 8 virtual cpu devices of tests/conftest.py")
    return jax_get_mesh(devices=cpus, n_devices=8)


def _half_square(a):
    return -0.5 * (a**2).sum(-1)


# ---------------------------------------------------------------------
# the mesh, padding and sharded evaluation
# ---------------------------------------------------------------------
def test_get_mesh_names_repeated_devices_and_the_data_axis():
    mesh = get_mesh(devices=["cpu"] * 8, n_devices=3)
    assert isinstance(mesh, Mesh)
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.size == len(mesh) == 3
    assert mesh.axis_names == (config.compute.data_axis,) == ("data",)
    assert get_mesh(devices=["cpu"], axis_name="batch").axis_name == "batch"
    with pytest.raises(ValueError, match="at least one device"):
        get_mesh(devices=[])


def test_a_mesh_that_names_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("there is a GPU")
    with pytest.raises(RuntimeError, match="no GPU"):
        get_mesh()
    with pytest.raises(RuntimeError, match="no GPU"):
        get_mesh(devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        get_mesh(devices=["meta"])


@pytest.mark.parametrize("n", range(1, 21))
def test_pad_to_multiple_matches_jax(n):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    padded, n_valid = pad_to_multiple(x, 8)
    theirs, n_theirs = jax_pad_to_multiple(x, 8)
    assert n_valid == n_theirs == n
    np.testing.assert_array_equal(padded, theirs)
    assert len(padded) % 8 == 0 and len(padded) >= n


def test_pad_to_multiple_empty_raises():
    for pad in (pad_to_multiple, jax_pad_to_multiple):
        with pytest.raises(ValueError, match="empty"):
            pad(np.zeros((0, 2), np.float32), 8)


@pytest.mark.parametrize("n", [1, 3, 101])
def test_sharded_batch_evaluate_matches_jax(mesh, jax_mesh, n):
    x = np.random.default_rng(n).normal(size=(n, 4)).astype(np.float32)
    ours = sharded_batch_evaluate(_half_square, x, mesh)
    theirs = jax_sharded_batch_evaluate(lambda a: -0.5 * jnp.sum(a**2, axis=-1), x, jax_mesh)
    assert ours.shape == theirs.shape == (n,) and ours.dtype == np.float64
    np.testing.assert_allclose(ours, np.asarray(theirs, np.float64), rtol=1e-6)
    np.testing.assert_allclose(ours, -0.5 * np.sum(x.astype(np.float64) ** 2, axis=1), rtol=1e-6)


def test_shard_batch_cuts_contiguous_near_equal_shards_in_order(mesh):
    x = np.arange(22, dtype=np.float32).reshape(11, 2)
    shards = shard_batch(x, mesh)
    assert [len(s) for s in shards] == [2, 2, 2, 1, 1, 1, 1, 1]
    assert all(s.device == d for s, d in zip(shards, mesh.devices))
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x)
    # the JAX package's shards of a padded batch hold its rows in order too
    padded, _ = jax_pad_to_multiple(x, 8)
    sharded = jax_shard_batch(padded, jax_get_mesh(devices=jax.devices("cpu"), n_devices=8))
    np.testing.assert_array_equal(np.asarray(sharded)[:11], x)
    assert data_sharding(mesh).split and not replicated_sharding(mesh).split
    copies = replicated_sharding(mesh).place(torch.as_tensor(x))
    assert len(copies) == 8 and all(torch.equal(c, torch.as_tensor(x)) for c in copies)


# ---------------------------------------------------------------------
# the data-parallel step
# ---------------------------------------------------------------------
def _pair(tmp_path, seed=0, scale=0.2):
    """A JAX and a port FlowModel with the same perturbed weights."""
    jfm = JaxFlowModel(FLOW_CONFIG, output=str(tmp_path / "jax"), rng=np.random.default_rng(seed))
    jfm.initialise()
    rng = np.random.default_rng(seed + 1)
    p = jax.tree.map(
        lambda a: a + rng.normal(0.0, scale, a.shape).astype(a.dtype) if a.dtype.kind == "f" else a,
        jax.tree.map(np.asarray, jfm.params),
    )
    tfm = FlowModel(FLOW_CONFIG, output=str(tmp_path / "torch"), rng=np.random.default_rng(seed), device="cpu")
    tfm.initialise()
    params_from_jax(tfm.flow, p)
    return jfm.flow, p, tfm.flow


def _jax_step(flow, params, jax_mesh, x, lr):
    opt = optax.adam(lr) if lr else optax.sgd(0.0)
    opt_state = opt.init(_partition_params(params)[0])
    rep = jax_replicated(jax_mesh)
    step = jax_make_dp_train_step(flow, opt, jax_mesh)
    params2, _, loss = step(
        jax.device_put(params, rep),
        jax.device_put(opt_state, rep),
        jax_shard_batch(x, jax_mesh),
        jax_shard_batch(np.ones(len(x), np.float32), jax_mesh),
    )
    return jax.tree.map(np.asarray, params2), float(loss)


def test_dp_loss_matches_the_single_device_loss_and_jax(tmp_path, mesh, jax_mesh):
    jflow, p, flow = _pair(tmp_path, seed=1)
    x = np.random.default_rng(1).normal(size=(64, 2)).astype(np.float32)
    expected = float(-flow.log_prob(torch.as_tensor(x)).mean().detach())
    step = make_dp_train_step(flow, torch.optim.SGD(flow.parameters(), lr=0.0), mesh)
    loss = float(step(torch.as_tensor(x)))
    _, jax_loss = _jax_step(jflow, jax.tree.map(jnp.asarray, p), jax_mesh, x, lr=0.0)
    assert np.isclose(loss, expected, rtol=LOSS_RTOL, atol=0.0)
    assert np.isclose(loss, jax_loss, rtol=JAX_RTOL, atol=0.0)


def test_dp_weighted_loss_normalises_over_the_whole_batch(mesh):
    """Unequal shards (13 rows on 8 entries): each shard adds its
    ``-sum(w log p)`` over the whole batch's ``sum(w)``, the loss of
    ``FlowModel._loss``, not a mean of the shards' means."""
    flow = FlowModel(FLOW_CONFIG, rng=np.random.default_rng(2), device="cpu", output=None)
    flow.initialise()
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(13, 2)).astype(np.float32))
    w = torch.as_tensor(np.random.default_rng(4).uniform(0.1, 2.0, 13).astype(np.float32))
    expected = float(flow._loss(x, w).detach())
    step = make_dp_train_step(flow.flow, torch.optim.SGD(flow.flow.parameters(), lr=0.0), mesh)
    assert np.isclose(float(step(x, w)), expected, rtol=LOSS_RTOL, atol=0.0)


def test_adam_step_on_eight_replicas_matches_the_single_step_and_jax(tmp_path, mesh, jax_mesh):
    jflow, p, flow = _pair(tmp_path, seed=2)
    x = np.random.default_rng(2).normal(size=(64, 2)).astype(np.float32)
    single = copy.deepcopy(flow)
    opt_single = torch.optim.Adam(single.parameters(), lr=1e-3)
    opt_single.zero_grad()
    (-single.log_prob(torch.as_tensor(x)).mean()).backward()
    opt_single.step()
    step = make_dp_train_step(flow, torch.optim.Adam(flow.parameters(), lr=1e-3), mesh)
    loss = step(torch.as_tensor(x))
    assert torch.isfinite(loss)
    for a, b in zip(flow.parameters(), single.parameters(), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=STEP_ATOL, rtol=0.0)
    # every replica holds the primary's new weights
    for replica in step.replicas[1:]:
        for a, b in zip(flow.state_dict().values(), replica.state_dict().values(), strict=True):
            assert torch.equal(a, b)
    theirs, _ = _jax_step(jflow, jax.tree.map(jnp.asarray, p), jax_mesh, x, lr=1e-3)
    ours = params_to_jax(flow)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs), strict=True):
        np.testing.assert_allclose(a, b, atol=JAX_STEP_ATOL, rtol=0.0)


def test_a_batch_shorter_than_the_mesh_sums_only_its_own_gradients(mesh):
    """After a step on 64 rows, a step on 3 rows leaves five of the eight
    entries without rows: their replicas' gradients of the step before
    must not reach the sum. Each SGD step (whose size is the gradient's)
    equals the single-device step."""
    flow = FlowModel(FLOW_CONFIG, rng=np.random.default_rng(5), device="cpu", output=None)
    flow.initialise()
    single = copy.deepcopy(flow.flow)
    opt_single = torch.optim.SGD(single.parameters(), lr=0.1)
    step = make_dp_train_step(flow.flow, torch.optim.SGD(flow.flow.parameters(), lr=0.1), mesh)
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(64, 2)).astype(np.float32))
    for batch in (x, x[:3]):
        opt_single.zero_grad()
        (-single.log_prob(batch).mean()).backward()
        opt_single.step()
        step(batch)
        for a, b in zip(flow.flow.parameters(), single.parameters(), strict=True):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=STEP_ATOL, rtol=0.0)


# ---------------------------------------------------------------------
# FlowModel and ImportanceFlowModel on the mesh
# ---------------------------------------------------------------------
def _flow_model(tmp_path, mesh, name, seed=0, cls=FlowModel, **training):
    return cls(
        flow_config=dict(n_inputs=2, n_blocks=2, n_neurons=8, n_layers=1),
        training_config=dict(dict(max_epochs=5, batch_size=64, patience=3), **training),
        output=str(tmp_path / name),
        rng=np.random.default_rng(seed),
        device="cpu",
        mesh=mesh,
    )


def test_flow_model_trains_on_the_mesh_as_on_one_device(tmp_path, mesh, jax_mesh):
    """Epoch losses of a mesh run equal the single-device run's from the
    same seed (batches of 64 are a multiple of 8, so the batches are the
    same); sharded inference equals the single-device model's and the JAX
    package's sharded inference at the same weights."""
    x = np.random.default_rng(0).normal(size=(512, 2)).astype(np.float32)
    one = _flow_model(tmp_path, None, "one")
    meshed = _flow_model(tmp_path, mesh, "mesh")
    h_one = one.train(x, save=False)
    h_mesh = meshed.train(x, save=False)
    assert h_mesh["loss"][-1] < h_mesh["loss"][0]
    np.testing.assert_allclose(h_mesh["loss"], h_one["loss"], rtol=1e-5)
    np.testing.assert_allclose(h_mesh["val_loss"], h_one["val_loss"], rtol=1e-5)
    z, lp = meshed.forward_and_log_prob(x[:100])
    assert z.shape == (100, 2) and np.isfinite(lp).all()
    # an unsharded model with the mesh model's weights
    one.flow.load_state_dict(meshed.flow.state_dict())
    z1, lp1 = one.forward_and_log_prob(x[:100])
    np.testing.assert_allclose(z, z1, atol=INFERENCE_ATOL)
    np.testing.assert_allclose(lp, lp1, atol=INFERENCE_ATOL)
    for name in ("forward", "inverse"):
        for a, b in zip(getattr(meshed, name)(x[:37]), getattr(one, name)(x[:37])):
            np.testing.assert_allclose(a, b, atol=INFERENCE_ATOL)
    np.testing.assert_allclose(meshed.log_prob(x[:9]), one.log_prob(x[:9]), atol=INFERENCE_ATOL)
    np.testing.assert_allclose(
        meshed.inverse_and_log_prob(x[:5], temperature=0.5)[1], one.inverse_and_log_prob(x[:5], temperature=0.5)[1],
        atol=INFERENCE_ATOL,
    )
    # the JAX package's sharded inference at the same weights
    jfm = JaxFlowModel(
        dict(n_inputs=2, n_blocks=2, n_neurons=8, n_layers=1),
        output=str(tmp_path / "jax"),
        rng=np.random.default_rng(0),
        mesh=jax_mesh,
    )
    jfm.initialise()
    jfm.params = jax.device_put(jax.tree.map(jnp.asarray, params_to_jax(meshed.flow)), jax_replicated(jax_mesh))
    jz, jlp = jfm.forward_and_log_prob(x[:100])
    np.testing.assert_allclose(z, jz, atol=INFERENCE_ATOL)
    np.testing.assert_allclose(lp, jlp, atol=INFERENCE_ATOL)


def test_batch_size_is_rounded_to_the_mesh_and_nothing_is_padded(tmp_path, mesh):
    fm = _flow_model(tmp_path, mesh, "bs", batch_size=60)
    fm.initialise()
    batches, val, _, _ = fm.prep_data(np.random.default_rng(1).normal(size=(200, 2)), 0.1)
    assert [len(b) for b in batches] == [64, 64, 52] and len(val) == 20


@pytest.mark.parametrize("on_mesh", [False, True])
def test_inference_on_zero_rows_gives_empty_outputs(tmp_path, mesh, on_mesh):
    """Both paths (the model's own device and the mesh) run the first
    entry on an empty shard, so zero rows give empty outputs."""
    fm = _flow_model(tmp_path, mesh if on_mesh else None, "empty")
    fm.initialise()
    x = np.empty((0, 2))
    for name in ("forward_and_log_prob", "forward", "inverse", "inverse_and_log_prob"):
        points, per_row = getattr(fm, name)(x)
        assert points.shape == (0, 2) and per_row.shape == (0,)
    assert fm.log_prob(x).shape == (0,)
    assert fm.sample(0).shape == (0, 2)


def test_mesh_draws_equal_single_device_draws(tmp_path, mesh):
    """``sample`` draws the latent points on the first device from the
    same generator and inverts them shard by shard."""
    one = _flow_model(tmp_path, None, "one", seed=5)
    meshed = _flow_model(tmp_path, mesh, "mesh", seed=5)
    one.initialise()
    meshed.initialise()
    np.testing.assert_allclose(meshed.sample(21), one.sample(21), atol=INFERENCE_ATOL)


def test_a_mesh_model_pickles_without_the_mesh(tmp_path, mesh):
    fm = _flow_model(tmp_path, mesh, "pickle")
    fm.train(np.random.default_rng(0).normal(size=(128, 2)).astype(np.float32), save=False)
    state = fm.__getstate__()
    assert state["mesh"] is None and not state["_replicas"]
    restored = pickle.loads(pickle.dumps(fm))
    assert restored.mesh is None and not restored._replicas
    x = np.random.default_rng(1).normal(size=(10, 2))
    np.testing.assert_allclose(restored.log_prob(x), fm.log_prob(x), atol=INFERENCE_ATOL)


def test_replicas_follow_resets_and_loaded_weights(tmp_path, mesh):
    fm = _flow_model(tmp_path, mesh, "reset")
    fm.initialise()

    def replicas_equal():
        primary = fm.flow.state_dict()
        return all(
            torch.equal(a, b) for r in fm.replicas[1:] for a, b in zip(primary.values(), r.state_dict().values())
        )

    fm.reset_model(weights=True, permutations=True)
    assert replicas_equal()
    path = str(tmp_path / "w.pt")
    fm.save_weights(path)
    with torch.no_grad():
        for p in fm.flow.parameters():
            p.add_(1.0)
    fm.reload_weights(path)
    assert replicas_equal()
    fm._maybe_init_actnorm(np.random.default_rng(2).normal(3.0, 2.0, (100, 2)))
    assert replicas_equal()


def test_a_lars_base_updates_on_the_primary_and_reaches_the_replicas(tmp_path, mesh):
    """A LARS base moves its normalisation estimate on the primary after
    every epoch and after training; the replicas hold it after each."""
    fm = FlowModel(
        flow_config=dict(n_inputs=2, n_blocks=2, n_neurons=8, n_layers=1, distribution="lars"),
        training_config=dict(max_epochs=2, batch_size=64, patience=3),
        output=str(tmp_path / "lars"),
        rng=np.random.default_rng(3),
        device="cpu",
        mesh=mesh,
    )
    fm.train(np.random.default_rng(4).normal(size=(128, 2)).astype(np.float32), save=False)
    primary = fm.flow.base.state_dict()
    for replica in fm.replicas[1:]:
        for a, b in zip(primary.values(), replica.base.state_dict().values(), strict=True):
            assert torch.equal(a, b)


def test_importance_flow_model_on_the_mesh(tmp_path, mesh):
    """Each level trains data-parallel; ``log_prob_all`` cuts its rows
    over the mesh, runs every level on each shard and equals the levels
    run on one device; a level's draws equal the single-device draws."""
    x = np.random.default_rng(0).normal(size=(256, 2)).astype(np.float32)
    models = {}
    for name, m in (("one", None), ("mesh", mesh)):
        fm = _flow_model(tmp_path, m, name, seed=7, cls=ImportanceFlowModel, max_epochs=3, patience=2)
        for _ in range(2):
            fm.add_new_flow(reset=True)
            fm.train(x)
        models[name] = fm
    meshed, one = models["mesh"], models["one"]
    lp = meshed.log_prob_all(x[:50])
    assert lp.shape == (50, 2) and np.isfinite(lp).all()
    np.testing.assert_allclose(lp, one.log_prob_all(x[:50]), atol=1e-4)
    # the same levels on one device
    for level, other in zip(one.models, meshed.models):
        level.load_state_dict(other.state_dict())
    np.testing.assert_allclose(lp, one.log_prob_all(x[:50]), atol=INFERENCE_ATOL)
    a, la = meshed.sample_and_log_prob_ith(1, N=13)
    b, lb = one.sample_and_log_prob_ith(1, N=13)
    np.testing.assert_allclose(a, b, atol=INFERENCE_ATOL)
    np.testing.assert_allclose(la, lb, atol=INFERENCE_ATOL)


# ---------------------------------------------------------------------
# the populate on the mesh
# ---------------------------------------------------------------------
def _proposal(tmp_path, name, mesh=None, model=None, seed=909):
    from nessai_tpu_torch.proposal import FlowProposal

    model = IntegrationTestModel(2) if model is None else model
    model.set_rng(np.random.default_rng(seed))
    model.device = "cpu"
    fp = FlowProposal(
        model,
        output=str(tmp_path / name),
        poolsize=64,
        flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
        training_config=dict(max_epochs=5, batch_size=64, patience=3),
        rng=np.random.default_rng(seed),
        plot=False,
        device="cpu",
        mesh=mesh,
    )
    fp.initialise()
    x = model.new_point(128)
    x["logL"] = model.batch_evaluate_log_likelihood(x)
    fp.train(x, plot=False)
    return fp, x


def _onto(fp, mesh):
    """Put a trained proposal's flow model onto ``mesh``."""
    fp.flow.mesh = mesh
    fp.flow._replicas = replicated_sharding(mesh).place(fp.flow.flow)[1:]


def test_fused_populate_sharded_matches_single_device(tmp_path, mesh):
    fp, _ = _proposal(tmp_path, "fused")
    assert fp._can_fuse_populate
    z = np.random.default_rng(3).standard_normal((37, 2))
    single = fp._fused_backward(z)
    _onto(fp, mesh)
    sharded = fp._fused_backward(z)
    for a, b in zip(single, sharded):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=1e-5, atol=1e-5)


def test_a_mesh_populate_gives_the_single_device_pool(tmp_path, mesh):
    """Two proposals trained alike on one device, one then moved onto the
    mesh: the same draws give the same pool, and the device populate loop
    is off on the mesh (``"device_loop"`` raises)."""
    fp_one, x = _proposal(tmp_path, "one")
    fp_mesh, _ = _proposal(tmp_path, "mesh")
    _onto(fp_mesh, mesh)
    assert fp_one._can_device_loop and not fp_mesh._can_device_loop
    fp_one.populate_mode = "rounds"
    fp_one.populate(x[:1], n_samples=32)
    fp_mesh.populate(x[:1], n_samples=32)
    for name in fp_one.model.names + ["logL", "logP"]:
        np.testing.assert_allclose(fp_mesh.samples[name], fp_one.samples[name], rtol=1e-5, atol=1e-5)
    fp_mesh.populate_mode = "device_loop"
    with pytest.raises(RuntimeError, match="device_loop"):
        fp_mesh.populate(x[:1], n_samples=32)


def test_host_likelihood_on_a_mesh_gives_the_same_pool(tmp_path, mesh, caplog):
    """A model without a device likelihood draws the same pool on the
    mesh as one with it: the sharded call inverts and checks the bounds,
    and the likelihood is evaluated on the host for the pool alone (said
    once); logL agrees to the device likelihood's float32 rounding."""

    class HostModel(IntegrationTestModel):
        torch_log_likelihood = None

    pools = {}
    for name, cls in (("device", IntegrationTestModel), ("host", HostModel)):
        model = cls(2)
        fp, x = _proposal(tmp_path, name, mesh=mesh, model=model)
        with caplog.at_level("INFO"):
            fp.populate(x[:1], n_samples=32)
            fp.populate(x[:1], n_samples=32)
        pools[name] = fp.samples
    said = [r for r in caplog.records if "Host likelihood on a 8-entry mesh" in r.getMessage()]
    assert len(said) == 1
    for name in IntegrationTestModel(2).names:
        np.testing.assert_allclose(pools["host"][name], pools["device"][name], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pools["host"]["logL"], pools["device"]["logL"], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------
# both samplers end to end (one run each, shared by the module)
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def sampler_runs(tmp_path_factory):
    from nessai_tpu_torch.flowsampler import FlowSampler

    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    saved = copy.deepcopy(config.livepoints.__dict__)
    config.livepoints.reset()
    mesh = get_mesh(devices=["cpu"] * 8)
    runs = {"mesh": mesh}
    try:
        standard = FlowSampler(
            IntegrationTestModel(2),
            output=str(tmp_path_factory.mktemp("standard")),
            nlive=100,
            seed=12,
            resume=False,
            plot=False,
            checkpointing=False,
            max_iteration=120,
            maximum_uninformed=40,
            flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
            training_config=dict(max_epochs=5, batch_size=64, patience=3),
            poolsize=100,
            mesh=mesh,
            device="cpu",
        )
        standard.run(plot=False, save=False)
        runs["standard"] = standard
        ins = FlowSampler(
            IntegrationTestModel(2),
            output=str(tmp_path_factory.mktemp("ins")),
            nlive=100,
            min_samples=10,
            seed=13,
            resume=False,
            plot=False,
            checkpointing=False,
            importance_nested_sampler=True,
            min_iteration=2,
            max_iteration=3,
            flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
            training_config=dict(max_epochs=5, batch_size=64, patience=3),
            mesh=mesh,
            device="cpu",
        )
        ins.run(plot=False, save=False)
        runs["ins"] = ins
    finally:
        config.livepoints.__dict__.update(saved)
        torch.set_num_threads(previous)
    return runs


def test_full_sampler_with_mesh(sampler_runs):
    fs = sampler_runs["standard"]
    proposal = fs.ns._flow_proposal
    assert proposal.training_count >= 1
    assert proposal.mesh is sampler_runs["mesh"] and proposal.flow.mesh is sampler_runs["mesh"]
    assert len(proposal.flow.replicas) == 8
    assert not proposal._can_device_loop
    assert np.isfinite(fs.logZ)


def test_full_ins_sampler_with_mesh(sampler_runs):
    fs = sampler_runs["ins"]
    assert fs.ns.proposal.mesh is sampler_runs["mesh"]
    assert fs.ns.proposal.flow.mesh is sampler_runs["mesh"]
    assert fs.ns.proposal.level_count >= 0 and fs.ns.proposal.flow.n_models >= 1
    assert len(fs.ns.proposal.flow.level_replicas(0)) == 8
    assert np.isfinite(fs.logZ)
