"""The flow model's training options in the port against the JAX
package's: one optimiser step of ``adam``, ``adamw`` and ``sgd`` (with
their keyword arguments) from the same converted weights and batch, the
cosine-annealed learning rate over a training, the noise scales,
``batch_size="all"``, ``use_actnorm_init``, the training config's
checks, ``n_neurons`` by name, and ``reset_model`` resetting exactly the
weights and/or permutations asked for."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nessai_tpu.flowmodel import FlowModel as JaxFlowModel
from nessai_tpu.flowmodel.config import update_training_config as jax_update_training_config
from nessai_tpu.flows.utils import get_n_neurons as jax_get_n_neurons
from nessai_tpu_torch.flowmodel import FlowModel
from nessai_tpu_torch.flowmodel.base import _cosine_decay
from nessai_tpu_torch.flowmodel.config import update_training_config
from nessai_tpu_torch.flows import params_from_jax, params_to_jax
from nessai_tpu_torch.flows.bijectors import Permutation
from nessai_tpu_torch.flows.utils import get_n_neurons

FLOW_CONFIG = dict(n_inputs=2, n_blocks=2, n_neurons=8, n_layers=1)
#: one optimiser step from the same weights and batch: the float32
#: gradients of the two frameworks differ by rounding, scaled by lr
STEP_ATOL = 1e-6
#: the learning-rate schedule, as a share of the initial rate (optax
#: evaluates it in float32)
LR_SHARE = 1e-6


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")


def _pair(tmp_path, training_config, seed=0, flow_config=FLOW_CONFIG):
    jfm = JaxFlowModel(flow_config, training_config, output=str(tmp_path / "jax"), rng=np.random.default_rng(seed))
    jfm.initialise()
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda a: a + rng.normal(0.0, 0.2, a.shape).astype(a.dtype) if a.dtype.kind == "f" else a,
        jax.tree.map(np.asarray, jfm.params),
    )
    jfm.params = jax.tree.map(jnp.asarray, params)
    jfm.reset_optimiser()
    tfm = FlowModel(flow_config, training_config, output=str(tmp_path / "torch"), rng=np.random.default_rng(seed),
                    device="cpu")
    tfm.initialise()
    params_from_jax(tfm.flow, params)
    tfm.reset_optimiser()
    return jfm, tfm


def _leaves(params):
    return [np.asarray(a) for a in jax.tree.leaves(params) if np.asarray(a).dtype.kind == "f"]


@pytest.mark.parametrize(
    "training_config",
    [
        dict(optimiser="adamw", lr=1e-2),
        dict(optimiser="adam", lr=1e-2),
        dict(optimiser="adam", lr=3e-3, optimiser_kwargs=dict(b1=0.8, b2=0.99, eps=1e-6)),
        dict(optimiser="adamw", lr=1e-2, optimiser_kwargs=dict(weight_decay=0.1)),
        dict(optimiser="sgd", lr=1e-2),
        dict(optimiser="sgd", lr=1e-2, optimiser_kwargs=dict(momentum=0.9, nesterov=True)),
        dict(optimiser="SGD", lr=1e-3, clip_grad_norm=0.5),
    ],
    ids=str,
)
def test_optimiser_steps_match_optax(tmp_path, training_config):
    """Three steps on three batches: the weights after each step to
    ``STEP_ATOL`` of optax's."""
    jfm, tfm = _pair(tmp_path, training_config)
    train_epoch, _ = jfm._epoch_fns(False, False)
    params, opt_state = jfm.params, jfm.opt_state
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = (1.5 + rng.standard_normal((128, 2))).astype(np.float32)
        params, opt_state, _ = train_epoch(
            params, opt_state, {"x": jnp.asarray(x)[None], "w": jnp.ones((1, len(x)))}, jax.random.PRNGKey(0)
        )
        tfm._train_step(torch.as_tensor(x))
        for a, b in zip(_leaves(params_to_jax(tfm.flow)), _leaves(params)):
            np.testing.assert_allclose(a, b, atol=STEP_ATOL, rtol=0)


def test_unknown_optimiser_and_keywords_raise(tmp_path):
    with pytest.raises(ValueError, match="Unknown optimiser"):
        _pair(tmp_path, dict(optimiser="lbfgs"))
    with pytest.raises(ValueError, match="Unknown keyword arguments"):
        FlowModel(FLOW_CONFIG, dict(optimiser="sgd", optimiser_kwargs=dict(b1=0.9)), output=str(tmp_path),
                  device="cpu").initialise()


def test_cosine_decay_matches_optax():
    schedule = optax.cosine_decay_schedule(3e-3, 40)
    for step in range(50):
        np.testing.assert_allclose(_cosine_decay(3e-3, step, 40), float(schedule(step)), rtol=0, atol=LR_SHARE * 3e-3)


def test_annealing_decays_over_the_training(tmp_path):
    """With ``annealing`` each training starts a fresh optimiser at ``lr``
    and takes the learning rate of optax's cosine schedule over
    ``max_epochs`` × batches steps at every step."""
    tfm = FlowModel(FLOW_CONFIG, dict(annealing=True, lr=1e-2, max_epochs=6, patience=100, batch_size=100),
                    output=str(tmp_path), rng=np.random.default_rng(0), device="cpu")
    tfm.initialise()
    seen = []
    step = tfm._train_step

    def recording(x, w=None):
        seen.append(tfm.optimiser.param_groups[0]["lr"])
        return step(x, w)

    tfm._train_step = recording
    x = np.random.default_rng(1).standard_normal((400, 2))
    for _ in range(2):
        tfm.train(x, save=False)
    n_batches = 4  # 360 training rows in batches of 100
    schedule = optax.cosine_decay_schedule(1e-2, 6 * n_batches)
    expected = [float(schedule(k)) for k in range(6 * n_batches)]
    np.testing.assert_allclose(seen, expected * 2, rtol=0, atol=LR_SHARE * 1e-2)


@pytest.mark.parametrize("noise", [dict(noise_type="constant", noise_scale=0.1),
                                   dict(noise_type="adaptive", noise_scale=0.5), dict(noise_scale=0.2)], ids=str)
def test_noise_scales_match_jax(tmp_path, noise):
    """The per-row noise scale on the same training rows; a bare float
    ``noise_scale`` means constant noise in both."""
    assert update_training_config(dict(noise)).noise_type == jax_update_training_config(dict(noise)).noise_type
    jfm, tfm = _pair(tmp_path, noise)
    x = np.random.default_rng(3).standard_normal((300, 2)).astype(np.float32)
    batches = list(torch.split(torch.as_tensor(x), 128))
    ours = torch.cat(tfm._noise_sigma(batches)).numpy()
    theirs = jfm._noise_sigma(x)
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)


def test_noise_is_added_to_every_step(tmp_path):
    tfm = FlowModel(FLOW_CONFIG, dict(noise_type="constant", noise_scale=0.3, max_epochs=2, batch_size=100),
                    output=str(tmp_path), rng=np.random.default_rng(0), device="cpu")
    tfm.initialise()
    seen, prepared = [], []
    step, prep = tfm._train_step, tfm.prep_data
    tfm._train_step = lambda x, w=None: (seen.append(x.clone()), step(x, w))[1]
    tfm.prep_data = lambda *a, **k: (prepared.append(prep(*a, **k)), prepared[-1])[1]
    data = np.random.default_rng(1).standard_normal((250, 2))
    tfm.train(data, save=False)
    batches = prepared[0][0]
    assert len(seen) == 2 * len(batches)
    residual = (seen[0] - batches[0]).numpy()
    assert 0.2 < residual.std() < 0.4 and abs(residual.mean()) < 0.1


def test_batch_size_all_takes_one_batch(tmp_path):
    jfm, tfm = _pair(tmp_path, dict(batch_size="all"))
    x = np.random.default_rng(0).standard_normal((500, 2))
    batches, val, _, _ = tfm.prep_data(x, 0.1)
    data = jfm.prep_data(x, 0.1)
    assert len(batches) == data["train"]["x"].shape[0] == 1
    assert len(batches[0]) == 450 == int(np.asarray(data["train"]["w"]).sum()) and len(val) == 50
    for cfg in ({"batch_size": "some"},):
        with pytest.raises(ValueError, match="Unknown batch_size"):
            update_training_config(cfg)
        with pytest.raises(ValueError, match="Unknown batch_size"):
            jax_update_training_config(cfg)
    with pytest.raises(RuntimeError, match="Unknown batch size"):
        tfm.prep_data(x, 0.1, batch_size=2.5)


def test_training_config_checks_match_jax():
    for cfg, error in (
        (dict(noise_type="constant"), RuntimeError),
        (dict(noise_scale=1), TypeError),
        (dict(noise_type="other", noise_scale=1.0), ValueError),
        (dict(unknown=1), ValueError),
        ([1], TypeError),
    ):
        with pytest.raises(error):
            update_training_config(cfg)
        with pytest.raises(error):
            jax_update_training_config(cfg)


def test_use_actnorm_init_false_skips_the_data_initialisation(tmp_path):
    for use, changed in ((True, True), (False, False)):
        tfm = FlowModel(FLOW_CONFIG, dict(use_actnorm_init=use), output=str(tmp_path), rng=np.random.default_rng(0),
                        device="cpu")
        tfm.initialise()
        before = {k: v.clone() for k, v in tfm.flow.state_dict().items() if "shift" in k}
        tfm._maybe_init_actnorm(3.0 + np.random.default_rng(1).standard_normal((100, 2)))
        after = {k: v for k, v in tfm.flow.state_dict().items() if "shift" in k}
        assert before and any(not torch.equal(before[k], after[k]) for k in before) == changed


@pytest.mark.parametrize("name", [None, "auto", "double", "equal", "half", 7])
@pytest.mark.parametrize("n_inputs", [1, 2, 5])
def test_n_neurons_by_name_matches_jax(name, n_inputs):
    assert get_n_neurons(name, n_inputs) == jax_get_n_neurons(name, n_inputs)


@pytest.mark.parametrize("weights, permutations", [(True, False), (False, True), (True, True)])
def test_reset_model_resets_what_it_is_asked(tmp_path, weights, permutations):
    """The weights (and the ActNorm data initialisation at the next
    training) and/or the permutations, nothing else; a fresh optimiser."""
    tfm = FlowModel(dict(n_inputs=4, n_blocks=6, n_neurons=8), {}, output=str(tmp_path),
                    rng=np.random.default_rng(0), device="cpu")
    tfm.initialise()
    tfm._actnorm_done = True
    optimiser = tfm.optimiser
    with torch.no_grad():
        for p in tfm.flow.parameters():
            p.add_(0.1)
    perm_keys = {f"bijector.bijectors.{i}.{n}" for i, b in enumerate(tfm.flow.bijector.bijectors)
                 if isinstance(b, Permutation) for n in ("perm", "inv")}
    before = {k: v.clone() for k, v in tfm.flow.state_dict().items()}
    tfm.reset_model(weights=weights, permutations=permutations)
    after = tfm.flow.state_dict()
    perms_changed = any(not torch.equal(before[k], after[k]) for k in perm_keys)
    weights_changed = [not torch.equal(before[k], after[k]) for k, _ in tfm.flow.named_parameters()]
    assert perms_changed == permutations
    assert all(weights_changed) if weights else not any(weights_changed)
    assert tfm._actnorm_done is (not weights)
    assert tfm.optimiser is not optimiser
    for i, b in enumerate(tfm.flow.bijector.bijectors):
        if isinstance(b, Permutation):
            assert torch.equal(b.perm[b.inv], torch.arange(4))


def test_reset_model_of_an_uninitialised_model_initialises_it(tmp_path):
    tfm = FlowModel(FLOW_CONFIG, {}, output=str(tmp_path), rng=np.random.default_rng(0), device="cpu")
    tfm.reset_model()
    assert tfm.initialised and tfm.flow is not None
