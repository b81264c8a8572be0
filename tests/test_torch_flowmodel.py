"""The port's FlowModel against the JAX package's: actnorm data-init,
AdamW with optax's global-norm clipping step by step, and early stopping
with the best-weights restore."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nessai_tpu.flowmodel import FlowModel as JaxFlowModel
from nessai_tpu_torch.flowmodel import FlowModel
from nessai_tpu_torch.flowmodel.base import _clip_by_global_norm
from nessai_tpu_torch.flows import params_from_jax, params_to_jax

FLOW_CONFIG = dict(n_inputs=2, n_blocks=2, n_neurons=4, n_layers=1)


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")


def _perturbed(fm, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (
            a + rng.normal(0.0, scale, a.shape).astype(a.dtype)
            if a.dtype.kind == "f"
            else a
        ),
        jax.tree.map(np.asarray, fm.params),
    )


def _pair(tmp_path, training_config=None, seed=0):
    jfm = JaxFlowModel(
        FLOW_CONFIG, training_config, output=str(tmp_path / "jax"), rng=np.random.default_rng(seed)
    )
    jfm.initialise()
    p = _perturbed(jfm, seed + 1)
    jfm.params = jax.tree.map(jnp.asarray, p)
    jfm.reset_optimiser()
    tfm = FlowModel(
        FLOW_CONFIG,
        training_config,
        output=str(tmp_path / "torch"),
        rng=np.random.default_rng(seed),
        device="cpu",
    )
    tfm.initialise()
    params_from_jax(tfm.flow, p)
    tfm.reset_optimiser()
    return jfm, tfm


def _data(n, seed, loc=0.0, scale=1.0):
    return (loc + scale * np.random.default_rng(seed).standard_normal((n, 2))).astype(np.float32)


def test_actnorm_data_init_matches_jax(tmp_path):
    jfm, tfm = _pair(tmp_path)
    x = _data(300, 3, loc=2.0, scale=3.0)
    jfm._maybe_init_actnorm(x)
    tfm._maybe_init_actnorm(x)
    ours = params_to_jax(tfm.flow)["bijector"]
    theirs = jax.tree.map(np.asarray, jfm.params)["bijector"]
    n_actnorm = 0
    for a, b in zip(ours, theirs):
        if "log_scale" in a:
            n_actnorm += 1
            np.testing.assert_allclose(a["log_scale"], b["log_scale"], atol=1e-6)
            np.testing.assert_allclose(a["shift"], b["shift"], atol=1e-6)
    assert n_actnorm == 2


@pytest.mark.parametrize("lr", [1e-3, 1e-2, 3e-2])
def test_training_steps_match_jax(tmp_path, lr):
    jfm, tfm = _pair(tmp_path, dict(lr=lr), seed=4)
    train_epoch, _ = jfm._epoch_fns(False, False)
    params, opt_state = jfm.params, jfm.opt_state
    key = jax.random.PRNGKey(0)
    batches = [_data(128, 10 + k, loc=3.0, scale=2.0) for k in range(8)]
    # the first batches are far from the flow: their gradient norm is
    # above the clip threshold of 5, so clipping is exercised
    probe = copy.deepcopy(tfm.flow)
    loss = -probe.log_prob(torch.as_tensor(batches[0])).mean()
    loss.backward()
    norm = torch.sqrt(sum((p.grad**2).sum() for p in probe.parameters()))
    assert norm > 5.0
    jax_losses, torch_losses = [], []
    for x in batches:
        params, opt_state, l_j = train_epoch(
            params, opt_state, {"x": jnp.asarray(x)[None], "w": jnp.ones((1, len(x)))}, key
        )
        jax_losses.append(float(l_j))
        torch_losses.append(float(tfm._train_step(torch.as_tensor(x))))
    np.testing.assert_allclose(torch_losses, jax_losses, rtol=1e-4)
    assert jax_losses[-1] < jax_losses[0]


def test_clip_by_global_norm_matches_optax():
    import optax

    rng = np.random.default_rng(0)
    grads = [rng.normal(0, 3, s).astype(np.float32) for s in ((3, 2), (4,), (2, 2))]
    for max_norm in (1.0, 5.0, 100.0):
        params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.as_tensor(g.copy())
        _clip_by_global_norm(params, max_norm)
        ref, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None
        )
        for p, r in zip(params, ref):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6)


def test_early_stopping_restores_best_weights(tmp_path):
    tfm = FlowModel(
        FLOW_CONFIG,
        dict(lr=0.05, max_epochs=300, patience=5, batch_size=20),
        output=str(tmp_path),
        rng=np.random.default_rng(8),
        device="cpu",
    )
    captured = []
    prep = tfm.prep_data

    def capture(*args, **kwargs):
        captured.append(prep(*args, **kwargs))
        return captured[-1]

    tfm.prep_data = capture
    history = tfm.train(_data(60, 9), save=False)
    n = len(history["val_loss"])
    best = int(np.argmin(history["val_loss"]))
    assert n < 300, "training did not stop early"
    assert n - 1 - best == 6
    with torch.no_grad():
        val_loss = -tfm.flow.log_prob(captured[0][1]).mean().item()
    np.testing.assert_allclose(val_loss, history["val_loss"][best], rtol=1e-6)
    assert val_loss < history["val_loss"][-1]


def test_inference_api_round_trip(tmp_path):
    _, tfm = _pair(tmp_path)
    x = _data(50, 12)
    z, log_q = tfm.forward_and_log_prob(x)
    x_back, log_q_back = tfm.inverse_and_log_prob(z)
    assert z.dtype == np.float64 and log_q.dtype == np.float64
    np.testing.assert_allclose(x_back, x, atol=1e-5)
    np.testing.assert_allclose(log_q_back, log_q, atol=1e-4)
    np.testing.assert_allclose(tfm.log_prob(x), log_q, atol=1e-6)


def test_save_and_load_weights(tmp_path):
    _, tfm = _pair(tmp_path)
    path = str(tmp_path / "w.pt")
    tfm.save_weights(path)
    other = FlowModel(FLOW_CONFIG, output=str(tmp_path), rng=np.random.default_rng(1), device="cpu")
    other.load_weights(path)
    x = _data(20, 13)
    np.testing.assert_array_equal(other.log_prob(x), tfm.log_prob(x))



def test_non_finite_loss_keeps_the_starting_weights(tmp_path):
    _, tfm = _pair(tmp_path, dict(max_epochs=5, patience=2), seed=7)
    tfm._actnorm_done = True
    start = {k: v.clone() for k, v in tfm.flow.state_dict().items()}
    x = _data(100, 14)
    x[3, 0] = 1e30  # overflows the float32 log-density: the loss is inf
    history = tfm.train(x, save=False)
    assert len(history["loss"]) == 1 and not np.isfinite(history["loss"][0])
    for k, v in tfm.flow.state_dict().items():
        assert torch.equal(v, start[k]), k
