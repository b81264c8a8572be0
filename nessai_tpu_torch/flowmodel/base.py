"""FlowModel: training and inference around one normalising flow.
Counterpart of ``nessai_tpu/flowmodel/base.py``.

Training is a plain eager loop: the batches are shuffled and split once
per call, every epoch steps the optimiser (AdamW by default, or Adam or
SGD, as optax defines them) with optax's global-norm clipping over them,
optionally with a cosine-annealed learning rate and Gaussian noise added
to the inputs, a held-out validation split drives patience-based early
stopping, and the best weights are restored at the end. The flow is in training
mode (conditioner dropout) for the optimiser steps alone. A LARS base
distribution moves its normalisation estimate after every epoch and
takes a final one after training, where the JAX package's per-epoch
loop does (``nessai_tpu/flowmodel/base.py:991-1035, 1108-1113``). Host
arrays come in and go out as numpy; the flow and its data live on
``device``.
"""

import copy
import logging
import math
import os
import shutil

import numpy as np
import torch

from ..flows import configure_model
from ..flows.utils import reset_permutations, reset_weights
from ..flows.bijectors import ActNorm, Chain
from ..flows.distributions import ResampledGaussian
from ..utils.device import get_device
from .config import (
    FlowConfig,
    TrainingConfig,
    flow_config_to_dict,
    update_flow_config,
    update_training_config,
)

logger = logging.getLogger(__name__)

__all__ = ["FlowModel", "WEIGHTS_FILE"]

#: name of the weights file that :meth:`FlowModel.train` saves
WEIGHTS_FILE = "model.pt"


@torch.no_grad()
def _get_optimiser(name: str, params, lr: float, **kwargs):
    """``adam``, ``adamw`` or ``sgd`` with optax's defaults and keyword
    names (``b1``, ``b2``, ``eps``, ``weight_decay``, ``momentum``,
    ``nesterov``): AdamW decays the weights by 1e-4 where torch's default
    is 1e-2, and SGD has no momentum unless asked."""
    name = name.lower()
    kwargs = dict(kwargs)
    if name in ("adam", "adamw"):
        options = dict(
            lr=lr,
            betas=(kwargs.pop("b1", 0.9), kwargs.pop("b2", 0.999)),
            eps=kwargs.pop("eps", 1e-8),
        )
        if name == "adamw":
            options["weight_decay"] = kwargs.pop("weight_decay", 1e-4)
        optimiser = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
    elif name == "sgd":
        momentum = kwargs.pop("momentum", None)
        options = dict(lr=lr, momentum=momentum or 0.0, nesterov=bool(kwargs.pop("nesterov", False)))
        optimiser = torch.optim.SGD
    else:
        raise ValueError(f"Unknown optimiser: {name}")
    if kwargs:
        raise ValueError(f"Unknown keyword arguments for the {name} optimiser: {sorted(kwargs)}")
    return optimiser(params, **options)


def _cosine_decay(lr: float, step: int, decay_steps: int) -> float:
    """``optax.cosine_decay_schedule(lr, decay_steps)`` at ``step``."""
    step = min(step, decay_steps)
    return lr * 0.5 * (1.0 + math.cos(math.pi * step / decay_steps))


def _clip_by_global_norm(params, max_norm: float) -> None:
    """``optax.clip_by_global_norm``: scale every gradient by
    ``max_norm / norm`` when the global norm is at least ``max_norm``
    (without the 1e-6 that ``torch.nn.utils.clip_grad_norm_`` adds)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads])
    )
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


class FlowModel:
    """Normalising-flow training and inference engine."""

    #: ``torch.Generator`` attributes, pickled as their states
    _generators = ("_device_generator",)

    def __init__(self, flow_config=None, training_config=None, output=None, rng=None, device=None):
        self.device = get_device(device)
        self.output = os.getcwd() if output is None else output
        os.makedirs(self.output, exist_ok=True)
        self.flow_config: FlowConfig = update_flow_config(flow_config)
        self.training_config: TrainingConfig = update_training_config(training_config)
        self.rng = rng if rng is not None else np.random.default_rng()
        self.flow = None
        self.optimiser = None
        self.initialised = False
        self.weights_file = None
        self.history = {"loss": [], "val_loss": []}
        self._actnorm_done = False
        #: the device draws of a LARS base's normalisation and of a latent
        #: distribution other than the unit Gaussian, made at first use
        self._device_generator = None

    @property
    def dims(self):
        return self.flow_config.n_inputs

    # ------------------------------------------------------------------
    def initialise(self) -> None:
        """Build the flow on the device, with weights drawn from a seed
        taken from ``rng``, and its optimiser."""
        if self.initialised:
            return
        cfg = flow_config_to_dict(self.flow_config)
        cfg["seed"] = int(self.rng.integers(0, 2**31 - 1))
        self.flow = configure_model(cfg).to(self.device)
        self.reset_optimiser()
        self.initialised = True

    def reset_optimiser(self, lr=None) -> None:
        """A fresh optimiser of ``training_config.optimiser`` (with its
        ``optimiser_kwargs``) at ``lr``, by default the configured one."""
        tc = self.training_config
        self.optimiser = _get_optimiser(
            tc.optimiser, self.flow.parameters(), tc.lr if lr is None else lr, **tc.optimiser_kwargs
        )

    def reset_model(self, weights: bool = True, permutations: bool = False) -> None:
        """Fresh weights (and the ActNorm data initialisation at the next
        training) and/or fresh permutations, each from a seed drawn from
        ``rng``, then a fresh optimiser. An uninitialised model is only
        initialised."""
        if not self.initialised:
            self.initialise()
            return
        config = flow_config_to_dict(self.flow_config)
        generator = torch.Generator().manual_seed(int(self.rng.integers(0, 2**31 - 1)))
        if weights:
            reset_weights(self.flow, config, generator)
            self._actnorm_done = False
        if permutations:
            reset_permutations(self.flow, config, generator)
        self.reset_optimiser()

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def prep_data(self, samples, val_size, batch_size=None, weights=None):
        """Shuffle, split off ``val_size`` for validation and cut the
        training rows into batches (the last one may be smaller).
        ``weights`` (one per sample) are shuffled and split with the
        samples. Returns ``(train_batches, val, weight_batches,
        val_weights)`` as device tensors; the weight entries are None
        without weights."""
        samples = np.asarray(samples, dtype=np.float32)
        if not np.isfinite(samples).all():
            raise ValueError("Training data is not finite")
        n = len(samples)
        if weights is not None:
            weights = np.asarray(weights, dtype=np.float32)
            if not np.isfinite(weights).all():
                raise ValueError("Weights contain non-finite values")
        perm = self.rng.permutation(n)
        samples = samples[perm]
        n_val = int(round((val_size or 0.0) * n))
        n_train = n - n_val
        if n_train < 2:
            raise ValueError(f"Too few training samples: {n_train}")
        if batch_size is None:
            batch_size = self.training_config.batch_size
        if batch_size == "all":
            batch_size = n_train
        elif not isinstance(batch_size, int) or isinstance(batch_size, bool):
            raise RuntimeError(f"Unknown batch size: {batch_size}")
        if batch_size == 1:
            raise ValueError("Cannot use a batch size of 1!")
        batch_size = min(int(batch_size), n_train)
        train = self._to_device(samples[:n_train])
        batches = list(torch.split(train, batch_size))
        val = self._to_device(samples[n_train:]) if n_val > 0 else None
        if weights is None:
            return batches, val, None, None
        weights = weights[perm]
        w_batches = list(torch.split(self._to_device(weights[:n_train]), batch_size))
        w_val = self._to_device(weights[n_train:]) if n_val > 0 else None
        return batches, val, w_batches, w_val

    def _state_copy(self) -> dict:
        return {k: v.detach().clone() for k, v in self.flow.state_dict().items()}

    def _trainable(self):
        return [p for p in self.flow.parameters() if p.requires_grad]

    def _loss(self, x, w=None) -> torch.Tensor:
        """Mean negative log-density of the batch ``x``; with weights
        ``w``, the JAX package's weighted loss ``-sum(w log p) /
        max(sum(w), 1e-12)``."""
        log_p = self.flow.log_prob(x)
        if w is None:
            return -log_p.mean()
        return -(w * log_p).sum() / w.sum().clamp_min(1e-12)

    def device_generator(self) -> torch.Generator:
        """The generator of a LARS base's normalisation draws and of the
        draws from a base other than the unit Gaussian, on the device,
        seeded from ``rng`` at its first use (a run on a unit-Gaussian base
        without LARS draws nothing from ``rng`` for it)."""
        if getattr(self, "_device_generator", None) is None:
            self._device_generator = torch.Generator(device=self.device).manual_seed(
                int(self.rng.integers(0, 2**63 - 1))
            )
        return self._device_generator

    def end_iteration(self) -> None:
        """The per-epoch update of a LARS base's normalisation estimate
        (``nessai_tpu/flowmodel/base.py:1293-1299``); nothing for other
        bases."""
        if isinstance(self.flow.base, ResampledGaussian):
            self.flow.end_iteration(self.device_generator())

    def finalise(self) -> None:
        """A LARS base's final normalisation estimate
        (``nessai_tpu/flowmodel/base.py:1301-1305``); nothing for other
        bases."""
        if isinstance(self.flow.base, ResampledGaussian):
            self.flow.finalise(self.device_generator())

    def _train_step(self, x, w=None) -> torch.Tensor:
        """One optimiser step on the batch ``x`` (with weights ``w``);
        returns its loss (a device scalar, no host synchronisation)."""
        self.optimiser.zero_grad(set_to_none=True)
        loss = self._loss(x, w)
        loss.backward()
        if self.training_config.clip_grad_norm:
            _clip_by_global_norm(self._trainable(), self.training_config.clip_grad_norm)
        self.optimiser.step()
        return loss.detach()

    def _noise_sigma(self, batches):
        """The scale of the Gaussian noise added to each training row
        (one tensor per batch), or None without noise: ``noise_scale``
        (constant), or ``noise_scale`` times the row's distance to its
        nearest other training row (adaptive)."""
        tc = self.training_config
        if tc.noise_type is None or not tc.noise_scale:
            return None
        if tc.noise_type == "constant":
            return [torch.full((len(b), 1), float(tc.noise_scale), device=b.device) for b in batches]
        if tc.noise_type == "adaptive":
            from scipy.spatial.distance import cdist

            x = torch.cat(batches).cpu().numpy()
            d = cdist(x, x)
            np.fill_diagonal(d, np.inf)
            sigma = self._to_device(tc.noise_scale * d.min(axis=1))[:, None]
            return list(torch.split(sigma, [len(b) for b in batches]))
        raise ValueError(f"Unknown noise type: {tc.noise_type}")

    @torch.no_grad()
    def _maybe_init_actnorm(self, x) -> None:
        """Data-dependent actnorm initialisation: walk the chain once,
        whitening the activations at each ActNorm (not with
        ``use_actnorm_init=False``)."""
        if self._actnorm_done or not self.training_config.use_actnorm_init:
            return
        if isinstance(self.flow.bijector, Chain):
            h = self._to_device(x)
            for b in self.flow.bijector.bijectors:
                if isinstance(b, ActNorm):
                    b.data_init(h)
                h, _ = b(h)
        self._actnorm_done = True

    def train(
        self, samples, weights=None, max_epochs=None, patience=None, val_size=None, save: bool = True, output=None
    ):
        """Train the flow on ``samples`` ([n, dims]), with the weighted
        loss where ``weights`` are given. Returns the history of this
        call, ``{"loss": [...], "val_loss": [...]}``."""
        if not self.initialised:
            self.initialise()
        samples = np.asarray(samples, dtype=np.float32)
        if samples.ndim != 2:
            raise ValueError("Samples must be a 2D array")
        tc = self.training_config
        max_epochs = tc.max_epochs if max_epochs is None else max_epochs
        patience = tc.patience if patience is None else patience
        val_size = tc.val_size if val_size is None else val_size

        self._maybe_init_actnorm(samples)
        batches, val, w_batches, w_val = self.prep_data(samples, val_size, weights=weights)
        if w_batches is None:
            w_batches = [None] * len(batches)
        sigma = self._noise_sigma(batches)
        decay_steps = None
        if tc.annealing:
            # a fresh optimiser whose learning rate decays over the most
            # steps this call can take, as the JAX package anneals it
            self.reset_optimiser()
            decay_steps = max(int(max_epochs) * len(batches), 1)
        steps = 0
        history = {"loss": [], "val_loss": []}
        # as in the JAX package, the starting weights stand until an
        # epoch improves on them (a run that goes non-finite at once
        # keeps them)
        best_state = self._state_copy()
        best_val = np.inf
        best_it = 0
        for epoch in range(int(max_epochs)):
            self.flow.train()
            losses = []
            for i, (x, w) in enumerate(zip(batches, w_batches)):
                if decay_steps is not None:
                    for group in self.optimiser.param_groups:
                        group["lr"] = _cosine_decay(tc.lr, steps, decay_steps)
                if sigma is not None:
                    x = x + sigma[i] * torch.randn(x.shape, generator=self.device_generator(), device=x.device)
                losses.append(self._train_step(x, w))
                steps += 1
            loss = torch.stack(losses).mean()
            self.flow.eval()
            self.end_iteration()
            if val is not None:
                with torch.no_grad():
                    metric = self._loss(val, w_val)
                loss_v, metric_v = torch.stack([loss, metric]).tolist()
                if np.isnan(metric_v):
                    metric_v = loss_v
            else:
                loss_v = metric_v = loss.item()
            history["loss"].append(loss_v)
            history["val_loss"].append(metric_v)
            if metric_v < best_val:
                best_val = metric_v
                best_it = epoch
                best_state = self._state_copy()
            if not np.isfinite(loss_v):
                logger.warning("Training loss is not finite at epoch %d", epoch)
                break
            if epoch - best_it > patience:
                break
        self.flow.load_state_dict(best_state)
        if isinstance(self.flow.base, ResampledGaussian):
            # a larger estimate from scratch, as the JAX package's
            self.flow.base.update_log_z(50_000, decay=0.0, generator=self.device_generator())
        logger.debug("Trained %d epochs (best %d)", len(history["loss"]), best_it)
        self.history["loss"].extend(history["loss"])
        self.history["val_loss"].extend(history["val_loss"])
        out_dir = self.output if output is None else output
        if save and out_dir is not None:
            self.save_weights(os.path.join(out_dir, WEIGHTS_FILE))
        return history

    # ------------------------------------------------------------------
    # Inference (numpy in / numpy out)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward_and_log_prob(self, x):
        """x -> (z, log q(x)) as float64 numpy arrays."""
        z, log_q = self.flow.forward_and_log_prob(self._to_device(x))
        return z.double().cpu().numpy(), log_q.double().cpu().numpy()

    @torch.no_grad()
    def inverse_and_log_prob(self, z):
        """z -> (x, log q(x)) as float64 numpy arrays."""
        x, log_q = self.flow.inverse_and_log_prob(self._to_device(z))
        return x.double().cpu().numpy(), log_q.double().cpu().numpy()

    @torch.no_grad()
    def log_prob(self, x):
        return self.flow.log_prob(self._to_device(x)).double().cpu().numpy()

    @torch.no_grad()
    def base_log_prob(self, z):
        return self.flow.base_log_prob(self._to_device(z)).double().cpu().numpy()

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def save_weights(self, weights_file) -> None:
        """Save the flow's ``state_dict`` (as CPU tensors, so the file
        loads on any device), moving an existing file to
        ``<file>.old``."""
        if os.path.exists(weights_file):
            shutil.move(weights_file, weights_file + ".old")
        torch.save(_cpu_state_dict(self.flow), weights_file)
        self.weights_file = weights_file

    def load_weights(self, weights_file) -> None:
        """Load a ``state_dict`` saved by :meth:`save_weights` onto the
        flow on :attr:`device`."""
        if not self.initialised:
            self.initialise()
        state = torch.load(weights_file, map_location=self.device, weights_only=True)
        self.flow.load_state_dict(state)
        self.weights_file = weights_file
        self._actnorm_done = True

    def reload_weights(self, weights_file=None) -> None:
        """Load ``weights_file`` (by default the last file saved or
        loaded)."""
        if weights_file is None:
            weights_file = self.weights_file
        self.load_weights(weights_file)

    # ------------------------------------------------------------------
    def __getstate__(self):
        """The weights as a CPU ``state_dict``; the flow, the optimiser
        and its moments stay out of the pickle, as in the JAX package,
        so a resumed training starts AdamW afresh."""
        state = self.__dict__.copy()
        state["_state_dict"] = _cpu_state_dict(self.flow) if self.flow is not None else None
        state["flow"] = None
        state["optimiser"] = None
        state["initialised"] = False
        for name in self._generators:
            gen = state.pop(name, None)
            state[name + "_state"] = None if gen is None else (gen.get_state(), str(gen.device))
        return state

    def __setstate__(self, state):
        generators = {name: state.pop(name + "_state", None) for name in self._generators}
        saved = state.pop("_state_dict", None)
        self.__dict__.update(state)
        self._device_generator = None
        if saved is not None:
            # the new flow's seed is not drawn from the run's generator:
            # its weights are the saved ones
            rng_state = copy.deepcopy(self.rng.bit_generator.state)
            self.initialise()
            self.rng.bit_generator.state = rng_state
            self.flow.load_state_dict(saved)
            self._actnorm_done = True
        for name, gen_state in generators.items():
            if gen_state is not None:
                gen = torch.Generator(device=gen_state[1])
                gen.set_state(gen_state[0])
                setattr(self, name, gen)


def _cpu_state_dict(flow) -> dict:
    return {k: v.detach().cpu().clone() for k, v in flow.state_dict().items()}
