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
arrays come in and go out as numpy, with one device-to-host copy a call;
the flow and its data live on ``device``.

A conditional flow (``context_features`` in the flow config) takes a
``conditional`` ([n, context_features]) beside its samples: training
shuffles and splits it with them and feeds it to the loss and to the
ActNorm initialisation, and every inference call passes it to the flow
(``nessai_tpu/flowmodel/base.py:422-503, 813-865, 1176-1260``).

On a device mesh (``mesh``, :mod:`nessai_tpu_torch.parallel`) the flow
lives on ``mesh.devices[0]`` with one replica on each further entry: the
batch size is rounded up to a multiple of the mesh's size (nothing is
padded), every training step is data-parallel
(:func:`~nessai_tpu_torch.parallel.make_dp_train_step`), and the
inference calls cut their rows over the mesh and gather them in order
(``nessai_tpu/flowmodel/base.py:410-412, 965-966, 1162-1168``). Every
change to the primary's weights (initialisation, resets, the ActNorm
data initialisation over the whole first batch, a LARS base's updates,
loaded weights) is copied to the replicas at once. Dropout draws each
replica's masks from its device's generator, so a run with dropout
agrees with a single-device run only statistically. Without a mesh the
inference calls take the same path (:meth:`FlowModel.sharded`) over a
one-entry mesh of ``device``.
"""

import copy
import dataclasses
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
from ..parallel.mesh import _dp_backward, _sync_replicas, get_mesh, replicated_sharding, shard_batch
from ..utils.distance import compute_minimum_distances
from ..utils.device import get_device
from ..utils.io import save_to_json
from ..utils.profiling import annotate, counts
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
    #: no mesh: the defaults of a model unpickled from before meshes
    mesh = None
    _replicas = ()
    #: the training noise's scale and type where they override the
    #: training configuration's (None: the configuration's)
    noise_scale = None
    noise_type = None
    #: while True, training moves the base distribution's parameters only
    _transform_frozen = False

    def __init__(self, flow_config=None, training_config=None, output=None, rng=None, device=None, mesh=None):
        #: an optional :class:`~nessai_tpu_torch.parallel.Mesh`: the flow
        #: lives on its first device, a replica on each further one
        self.mesh = mesh
        if mesh is None:
            self.device = get_device(device)
        else:
            if device is not None and torch.device(device).type != mesh.devices[0].type:
                raise ValueError(f"device {device} is not of the type of the mesh's first device, {mesh.devices[0]}")
            self.device = mesh.devices[0]
        #: the flow's copies on ``mesh.devices[1:]``
        self._replicas = []
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

    @property
    def optimiser_kwargs(self) -> dict:
        """The keyword arguments of the optimiser."""
        return dict(self.training_config.optimiser_kwargs or {})

    def setup_from_input_dict(self, flow_config, training_config) -> None:
        """Merge the flow and training configurations onto the defaults
        and write each to ``output`` as JSON."""
        self.flow_config = update_flow_config(flow_config)
        self.training_config = update_training_config(training_config)
        if self.output is not None:
            os.makedirs(self.output, exist_ok=True)
            save_to_json(flow_config_to_dict(self.flow_config), os.path.join(self.output, "flow_config.json"))
            save_to_json(dataclasses.asdict(self.training_config), os.path.join(self.output, "training_config.json"))

    def update_mask(self) -> None:
        """A hook for subclasses that change the flow's mask; nothing by
        default."""

    # ------------------------------------------------------------------
    def initialise(self) -> None:
        """Build the flow on the device, with weights drawn from a seed
        taken from ``rng``, and its optimiser."""
        if self.initialised:
            return
        cfg = flow_config_to_dict(self.flow_config)
        cfg["seed"] = int(self.rng.integers(0, 2**31 - 1))
        self.flow = configure_model(cfg).to(self.device)
        if self.mesh is not None:
            self._replicas = replicated_sharding(self.mesh).place(self.flow)[1:]
        self.reset_optimiser()
        self.initialised = True

    def get_optimiser(self, optimiser=None, **kwargs):
        """A new optimiser of the flow's parameters: ``optimiser`` (by
        default the configured one) at the configured learning rate, with
        the configured keyword arguments updated by ``kwargs``, at optax's
        defaults (see :func:`_get_optimiser`). Training clips the
        gradients itself (``clip_grad_norm``)."""
        if not self.initialised:
            self.initialise()
        tc = self.training_config
        options = dict(tc.optimiser_kwargs)
        options.update(kwargs)
        return _get_optimiser(tc.optimiser if optimiser is None else optimiser, self.flow.parameters(), tc.lr, **options)

    def move_to(self, device, update_default: bool = False) -> None:
        """Move the flow, its replicas and its optimiser's moments to
        ``device`` (None is the GPU, as everywhere in the package; "cpu"
        only when asked for). The inference calls run where the flow is;
        with ``update_default`` the model's training data go there too,
        else the next training moves the flow back. On a mesh every entry
        moves to ``device`` and the default is updated."""
        device = get_device(device)
        if self.mesh is not None:
            self.mesh = get_mesh(devices=[device] * self.mesh.size)
            update_default = True
        if self.flow is not None:
            for flow in self.replicas:
                flow.to(device)
            if self.optimiser is not None:
                for state in self.optimiser.state.values():
                    for k, v in state.items():
                        if torch.is_tensor(v) and v.dim():
                            state[k] = v.to(device)
        if update_default and not _same_device(device, self.device):
            self.device = device
            # a generator cannot change its device
            self._device_generator = None

    @property
    def _flow_device(self) -> torch.device:
        """Where the flow is: :attr:`device` unless :meth:`move_to` moved
        it elsewhere."""
        if self.flow is None:
            return self.device
        return next(self.flow.parameters()).device

    def numpy_array_to_tensor(self, array) -> torch.Tensor:
        """``array`` as a tensor of the training dtype on the model's
        device."""
        return torch.as_tensor(np.asarray(array), dtype=getattr(torch, self.training_config.dtype), device=self.device)

    def freeze_transform(self) -> None:
        """Freeze the transform: training moves only the base
        distribution's parameters (the gradients, their clipping and the
        optimiser's moments are those of every parameter, as where the
        JAX package masks the transform's updates)."""
        if not self._transform_frozen:
            self._transform_frozen = True
            logger.debug("Transform parameters frozen")

    def unfreeze_transform(self) -> None:
        """Undo :meth:`freeze_transform`."""
        if self._transform_frozen:
            self._transform_frozen = False
            logger.debug("Transform parameters unfrozen")

    def _transform_parameters(self) -> list:
        base = {id(p) for p in self.flow.base.parameters()}
        return [p for p in self.flow.parameters() if id(p) not in base]

    @property
    def replicas(self) -> list:
        """The flow and its replicas, one a mesh entry (the flow alone
        without a mesh)."""
        return [self.flow] + list(self._replicas)

    def refresh_replicas(self) -> None:
        """Copy the flow's weights and buffers to its replicas (nothing
        without a mesh)."""
        if self.mesh is not None and self.flow is not None:
            _sync_replicas(self.replicas)

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
        self.refresh_replicas()
        self.reset_optimiser()

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def check_batch_size(self, x, batch_size=None, min_fraction=0.1) -> int:
        """The batch size that training on ``x`` (the training rows, or
        their number) takes: ``batch_size`` (by default the configured
        one), all rows for "all", at most the number of rows, rounded up
        to a multiple of a mesh's size. Nothing is padded, so
        ``min_fraction`` never changes it; a batch size of 1 raises."""
        n_train = len(x) if hasattr(x, "__len__") else int(x)
        if batch_size is None:
            batch_size = self.training_config.batch_size
        if batch_size == "all":
            batch_size = n_train
        elif not isinstance(batch_size, int) or isinstance(batch_size, bool):
            raise RuntimeError(f"Unknown batch size: {batch_size}")
        if batch_size == 1:
            raise ValueError("Cannot use a batch size of 1!")
        if self.mesh is not None:
            # a multiple of the mesh's size, as the JAX package rounds it;
            # the port pads nothing, so the last batch may be shorter
            n_dev = self.mesh.size
            batch_size = -(-int(batch_size) // n_dev) * n_dev
        return min(int(batch_size), n_train)

    def prep_data(self, samples, val_size, batch_size=None, weights=None, conditional=None):
        """Shuffle, split off ``val_size`` for validation and cut the
        training rows into batches (the last one may be smaller).
        ``weights`` (one per sample) are shuffled and split with the
        samples. Returns ``(train_batches, val, weight_batches,
        val_weights)`` as device tensors; the weight entries are None
        without weights. With a ``conditional`` (one row per sample),
        shuffled and split with the samples too, its batches and
        validation rows follow: ``(..., conditional_batches,
        val_conditional)``."""
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
        if conditional is not None:
            conditional = np.asarray(conditional, dtype=np.float32)
            if len(conditional) != n:
                raise ValueError(f"{len(conditional)} conditional rows for {n} samples")
            conditional = conditional[perm]
        n_val = int(round((val_size or 0.0) * n))
        n_train = n - n_val
        if n_train < 2:
            raise ValueError(f"Too few training samples: {n_train}")
        batch_size = self.check_batch_size(n_train, batch_size)
        train = self._to_device(samples[:n_train])
        batches = list(torch.split(train, batch_size))
        val = self._to_device(samples[n_train:]) if n_val > 0 else None
        if weights is None:
            out = (batches, val, None, None)
        else:
            weights = weights[perm]
            w_batches = list(torch.split(self._to_device(weights[:n_train]), batch_size))
            w_val = self._to_device(weights[n_train:]) if n_val > 0 else None
            out = (batches, val, w_batches, w_val)
        if conditional is None:
            return out
        c_batches = list(torch.split(self._to_device(conditional[:n_train]), batch_size))
        c_val = self._to_device(conditional[n_train:]) if n_val > 0 else None
        return out + (c_batches, c_val)

    def _state_copy(self) -> dict:
        return {k: v.detach().clone() for k, v in self.flow.state_dict().items()}

    def _trainable(self):
        return [p for p in self.flow.parameters() if p.requires_grad]

    def _loss(self, x, w=None, context=None) -> torch.Tensor:
        """Mean negative log-density of the batch ``x`` (given its
        ``context``); with weights ``w``, the JAX package's weighted loss
        ``-sum(w log p) / max(sum(w), 1e-12)``."""
        log_p = self.flow.log_prob(x, context)
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
            self.refresh_replicas()

    def finalise(self) -> None:
        """A LARS base's final normalisation estimate
        (``nessai_tpu/flowmodel/base.py:1301-1305``); nothing for other
        bases."""
        if isinstance(self.flow.base, ResampledGaussian):
            self.flow.finalise(self.device_generator())
            self.refresh_replicas()

    def _train_step(self, x, w=None, context=None) -> torch.Tensor:
        """One optimiser step on the batch ``x`` (with weights ``w`` and
        its ``context``); returns its loss (a device scalar, no host
        synchronisation)."""
        if self.mesh is None:
            self.optimiser.zero_grad(set_to_none=True)
            loss = self._loss(x, w) if context is None else self._loss(x, w, context)
            loss.backward()
            loss = loss.detach()
        else:
            loss = _dp_backward(self.replicas, self.mesh, x, w, context)
        if self.training_config.clip_grad_norm:
            _clip_by_global_norm(self._trainable(), self.training_config.clip_grad_norm)
        frozen = self._transform_parameters() if self._transform_frozen else []
        kept = [p.detach().clone() for p in frozen]
        self.optimiser.step()
        with torch.no_grad():
            for p, v in zip(frozen, kept):
                p.copy_(v)
        self.refresh_replicas()
        return loss

    def _noise_sigma(self, batches):
        """The scale of the Gaussian noise added to each training row
        (one tensor per batch), or None without noise: ``noise_scale``
        (constant), or ``noise_scale`` times the row's distance to its
        nearest other training row (adaptive)."""
        tc = self.training_config
        noise_type = self.noise_type or tc.noise_type
        noise_scale = self.noise_scale if self.noise_scale is not None else tc.noise_scale
        if noise_type is None or not noise_scale:
            return None
        if noise_type == "constant":
            return [torch.full((len(b), 1), float(noise_scale), device=b.device) for b in batches]
        if noise_type == "adaptive":
            x = torch.cat(batches).cpu().numpy()
            counts.host_reads += 1
            sigma = self._to_device(noise_scale * compute_minimum_distances(x))[:, None]
            return list(torch.split(sigma, [len(b) for b in batches]))
        raise ValueError(f"Unknown noise type: {noise_type}")

    @torch.no_grad()
    def _maybe_init_actnorm(self, x, conditional=None) -> None:
        """Data-dependent actnorm initialisation: walk the chain once
        (with the ``conditional``), whitening the activations at each
        ActNorm (not with ``use_actnorm_init=False``)."""
        if self._actnorm_done or not self.training_config.use_actnorm_init:
            return
        if isinstance(self.flow.bijector, Chain):
            h = self._to_device(x)
            context = self._to_device_or_none(conditional)
            for b in self.flow.bijector.bijectors:
                if isinstance(b, ActNorm):
                    b.data_init(h)
                h, _ = b(h, context)
        self._actnorm_done = True
        self.refresh_replicas()

    def train(
        self,
        samples,
        weights=None,
        max_epochs=None,
        patience=None,
        val_size=None,
        save: bool = True,
        output=None,
        conditional=None,
    ):
        """Train the flow on ``samples`` ([n, dims]), with the weighted
        loss where ``weights`` are given and conditioned on
        ``conditional`` ([n, context_features]) where it is. Returns the
        history of this call, ``{"loss": [...], "val_loss": [...]}``.
        Each epoch is traced as the span ``epoch`` (its index), with
        ``train_step`` (each optimiser step), ``validation`` (the host's
        read of the epoch's losses) and ``state_copy`` (a copy of the best
        weights) under it; the weight file as ``save_weights``."""
        if not self.initialised:
            self.initialise()
        if not _same_device(self._flow_device, self.device):
            self.move_to(self.device)
        samples = np.asarray(samples, dtype=np.float32)
        if samples.ndim != 2:
            raise ValueError("Samples must be a 2D array")
        tc = self.training_config
        max_epochs = tc.max_epochs if max_epochs is None else max_epochs
        patience = tc.patience if patience is None else patience
        val_size = tc.val_size if val_size is None else val_size

        self._maybe_init_actnorm(samples, conditional)
        prepared = self.prep_data(samples, val_size, weights=weights, conditional=conditional)
        batches, val, w_batches, w_val = prepared[:4]
        if w_batches is None:
            w_batches = [None] * len(batches)
        c_batches, c_val = prepared[4:] if conditional is not None else ([None] * len(batches), None)
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
            with annotate("epoch", index=epoch):
                self.flow.train()
                losses = []
                for i, (x, w, c) in enumerate(zip(batches, w_batches, c_batches)):
                    if decay_steps is not None:
                        for group in self.optimiser.param_groups:
                            group["lr"] = _cosine_decay(tc.lr, steps, decay_steps)
                    if sigma is not None:
                        x = x + sigma[i] * torch.randn(x.shape, generator=self.device_generator(), device=x.device)
                    with annotate("train_step"):
                        losses.append(self._train_step(x, w) if c is None else self._train_step(x, w, c))
                    steps += 1
                loss = torch.stack(losses).mean()
                self.flow.eval()
                self.end_iteration()
                with annotate("validation"):
                    if val is not None:
                        with torch.no_grad():
                            metric = self._loss(val, w_val) if c_val is None else self._loss(val, w_val, c_val)
                        loss_v, metric_v = torch.stack([loss, metric]).tolist()
                        if np.isnan(metric_v):
                            metric_v = loss_v
                    else:
                        loss_v = metric_v = loss.item()
                    counts.host_reads += 1
                history["loss"].append(loss_v)
                history["val_loss"].append(metric_v)
                if metric_v < best_val:
                    best_val = metric_v
                    best_it = epoch
                    with annotate("state_copy"):
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
        self.refresh_replicas()
        logger.debug("Trained %d epochs (best %d)", len(history["loss"]), best_it)
        self.history["loss"].extend(history["loss"])
        self.history["val_loss"].extend(history["val_loss"])
        out_dir = self.output if output is None else output
        if save and out_dir is not None:
            self.save_weights(os.path.join(out_dir, WEIGHTS_FILE))
        return history

    # ------------------------------------------------------------------
    # Inference (numpy in / numpy out, one device-to-host copy a call)
    # ------------------------------------------------------------------
    def _to_device_or_none(self, x):
        return None if x is None else self._to_device(x)

    @staticmethod
    def _to_host(points, per_row):
        """``points`` [n, d] and ``per_row`` [n] as float64 numpy arrays,
        through one device-to-host copy."""
        out = torch.cat([points, per_row[:, None]], dim=1).double().cpu().numpy()
        counts.host_reads += 1
        return out[:, :-1], out[:, -1]

    def sharded(self, fn, *tensors, flows=None):
        """``fn(flow, *shards)`` on every entry of the mesh (a one-entry
        mesh of :attr:`device` without one): the rows of each of
        ``tensors`` (tensors or arrays; None passes through) cut in order
        over the mesh, each shard on its device with that device's
        replica (or the entry's flow of ``flows``). Each output of ``fn``
        must lie on its shard's device; they are gathered in order on
        ``devices[0]``. The first entry always runs, so zero rows give
        empty outputs."""
        flows = self.replicas if flows is None else flows
        mesh = get_mesh(devices=[self._flow_device]) if self.mesh is None else self.mesh
        cut = [shard_batch(t, mesh) if t is not None else [None] * mesh.size for t in tensors]
        parts = []
        for r, (flow, device) in enumerate(zip(flows, mesh.devices, strict=True)):
            shards = [c[r] for c in cut]
            if r and not len(shards[0]):
                continue
            if isinstance(flow, torch.nn.Module) and flow is not flows[0]:
                flow.train(flows[0].training)
            out = fn(flow, *(None if s is None else s.to(torch.float32) for s in shards))
            out = out if isinstance(out, tuple) else (out,)
            for o in out:
                if o.device != device:
                    raise RuntimeError(f"a shard of the mesh computed on {o.device}, not on its device {device}")
            parts.append(out)
        if len(parts) == 1:
            gathered = parts[0]
        else:
            gathered = tuple(torch.cat([p[i].to(self.device) for p in parts]) for i in range(len(parts[0])))
        return gathered if len(gathered) > 1 else gathered[0]

    @torch.no_grad()
    def forward_and_log_prob(self, x, conditional=None):
        """x -> (z, log q(x)) as float64 numpy arrays."""
        return self._to_host(*self.sharded(lambda f, a, c: f.forward_and_log_prob(a, c), _f32(x), _f32(conditional)))

    @torch.no_grad()
    def forward(self, x, conditional=None):
        """x -> (z, log|dz/dx|) as float64 numpy arrays."""
        return self._to_host(*self.sharded(lambda f, a, c: f(a, c), _f32(x), _f32(conditional)))

    @torch.no_grad()
    def inverse(self, z, conditional=None):
        """z -> (x, log|dx/dz|) as float64 numpy arrays."""
        return self._to_host(*self.sharded(lambda f, a, c: f.inverse(a, c), _f32(z), _f32(conditional)))

    def tempered_inverse(self, zt, temperature=1.0, context=None, flow=None):
        """Device tensors ``zt`` -> ``(x, log q(x))``, with the tempered
        latent density ``base(z / sqrt(T)) - (d / 2) log T`` where the
        ``temperature`` T is not 1 (``nessai_tpu/flowmodel/base.py:
        1196-1222``). ``flow`` is a replica to run it on (by default the
        flow); :meth:`sharded_tempered_inverse` cuts it over the mesh."""
        flow = self.flow if flow is None else flow
        if temperature in (None, 1.0):
            return flow.inverse_and_log_prob(zt, context)
        x, log_j = flow.inverse(zt, context)
        return x, _tempered_base_log_prob(flow, zt, temperature) - log_j

    def sharded_tempered_inverse(self, zt, temperature=1.0, context=None):
        """:meth:`tempered_inverse` with the rows cut over the mesh."""
        return self.sharded(lambda f, z, c: self.tempered_inverse(z, temperature, c, flow=f), zt, context)

    @torch.no_grad()
    def inverse_and_log_prob(self, z, conditional=None, temperature=None):
        """z -> (x, log q(x)) as float64 numpy arrays, the latent density
        tempered at ``temperature`` (see :meth:`tempered_inverse`)."""
        x, log_q = self.sharded_tempered_inverse(_f32(z), temperature, _f32(conditional))
        return self._to_host(x, log_q)

    @torch.no_grad()
    def log_prob(self, x, conditional=None):
        out = self.sharded(lambda f, a, c: f.log_prob(a, c), _f32(x), _f32(conditional))
        counts.host_reads += 1
        return out.double().cpu().numpy()

    @torch.no_grad()
    def sample(self, n: int = 1, conditional=None):
        """``n`` draws from the flow (given ``conditional``, one row per
        draw) as a float64 numpy array; the latent draws come from
        :meth:`device_generator` on the first device, then inverted shard
        by shard)."""
        z = self._sample_base(n)
        x = self.sharded(lambda f, a, c: f.inverse(a, c)[0], z, _f32(conditional))
        counts.host_reads += 1
        return x.double().cpu().numpy()

    def _sample_base(self, n: int) -> torch.Tensor:
        """``n`` latent draws from :meth:`device_generator`, where the
        flow is."""
        return self.flow.sample_base(int(n), self.device_generator()).to(self._flow_device)

    @torch.no_grad()
    def sample_and_log_prob(self, N: int = 1, z=None, alt_dist=None, conditional=None):
        """``N`` draws from the flow and their log-density, as float64
        numpy arrays; given latent points ``z``, those points through the
        inverse instead, their density taken from ``alt_dist`` (an object
        with ``log_prob(z)``) where it is given."""
        if z is None:
            z = self._sample_base(N)
        else:
            z = torch.as_tensor(_f32(z), device=self._flow_device)

        def fn(f, a, c):
            x, log_j = f.inverse(a, c)
            return x, f.base_log_prob(a) - log_j, log_j

        x, log_p, log_j = self.sharded(fn, z, _f32(conditional))
        x, log_p = self._to_host(x, log_p)
        if alt_dist is not None:
            log_p = np.asarray(alt_dist.log_prob(z.cpu().numpy().astype(np.float64))) - log_j.double().cpu().numpy()
            counts.host_reads += 2
        return x, log_p

    @torch.no_grad()
    def sample_latent_distribution(self, n: int = 1, context=None) -> np.ndarray:
        """``n`` draws from the latent distribution, as float64 numpy;
        a ``context`` raises, as the JAX package's."""
        if context is not None:
            raise NotImplementedError("Conditional latent sampling is not supported")
        counts.host_reads += 1
        return self._sample_base(n).double().cpu().numpy()

    @torch.no_grad()
    def base_log_prob(self, z, temperature=None):
        """The latent log-density of ``z``, tempered at ``temperature``
        where it is not 1 (see :meth:`tempered_inverse`)."""
        zt = torch.as_tensor(_f32(z), device=self._flow_device)
        counts.host_reads += 1
        return _tempered_base_log_prob(self.flow, zt, temperature).double().cpu().numpy()

    def base_distribution_log_prob(self, z, temperature=None):
        """An alias of :meth:`base_log_prob`."""
        return self.base_log_prob(z, temperature=temperature)

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def save_weights(self, weights_file) -> None:
        """Save the flow's ``state_dict`` (as CPU tensors, so the file
        loads on any device), moving an existing file to
        ``<file>.old``. Traced as the span ``save_weights``."""
        with annotate("save_weights"):
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
        self.refresh_replicas()
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
        # no device of a mesh in the pickle: a resumed model runs on one
        # device, as the JAX proposal drops its mesh
        state["mesh"] = None
        state["_replicas"] = []
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


def _tempered_base_log_prob(flow, zt, temperature):
    """The base log-density of ``zt`` at ``temperature`` T:
    ``base(z / sqrt(T)) - (d / 2) log T`` (the base's own where T is 1)."""
    if temperature in (None, 1.0):
        return flow.base_log_prob(zt)
    sqrt_t = float(np.sqrt(temperature))
    return flow.base_log_prob(zt / sqrt_t) - zt.shape[-1] * float(np.log(sqrt_t))


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether ``a`` and ``b`` name one device ("cuda" is the current
    GPU, which tensors report as "cuda:0")."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _f32(x):
    """A host array as float32 numpy (None passes through), ready to cut
    over a mesh."""
    return None if x is None else np.asarray(x, np.float32)


def _cpu_state_dict(flow) -> dict:
    state = flow.state_dict()
    counts.host_reads += len(state)
    return {k: v.detach().cpu().clone() for k, v in state.items()}
