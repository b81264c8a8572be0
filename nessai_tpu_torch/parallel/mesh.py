"""Device meshes: data-parallel training and sharded batch evaluation.
Counterpart of ``nessai_tpu/parallel/mesh.py``.

A :class:`Mesh` is an ordered tuple of ``torch.device`` objects with one
axis name. A batch is cut along its rows into contiguous, near-equal
shards in device order (:func:`shard_batch`); a flow is replicated, one
copy a further device, with the primary on ``devices[0]``. Results come
back in device order, so a sharded pass returns the rows in the order it
was given them.

A data-parallel step (:func:`make_dp_train_step`) runs the forward and
backward of every replica on its shard, each shard contributing its
part of the loss over the whole batch, sums the replicas' gradients
into the primary's in device order (so a run repeats to the bit), takes
one optimiser step on the primary and copies the parameters back to
the replicas. ``FlowModel`` clips the summed gradients between the sum
and the step. The copies are explicit tensor copies, so one code path
serves a mesh of CPU entries in the tests and a mesh of GPUs on the card.

A device may appear more than once: ``get_mesh(devices=["cpu"] * 8)``
is the counterpart of the JAX tests' eight virtual CPU devices, and
``get_mesh(devices=["cuda:0", "cuda:0"])`` runs two replicas on one
GPU. PyTorch has no virtual devices, so such a mesh serialises its
shards on one device; it exercises every path of a mesh of distinct
devices but the copies between them.
"""

import copy
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import config as global_config

__all__ = [
    "Mesh",
    "get_mesh",
    "data_sharding",
    "replicated_sharding",
    "shard_batch",
    "pad_to_multiple",
    "make_dp_train_step",
    "sharded_batch_evaluate",
]


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` in order, along the axis ``axis_name``."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "data"

    @property
    def size(self) -> int:
        """The number of entries (a repeated device counts each time)."""
        return len(self.devices)

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis_name,)

    def __len__(self) -> int:
        return self.size


def _resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: a CUDA entry
    without an index is the current GPU; a CUDA entry without a GPU, or
    past the last GPU, raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.device("cpu")
    if device.type != "cuda":
        raise ValueError(f"A mesh holds CPU or CUDA devices, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"The mesh names {device}, but no GPU is available (torch.cuda.is_available() is False). "
            "Pass devices=['cpu', ...] for a mesh on the CPU."
        )
    index = torch.cuda.current_device() if device.index is None else device.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"The mesh names {device}, but there are {torch.cuda.device_count()} GPUs")
    return torch.device("cuda", index)


def get_mesh(n_devices: Optional[int] = None, devices=None, axis_name: Optional[str] = None) -> Mesh:
    """A 1-D mesh over ``devices`` (by default every visible GPU, which
    raises without one), cut to the first ``n_devices``. A device may
    repeat. The axis is ``config.compute.data_axis`` unless named."""
    if axis_name is None:
        axis_name = global_config.compute.data_axis
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "get_mesh() spans the visible GPUs, but no GPU is available "
                "(torch.cuda.is_available() is False). Pass devices=['cpu', ...] for a mesh on the CPU."
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_resolve_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[: int(n_devices)]
    if not devices:
        raise ValueError("A mesh needs at least one device")
    return Mesh(tuple(devices), axis_name)


@dataclass(frozen=True)
class Sharding:
    """Where a value lies on a mesh: cut along its rows, one contiguous
    shard a device (``split``), or whole on every device."""

    mesh: Mesh
    split: bool

    def place(self, x) -> list:
        """``x`` (a tensor or array) placed on the mesh: its shards, one a
        device in order (near-equal, the first ``n % size`` one row
        longer; some are empty where ``n < size``), or one copy a device.
        A module is replicated: the module itself on ``devices[0]``, then
        a copy on each further device."""
        devices = self.mesh.devices
        if isinstance(x, nn.Module):
            if self.split:
                raise ValueError("A module is replicated, not split")
            return [x] + [copy.deepcopy(x).to(d) for d in devices[1:]]
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if not self.split:
            return [x.to(d) for d in devices]
        return [s.to(d) for s, d in zip(torch.tensor_split(x, len(devices)), devices)]


def data_sharding(mesh: Mesh) -> Sharding:
    """Rows cut over the mesh."""
    return Sharding(mesh, True)


def replicated_sharding(mesh: Mesh) -> Sharding:
    """One whole copy a device."""
    return Sharding(mesh, False)


def pad_to_multiple(x: np.ndarray, multiple: int):
    """Pad the batch to a multiple of ``multiple`` rows by tiling it;
    returns ``(padded, n_valid)``. Any ``n >= 1`` (also below
    ``multiple``) reaches the next multiple exactly; an empty batch
    raises."""
    x = np.asarray(x)
    n = len(x)
    if n == 0:
        raise ValueError("cannot pad an empty batch")
    pad = (-n) % multiple
    if pad:
        reps = -(-pad // n)  # ceil(pad / n)
        filler = np.concatenate([x] * reps)[:pad]
        x = np.concatenate([x, filler])
    return x, n


def shard_batch(x, mesh: Mesh) -> List[torch.Tensor]:
    """``x`` cut into contiguous, near-equal shards in device order, each
    on its device."""
    return data_sharding(mesh).place(x)


@torch.no_grad()
def _sync_replicas(replicas: Sequence[nn.Module]) -> None:
    """Copy the parameters and buffers of ``replicas[0]`` (the primary)
    into every other replica."""
    source = list(replicas[0].state_dict(keep_vars=True).values())
    for replica in replicas[1:]:
        for dst, src in zip(replica.state_dict(keep_vars=True).values(), source, strict=True):
            dst.copy_(src)


def _shards(x, mesh: Mesh):
    return [None] * mesh.size if x is None else shard_batch(x, mesh)


def _dp_backward(replicas, mesh: Mesh, x, w=None, context=None) -> torch.Tensor:
    """The forward and backward of the flow ``replicas[0]`` (its replicas
    follow, one a further device of ``mesh``) on the batch ``x``, with
    weights ``w`` and ``context``, each cut over the mesh by
    :func:`shard_batch`; leaves the whole batch's gradient in the
    primary's ``.grad`` and returns the loss, a scalar on
    ``devices[0]``.

    Each shard contributes ``-sum(w log p)`` (``-sum(log p)`` without
    weights) over the whole batch's ``max(sum(w), 1e-12)`` (its row
    count), the loss of ``FlowModel._loss``. Every replica's forward and
    backward is queued before any host read, and the replicas'
    gradients are summed into the primary's in device order."""
    xs, ws, cs = _shards(x, mesh), _shards(w, mesh), _shards(context, mesh)
    primary = replicas[0]
    device0 = mesh.devices[0]
    if w is None:
        denoms = [float(len(x))] * mesh.size
    else:
        total = torch.stack([s.sum().to(device0) for s in ws]).sum().clamp_min(1e-12)
        denoms = [total.to(d) for d in mesh.devices]
    parts = []
    for replica, x_r, w_r, c_r, denom in zip(replicas, xs, ws, cs, denoms, strict=True):
        replica.zero_grad(set_to_none=True)
        if not len(x_r):
            continue
        replica.train(primary.training)
        log_p = replica.log_prob(x_r) if c_r is None else replica.log_prob(x_r, c_r)
        num = log_p.sum() if w_r is None else (w_r * log_p).sum()
        part = -num / denom
        part.backward()
        parts.append(part.detach().to(device0))
    params = list(primary.parameters())
    for replica in replicas[1:]:
        for p, q in zip(params, replica.parameters(), strict=True):
            if q.grad is None:
                continue
            g = q.grad.to(p.device)
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.add_(g)
    return torch.stack(parts).sum()


def make_dp_train_step(flow, optimiser, mesh: Mesh):
    """One data-parallel training step of ``flow`` (a
    :class:`~nessai_tpu_torch.flows.Flow` on ``mesh.devices[0]``) with
    ``optimiser`` over its parameters: the flow is replicated once on
    each further device here. Returns ``step(x, w=None, context=None) ->
    loss``: the whole batch's gradient (:func:`_dp_backward`), one
    optimiser step on the flow, and its new parameters copied to the
    replicas."""
    replicas = replicated_sharding(mesh).place(flow)

    def step(x, w=None, context=None):
        loss = _dp_backward(replicas, mesh, x, w, context)
        optimiser.step()
        _sync_replicas(replicas)
        return loss

    step.replicas = replicas
    return step


@torch.no_grad()
def sharded_batch_evaluate(fn, x: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Evaluate the batched torch function ``fn`` (a likelihood, say)
    with the rows of ``x`` padded to a multiple of the mesh's size
    (:func:`pad_to_multiple`) and sharded over it, each shard on its
    device; returns the first ``n`` rows as a float64 numpy array."""
    x_padded, n = pad_to_multiple(np.asarray(x), mesh.size)
    outs = [fn(s) for s in shard_batch(x_padded, mesh)]
    return torch.cat([o.to(mesh.devices[0]) for o in outs]).double().cpu().numpy()[:n]
