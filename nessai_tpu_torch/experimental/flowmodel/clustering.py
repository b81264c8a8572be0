"""Flow model conditioned on k-means cluster labels. Counterpart of
``nessai_tpu/experimental/flowmodel/clustering.py``: k-means over the
flow's training points (k chosen by the silhouette score), the cluster
label as a one-hot context of every coupling's net, and a log-density
that marginalises over the labels with the cluster weights.

k-means is Lloyd's algorithm in float32 on the flow's device in plain
PyTorch (25 iterations from centres drawn on the host), as the JAX
package runs it outside any Pallas kernel.
"""

import logging

import numpy as np
import torch
from scipy.special import logsumexp
from torch.nn import functional as F

from ...flowmodel.base import FlowModel
from ...utils.device import get_device

logger = logging.getLogger(__name__)

__all__ = ["ClusteringFlowModel", "kmeans", "silhouette_score"]

#: Lloyd iterations of :func:`kmeans`, as in the JAX package
KMEANS_ITERATIONS = 25


def _kmeans_step(x, centres):
    """One Lloyd step: the nearest centre of every row, and the centres
    moved to their rows' means (a centre without rows stays)."""
    d = torch.sum((x[:, None, :] - centres[None, :, :]) ** 2, dim=-1)
    labels = torch.argmin(d, dim=1)
    one_hot = F.one_hot(labels, centres.shape[0]).to(x.dtype)
    counts = one_hot.sum(dim=0)[:, None]
    sums = one_hot.T @ x
    return torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0), centres), labels


@torch.no_grad()
def kmeans(x: np.ndarray, k: int, rng=None, device=None):
    """Lloyd's algorithm on ``x`` ([n, d]) with ``k`` centres, started at
    ``k`` distinct rows drawn from ``rng`` (as the JAX package draws
    them), on ``device`` (None: the GPU). Returns the centres ([k, d],
    float32) and each row's label as numpy arrays."""
    if rng is None:
        rng = np.random.default_rng()
    idx = rng.choice(len(x), k, replace=False)
    x = torch.as_tensor(np.asarray(x, np.float32), device=get_device(device))
    centres = x[torch.as_tensor(idx, device=x.device)]
    for _ in range(KMEANS_ITERATIONS):
        centres, _ = _kmeans_step(x, centres)
    _, labels = _kmeans_step(x, centres)
    return centres.cpu().numpy(), labels.cpu().numpy()


def silhouette_score(x: np.ndarray, labels: np.ndarray) -> float:
    """Mean silhouette coefficient, simplified to the distances to the
    clusters' centroids (-1 for fewer than two clusters)."""
    ks = np.unique(labels)
    if len(ks) < 2:
        return -1.0
    centres = np.stack([x[labels == k].mean(axis=0) for k in ks])
    d = np.linalg.norm(x[:, None, :] - centres[None, :, :], axis=-1)
    order = np.argsort(d, axis=1)
    a = d[np.arange(len(x)), order[:, 0]]
    b = d[np.arange(len(x)), order[:, 1]]
    s = (b - a) / np.maximum(np.maximum(a, b), 1e-12)
    return float(np.mean(s))


class ClusteringFlowModel(FlowModel):
    """A :class:`FlowModel` whose flow takes a one-hot cluster label of
    ``max_clusters`` columns as its context (``flow_config`` may also
    name ``max_clusters``). The clustering state (``n_clusters``,
    ``cluster_centres``, ``cluster_weights``) is numpy."""

    def __init__(self, flow_config=None, training_config=None, output=None, rng=None, max_clusters: int = 8,
                 device=None):
        flow_config = dict(flow_config or {})
        self.max_clusters = int(flow_config.pop("max_clusters", max_clusters))
        flow_config["context_features"] = self.max_clusters
        super().__init__(
            flow_config=flow_config, training_config=training_config, output=output, rng=rng, device=device
        )
        self.n_clusters = 1
        self.cluster_centres = None
        self.cluster_weights = np.ones(1)

    def train_clustering(self, samples: np.ndarray) -> np.ndarray:
        """Choose k in 2..max_clusters by the silhouette score of k-means
        on ``samples``, keep its centres and weights, and return the
        one-hot labels of ``samples``."""
        best = (-np.inf, 1, None, None)
        for k in range(2, self.max_clusters + 1):
            if k >= len(samples):
                break
            centres, labels = kmeans(samples, k, rng=self.rng, device=self.device)
            score = silhouette_score(samples, labels)
            if score > best[0]:
                best = (score, k, centres, labels)
        score, k, centres, labels = best
        if centres is None:
            self.n_clusters = 1
            self.cluster_centres = samples.mean(axis=0, keepdims=True)
            labels = np.zeros(len(samples), dtype=int)
        else:
            logger.debug("Selected %d clusters (silhouette %.3f)", k, score)
            self.n_clusters = k
            self.cluster_centres = centres
        counts = np.bincount(labels, minlength=self.n_clusters)
        self.cluster_weights = counts / counts.sum()
        return self.one_hot(labels)

    def one_hot(self, labels: np.ndarray) -> np.ndarray:
        """``labels`` as float32 one-hot rows of ``max_clusters``
        columns."""
        out = np.zeros((len(labels), self.max_clusters), dtype=np.float32)
        out[np.arange(len(labels)), labels] = 1.0
        return out

    def assign_labels(self, samples: np.ndarray) -> np.ndarray:
        """The label of the nearest cluster centre of each sample."""
        d = np.linalg.norm(samples[:, None, :] - self.cluster_centres[None, :, :], axis=-1)
        return np.argmin(d, axis=1)

    def get_cluster_labels(self, samples: np.ndarray, clusterer=None) -> np.ndarray:
        """The nearest-centre labels of ``samples`` as an ``(n, 1)``
        column, by this model's centres or by ``clusterer`` (an object
        with ``cluster_centres`` or a ``(k, dims)`` array)."""
        samples = np.asarray(samples)
        if clusterer is None:
            return self.assign_labels(samples).reshape(-1, 1)
        centres = np.asarray(getattr(clusterer, "cluster_centres", clusterer))
        d = np.linalg.norm(samples[:, None, :] - centres[None, :, :], axis=-1)
        return np.argmin(d, axis=1).reshape(-1, 1)

    def sample_cluster_labels(self, n: int) -> np.ndarray:
        """``n`` labels drawn with the cluster weights, as an ``(n, 1)``
        column."""
        return self.rng.choice(self.n_clusters, size=(int(n), 1), p=self.cluster_weights)

    def sample_labels(self, n: int) -> np.ndarray:
        """``n`` labels drawn with the cluster weights."""
        return self.rng.choice(self.n_clusters, size=n, p=self.cluster_weights)

    def train(self, samples, conditional=None, **kwargs):
        """Train the flow on ``samples`` conditioned on ``conditional``,
        by default the one-hot labels of a new clustering of them."""
        if conditional is None:
            conditional = self.train_clustering(np.asarray(samples))
        return super().train(samples, conditional=conditional, **kwargs)

    @torch.no_grad()
    def log_prob_marginalised(self, x) -> np.ndarray:
        """``log p(x) = logsumexp_k [log p(x | k) + log w_k]`` over the
        ``n_clusters`` labels. The k conditional passes are one batched
        flow call of ``k n`` rows (the JAX package makes one call a
        label); the sum over the labels is float64 on the host, as
        there."""
        x = self._to_device(x)
        n, k = x.shape[0], self.n_clusters
        labels = torch.arange(k, device=x.device).repeat_interleave(n)
        context = F.one_hot(labels, self.max_clusters).to(x.dtype)
        log_p = self.flow.log_prob(x.repeat(k, 1), context).reshape(k, n).double().cpu().numpy()
        with np.errstate(divide="ignore"):
            log_w = np.log(self.cluster_weights)
        return logsumexp(log_p.T + log_w, axis=1)
