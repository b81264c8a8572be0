"""Experimental flow models. Counterpart of
``nessai_tpu/experimental/flowmodel``."""

from .clustering import ClusteringFlowModel, kmeans, silhouette_score

__all__ = ["ClusteringFlowModel", "kmeans", "silhouette_score"]
