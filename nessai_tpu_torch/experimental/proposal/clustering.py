"""Clustering flow proposal. Counterpart of
``nessai_tpu/experimental/proposal/clustering.py``: a flow proposal whose
flow is conditioned on k-means cluster labels. Each training clusters the
training points in the flow's space first; each backward pass draws a
label for every latent point from the cluster weights, inverts the flow
under it, and takes log q marginalised over the labels.

There is no device inverse here (the labels are drawn on the host), so
the populate takes the rounds through :meth:`backward_pass` and never the
device populate loop, as in the JAX package; the nested sampler then
steps through the flow phase's pools on the host.
"""

import numpy as np

from ...proposal.flowproposal import FlowProposal
from ..flowmodel.clustering import ClusteringFlowModel

__all__ = ["ClusteringFlowProposal"]


class ClusteringFlowProposal(FlowProposal):
    """:class:`FlowProposal` with a flow conditioned on up to
    ``max_clusters`` (alias ``max_n_clusters``) k-means clusters."""

    uses_device_inverse = False

    def __init__(self, model, max_clusters: int = 8, max_n_clusters=None, **kwargs):
        super().__init__(model, **kwargs)
        if max_n_clusters is not None:
            max_clusters = max_n_clusters
        self.max_clusters = int(max_clusters)

    @property
    def max_n_clusters(self) -> int:
        return self.max_clusters

    def make_flow_model(self, flow_config: dict) -> ClusteringFlowModel:
        return ClusteringFlowModel(
            flow_config=flow_config,
            training_config=self.training_config,
            output=self.output,
            rng=self.rng,
            max_clusters=self.max_clusters,
            device=self.device,
        )

    def _train_flow(self, x_prime):
        conditional = self.flow.train_clustering(x_prime)
        return self.flow.train(x_prime, conditional=conditional, save=self.save_flow_weights), conditional

    def backward_pass(self, z, rescale=True, discard_nans=True, return_z=False, return_unit_hypercube=None):
        """z -> (x, log q(x)): the flow's inverse under labels drawn from
        the cluster weights, log q marginalised over the labels, then as
        :meth:`BaseFlowProposal.backward_pass` (no latent temperature, as
        in the JAX package)."""
        labels = self.flow.sample_labels(len(z))
        x_prime_array, _ = self.flow.inverse(z, conditional=self.flow.one_hot(labels))
        log_q_prime = self.flow.log_prob_marginalised(x_prime_array)
        x_prime = np.zeros(len(x_prime_array), dtype=self.x_prime_dtype)
        for i, p in enumerate(self.prime_parameters):
            x_prime[p] = x_prime_array[:, i]
        x, log_j_inv = self.inverse_rescale(x_prime, return_unit_hypercube=True)
        return self._keep_in_bounds(x, log_q_prime - log_j_inv, z, discard_nans, return_z, return_unit_hypercube)

    def __getstate__(self):
        """The clustering (labels' count, centres and weights) goes into
        the pickle with the proposal, so that a resumed flow draws the
        labels it was trained on."""
        state = super().__getstate__()
        if self.flow is not None:
            state["_clusters"] = (self.flow.n_clusters, self.flow.cluster_centres, self.flow.cluster_weights)
        return state

    def resume(self, model, *args, **kwargs) -> None:
        super().resume(model, *args, **kwargs)
        clusters = self.__dict__.pop("_clusters", None)
        if clusters is not None:
            self.flow.n_clusters, self.flow.cluster_centres, self.flow.cluster_weights = clusters
