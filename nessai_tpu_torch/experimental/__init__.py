"""Experimental features. Counterpart of ``nessai_tpu/experimental``: the
MCMC flow proposal (``proposal.mcmc``), the k-means clustering flow
proposal with its conditional flow model (``proposal.clustering``,
``flowmodel.clustering``) and the adapters for flows defined outside the
package (``flows``)."""
