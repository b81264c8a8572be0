"""FlowProposal: the flagship proposal. Counterpart of
``nessai_tpu/proposal/flowproposal/flowproposal.py`` (its ``rounds``
populate).

Each populate round draws latent points (the truncated Gaussian on the
host, from ``self.rng``, or the flow's base on the device), lets the
truncation rules cut them, then makes one device call,
:meth:`FlowProposal._fused_backward`: the flow inverse (four
affine-coupling kernel launches for the flagship RealNVP), the base
log-density, the inverse reparameterisation (each stack member's
``torch_inverse``), the prior-bounds check and, where the populate fuses
it, the model's ``torch_log_likelihood``. The rules then cut the draws
after the inverse and after the likelihood, and rejection sampling
against the prior runs on the host.
"""

import datetime
import logging
import warnings
from typing import Optional

import numpy as np
import torch
from scipy.special import logsumexp

from ...flows.distributions import StandardNormal
from ...livepoint import empty_structured_array
from .base import BaseFlowProposal
from .truncation import TruncationScheme

logger = logging.getLogger(__name__)

__all__ = ["FlowProposal"]


class FlowProposal(BaseFlowProposal):
    """Flow proposal with latent truncation and rejection sampling.

    Beyond :class:`BaseFlowProposal`:

    - ``drawsize``: latent draws a round (default: the unscaled poolsize,
      scaled up by the previous populate's 1/acceptance, capped);
    - the truncation (:meth:`configure_truncation`): by default the
      latent radius holding ``volume_fraction`` of the latent mass;
    - ``accumulate_weights``: gather every round's draws and reject once
      when the expected number accepted reaches the pool size;
    - ``max_samples``: latent draws after which one populate gives up
      (default 1,000,000);
    - ``latent_temperature``: the latent draws of the base are scaled by
      its square root, and log q is the tempered density;
    - ``fuse_likelihood``: True evaluates a device likelihood on every
      draw in the populate's device call; False evaluates it only on the
      accepted pool; None (default) fuses wherever the model has a
      device likelihood. A rule that needs the likelihood forces fusing;
    - ``populate_mode``: ``"auto"`` and ``"rounds"`` both run the rounds
      populate.
    """

    #: cap on the acceptance-adaptive latent draw scale
    _max_draw_scale: float = 32.0

    def __init__(
        self,
        model,
        drawsize: Optional[int] = None,
        truncation=None,
        expansion_fraction: float = 4.0,
        fuzz: float = 1.0,
        accumulate_weights: bool = False,
        max_samples: Optional[int] = None,
        latent_temperature: float = 1.0,
        constant_volume_mode: bool = True,
        volume_fraction: float = 0.95,
        fuse_likelihood: Optional[bool] = None,
        populate_mode: str = "auto",
        truncation_method=None,
        truncation_methods=None,
        truncation_kwargs=None,
        truncate_log_q: bool = False,
        enforce_likelihood_threshold: bool = False,
        fixed_radius=None,
        radius_mode=None,
        min_radius=None,
        max_radius=None,
        compute_radius_with_all=None,
        latent_radius_kwargs=None,
        default_latent_radius: bool = False,
        latent_prior=None,
        **kwargs,
    ):
        super().__init__(model, **kwargs)
        self.accumulate_weights = accumulate_weights
        self.max_samples = 1_000_000 if max_samples is None else int(max_samples)
        self.configure_population(drawsize, latent_prior=latent_prior, latent_temperature=latent_temperature)
        self.fuse_likelihood = fuse_likelihood
        if populate_mode == "device_loop":
            raise NotImplementedError(
                "populate_mode='device_loop' (the single-dispatch device populate loop) is not in the "
                "PyTorch port yet (ROADMAP §1 item 7); 'auto' and 'rounds' run the rounds populate"
            )
        if populate_mode not in ("auto", "rounds"):
            raise ValueError(f"Unknown populate_mode: {populate_mode} (expected auto, rounds or device_loop)")
        self.populate_mode = populate_mode
        self._fuse_likelihood_resolved = None
        self.configure_truncation(
            truncation=truncation,
            truncation_method=truncation_method,
            truncation_methods=truncation_methods,
            truncation_kwargs=truncation_kwargs,
            truncate_log_q=truncate_log_q,
            enforce_likelihood_threshold=enforce_likelihood_threshold,
            fixed_radius=fixed_radius,
            radius_mode=radius_mode,
            min_radius=min_radius,
            max_radius=max_radius,
            compute_radius_with_all=compute_radius_with_all,
            constant_volume_mode=constant_volume_mode,
            volume_fraction=volume_fraction,
            fuzz=fuzz,
            expansion_fraction=expansion_fraction,
            latent_radius_kwargs=latent_radius_kwargs,
            default_latent_radius=default_latent_radius,
        )

    def configure_population(self, drawsize=None, latent_prior=None, latent_temperature=None) -> None:
        """``drawsize``, the deprecated ``latent_prior`` (a warning; the
        latent draws always come from the flow's base, truncated or
        tempered) and ``latent_temperature`` (a positive float; None is
        1)."""
        self.drawsize = drawsize
        if latent_temperature is None:
            latent_temperature = 1.0
        if isinstance(latent_temperature, bool) or not isinstance(latent_temperature, (int, float)):
            raise TypeError("latent_temperature must be a float")
        if latent_temperature <= 0.0:
            raise ValueError("latent_temperature must be positive")
        self.latent_temperature = float(latent_temperature)
        if latent_prior is not None:
            warnings.warn(
                "latent_prior is deprecated; latent sampling is always the flow's (optionally "
                "truncated/tempered) base distribution",
                DeprecationWarning,
                stacklevel=2,
            )

    def configure_truncation(
        self,
        truncation=None,
        truncation_method=None,
        truncation_methods=None,
        truncation_kwargs=None,
        truncate_log_q: bool = False,
        enforce_likelihood_threshold: bool = False,
        fixed_radius=None,
        radius_mode=None,
        min_radius=None,
        max_radius=None,
        compute_radius_with_all=None,
        constant_volume_mode: bool = True,
        volume_fraction: float = 0.95,
        fuzz: float = 1.0,
        expansion_fraction: float = 4.0,
        latent_radius_kwargs=None,
        default_latent_radius: bool = False,
    ) -> None:
        """The truncation config, as the JAX package builds it:
        ``truncation`` (None, a name, a list or a dict of name ->
        keywords), or ``truncation_method(s)`` with ``truncation_kwargs``;
        the deprecated booleans ``truncate_log_q`` and
        ``enforce_likelihood_threshold`` add their rules;
        ``fixed_radius``, ``radius_mode``, ``min_radius``, ``max_radius``
        and ``latent_radius_kwargs`` go to the latent radius. Without any
        of these the latent radius is ``constant_volume`` at
        ``volume_fraction`` (or ``adaptive`` with ``expansion_fraction``
        when ``constant_volume_mode`` is False)."""
        if truncation_method is not None and truncation_methods is not None:
            raise ValueError("Specify only one of truncation_method or truncation_methods")
        if truncation is None and (truncation_method is not None or truncation_methods is not None):
            if truncation_methods is None:
                methods = [truncation_method]
            elif isinstance(truncation_methods, str):
                methods = [truncation_methods]
            else:
                methods = list(truncation_methods)
            methods = list(dict.fromkeys(methods))
            t_kwargs = dict(truncation_kwargs or {})
            if (
                isinstance(truncation_method, str)
                and truncation_method not in t_kwargs
                and t_kwargs
                and not any(isinstance(v, dict) for v in t_kwargs.values())
            ):
                t_kwargs = {truncation_method: t_kwargs}
            for name, v in t_kwargs.items():
                if v is not None and not isinstance(v, dict):
                    raise TypeError(f"Truncation kwargs for {name} must be a dictionary")
            truncation = {name: dict(t_kwargs.get(name) or {}) for name in methods}
        if compute_radius_with_all is not None:
            warnings.warn(
                "compute_radius_with_all is deprecated: the adaptive latent radius always encloses the "
                "full training set",
                DeprecationWarning,
                stacklevel=2,
            )
        extra_radius_kwargs = {}
        if fixed_radius is not None:
            extra_radius_kwargs["mode"] = "fixed"
            extra_radius_kwargs["radius"] = float(fixed_radius)
        if radius_mode is not None:
            extra_radius_kwargs["mode"] = radius_mode
        if min_radius is not None:
            extra_radius_kwargs["min_radius"] = float(min_radius)
        if max_radius is not None:
            extra_radius_kwargs["max_radius"] = float(max_radius)
        if latent_radius_kwargs:
            extra_radius_kwargs = {**dict(latent_radius_kwargs), **extra_radius_kwargs}
            if truncation is None and not default_latent_radius:
                truncation = {"latent_radius": {}}
        if truncation is None and (default_latent_radius or constant_volume_mode):
            truncation = {"latent_radius": {"mode": "constant_volume", "q": volume_fraction, "fuzz": fuzz}}
        elif truncation is None:
            truncation = {
                "latent_radius": {"mode": "adaptive", "expansion_fraction": expansion_fraction, "fuzz": fuzz}
            }
        if isinstance(truncation, str):
            truncation = {truncation: {}}
        elif isinstance(truncation, (list, tuple)):
            truncation = {name: {} for name in truncation}
        if isinstance(truncation, dict):
            truncation = {k: dict(v or {}) for k, v in truncation.items()}
            if truncate_log_q:
                truncation.setdefault("min_log_q", {})
            if enforce_likelihood_threshold:
                truncation.setdefault("likelihood_threshold", {})
            if extra_radius_kwargs:
                truncation.setdefault("latent_radius", {}).update(extra_radius_kwargs)
        self._truncation_config = truncation
        self._truncation_scheme = None

    def initialise(self, resumed: bool = False) -> None:
        super().initialise(resumed=resumed)
        if self._truncation_scheme is None:
            self._truncation_scheme = TruncationScheme.from_config(self._truncation_config, rng=self.rng)
        #: stack members whose host inverse has been logged
        self._logged_host_inverse = set()

    # ------------------------------------------------------------------
    # The truncation scheme
    # ------------------------------------------------------------------
    @property
    def truncation(self) -> TruncationScheme:
        """The truncation scheme (built at the first use)."""
        if self._truncation_scheme is None:
            self._truncation_scheme = TruncationScheme.from_config(self._truncation_config, rng=self.rng)
        return self._truncation_scheme

    def get_truncation_rule(self, name: str):
        return self.truncation.get_rule(name)

    @property
    def truncation_methods(self):
        return self.truncation.rule_names

    @property
    def truncate_log_q(self) -> bool:
        return "min_log_q" in self.truncation_methods

    @property
    def enforce_likelihood_threshold(self) -> bool:
        return "likelihood_threshold" in self.truncation_methods

    @property
    def requires_training_latent(self) -> bool:
        return self.truncation.requires_training_latent

    @property
    def latent_is_unit_gaussian(self) -> bool:
        """Whether the flow's base is the unit Gaussian, whose truncated
        draws the latent radius makes exactly on the host."""
        return type(self.flow.flow.base) is StandardNormal

    @property
    def _draw_n(self) -> int:
        """Latent draws per populate round: ``drawsize``, or the unscaled
        poolsize scaled up by the previous populate's 1/acceptance
        (capped)."""
        if self.drawsize:
            return int(self.drawsize)
        n = int(self._poolsize)
        acc = self.population_acceptance
        if acc is not None and np.isfinite(acc) and 0 < acc < 1:
            n = int(n * min(max(1.0 / acc, 1.0), self._max_draw_scale))
        return n

    def _resolve_fuse_likelihood(self) -> bool:
        """Whether the populate's device call also evaluates the
        likelihood (decided once): a rule that needs the likelihood forces
        it, else ``fuse_likelihood``, else fused. Only a model with a
        device likelihood fuses it."""
        if self._fuse_likelihood_resolved is None:
            if self.truncation.requires_log_likelihood:
                self._fuse_likelihood_resolved = True
            elif self.fuse_likelihood is not None:
                self._fuse_likelihood_resolved = bool(self.fuse_likelihood)
            else:
                self._fuse_likelihood_resolved = True
        return self._fuse_likelihood_resolved and self.model.has_torch_likelihood

    @property
    def _can_fuse_populate(self) -> bool:
        """Whether the inverse reparameterisation can run in the device
        call: not on the unit hypercube, and the stack consumes exactly
        the flow's columns (an augmented flow has more)."""
        if self.map_to_unit_hypercube:
            return False
        return set(self.prime_parameters) == set(self._reparameterisation.prime_parameters)

    @torch.no_grad()
    def sample_latent_distribution(self, n: int) -> np.ndarray:
        """The latent draws of a populate round, before the rules cut
        them: a rule's own draws (the latent radius's truncated Gaussian
        for a unit-Gaussian base, drawn on the host from ``rng``), else
        draws from the base on the device, from the flow model's
        generator, as the JAX package's device populate loop draws them
        (``nessai_tpu/proposal/flowproposal/flowproposal.py:773``), scaled
        by the square root of ``latent_temperature``."""
        z = self.truncation.sample_latent(self, n)
        if z is not None:
            return z
        z = self.flow.flow.base.sample(n, self.flow.device_generator()).double().cpu().numpy()
        if self.latent_temperature != 1.0:
            z = np.sqrt(self.latent_temperature) * z
        return z

    def _flow_inverse(self, zt):
        """z -> (x', log q(x')) on the device, with the tempered latent
        density ``base(z / sqrt(T)) - (d / 2) log T`` where
        ``latent_temperature`` T is not 1."""
        flow = self.flow.flow
        if self.latent_temperature == 1.0:
            return flow.inverse_and_log_prob(zt)
        sqrt_t = float(np.sqrt(self.latent_temperature))
        x_prime, log_j = flow.inverse(zt)
        log_q = flow.base_log_prob(zt / sqrt_t) - zt.shape[-1] * float(np.log(sqrt_t))
        return x_prime, log_q - log_j

    @torch.no_grad()
    def _fused_backward(self, z, with_likelihood: bool = True):
        """One device call: latent ``z`` -> x (one column per entry of
        :attr:`parameters`: the model's names, then auxiliary parameters
        such as a sampled radius), log q(x), [logL,] and the in-bounds
        mask over the model's names. Returns float64 numpy arrays
        (``log_l`` is None without the likelihood).

        Where the inverse reparameterisation cannot run on the device (a
        stack member without a device inverse, the unit hypercube, an
        augmented flow), the flow inverse still runs here and the rest
        on the host (:meth:`_host_backward`)."""
        device = self.device
        model = self.model
        zt = torch.as_tensor(np.asarray(z, np.float32), device=device)
        x_prime, log_q = self._flow_inverse(zt)
        if not self._can_fuse_populate:
            return self._host_backward(x_prime, log_q)
        cols = {pp: x_prime[:, i] for i, pp in enumerate(self.prime_parameters)}
        inverted = self._reparameterisation.torch_inverse(cols)
        if inverted is None:
            return self._host_backward(x_prime, log_q)
        cols, log_j = inverted
        log_q = log_q - log_j
        x = torch.stack([cols[p] for p in self.parameters], dim=1)
        x_model = x[:, : len(model.names)]
        lower = torch.as_tensor(model.lower_bounds, dtype=torch.float32, device=device)
        upper = torch.as_tensor(model.upper_bounds, dtype=torch.float32, device=device)
        in_b = torch.all((x_model >= lower) & (x_model <= upper), dim=1)
        columns = [x, log_q[:, None], in_b[:, None].to(x.dtype)]
        if with_likelihood:
            columns.append(model.torch_log_likelihood(x_model)[:, None])
        # one device -> host copy for everything
        out = torch.cat(columns, dim=1).cpu().numpy().astype(np.float64)
        d = x.shape[1]
        log_l = out[:, d + 2] if with_likelihood else None
        return out[:, :d], out[:, d], log_l, out[:, d + 1] > 0.5

    def _host_backward(self, x_prime, log_q):
        """The flow's output copied to the host and inverted there by the
        stack's numpy ``inverse_reparameterise``, as the JAX package's
        rounds populate does where it has no device inverse; x stays in
        the unit hypercube with ``map_to_unit_hypercube``. The likelihood
        is then evaluated on the host."""
        missing = getattr(self._reparameterisation, "no_torch_inverse", None)
        if self._can_fuse_populate and missing not in self._logged_host_inverse:
            self._logged_host_inverse.add(missing)
            logger.info("%s has no device inverse: the inverse reparameterisation runs on the host", missing)
        out = torch.cat([x_prime, log_q[:, None]], dim=1).cpu().numpy().astype(np.float64)
        x_prime_host = np.zeros(len(out), dtype=self.x_prime_dtype)
        for i, pp in enumerate(self.prime_parameters):
            x_prime_host[pp] = out[:, i]
        x, log_j = self.inverse_rescale(x_prime_host, return_unit_hypercube=True)
        x_arr = np.stack([x[p] for p in self.parameters], axis=1)
        in_b = self.model.in_unit_hypercube(x) if self.map_to_unit_hypercube else self.model.in_bounds(x)
        return x_arr, out[:, -1] - log_j, None, in_b

    def populate(self, worst_point, n_samples: int = 10000, plot: bool = True, r=None, max_samples=None) -> None:
        """Fill the pool with ``n_samples`` accepted draws (at most
        ``max_samples`` latent draws, by default :attr:`max_samples`;
        ``r`` overrides the latent radius)."""
        st = datetime.datetime.now()
        if not self.initialised:
            raise RuntimeError("Proposal has not been initialised; call initialise() first")
        if max_samples is not None and max_samples != self.max_samples:
            previous = self.max_samples
            self.max_samples = max_samples
            try:
                return self.populate(worst_point, n_samples=n_samples, plot=plot, r=r)
            finally:
                self.max_samples = previous
        scheme = self.truncation
        scheme.prepare(self, worst_point, radius=r)
        self.indices = []
        if self.accumulate_weights:
            samples = empty_structured_array(0, dtype=self.x_dtype)
            log_weights = np.empty(0)
            log_constant = -np.inf
        else:
            samples = empty_structured_array(n_samples, dtype=self.x_dtype)
        log_n = np.log(n_samples)
        n_proposed = 0
        n_accepted = 0
        accept = None
        with_ll = self._resolve_fuse_likelihood()
        ll_in_pool = with_ll or scheme.requires_log_likelihood
        while n_accepted < n_samples:
            z = self.sample_latent_distribution(self._draw_n)
            n_proposed += len(z)
            z = scheme.apply_latent(self, z)
            if not len(z):
                if n_proposed > self.max_samples:
                    logger.warning("Reached max samples (%s)", self.max_samples)
                    break
                continue
            st_lik = datetime.datetime.now()
            x_arr, log_q, log_l, in_b = self._fused_backward(z, with_likelihood=with_ll)
            ll_in_pool = log_l is not None or scheme.requires_log_likelihood
            if log_l is not None:
                self.model.likelihood_evaluation_time += datetime.datetime.now() - st_lik
                self.model.likelihood_evaluations += len(z)
            keep = in_b & np.isfinite(log_q)
            x = empty_structured_array(int(keep.sum()), dtype=self.x_dtype)
            for i, name in enumerate(self.parameters):
                x[name] = x_arr[keep, i]
            if log_l is not None:
                x["logL"] = log_l[keep]
            log_q = log_q[keep]
            z = z[keep]
            x, log_q, z = scheme.apply_after_backward(self, x, log_q, z)
            if not len(x):
                if n_proposed > self.max_samples:
                    logger.warning("Reached max samples (%s)", self.max_samples)
                    break
                continue
            if scheme.requires_log_likelihood:
                if log_l is None:
                    x["logL"] = self.model.batch_evaluate_log_likelihood(
                        x, unit_hypercube=self.map_to_unit_hypercube
                    )
                x, log_q, z = scheme.apply_after_likelihood(self, x, log_q, z)
                if not len(x):
                    if n_proposed > self.max_samples:
                        logger.warning("Reached max samples (%s)", self.max_samples)
                        break
                    continue
            log_w = self.compute_weights(x, log_q)
            if self.accept_all:
                m = min(n_samples - n_accepted, len(x))
                if self.accumulate_weights:
                    samples = np.concatenate([samples, x[:m]])
                else:
                    samples[n_accepted : n_accepted + m] = x[:m]
                n_accepted += m
            elif self.accumulate_weights:
                samples = np.concatenate([samples, x])
                log_weights = np.concatenate([log_weights, log_w])
                log_constant = max(np.nanmax(log_w), log_constant)
                if logsumexp(log_weights - log_constant) >= log_n:
                    log_u = np.log(self.rng.random(len(log_weights)))
                    accept = (log_weights - log_constant) > log_u
                    n_accepted = int(np.sum(accept))
                if n_proposed > self.max_samples:
                    logger.warning("Reached max samples (%s)", self.max_samples)
                    break
            else:
                log_w = log_w - np.nanmax(log_w)
                log_u = np.log(self.rng.random(len(log_w)))
                batch_accept = log_w > log_u
                n_batch = int(batch_accept.sum())
                m = min(n_samples - n_accepted, n_batch)
                samples[n_accepted : n_accepted + m] = x[batch_accept][:m]
                n_accepted += n_batch
                if n_proposed > self.max_samples:
                    logger.warning("Reached max samples (%s)", self.max_samples)
                    break
        if self.accumulate_weights and not self.accept_all:
            if accept is None or len(accept) != len(samples):
                if not len(samples):
                    raise RuntimeError("Failed to populate proposal pool")
                log_u = np.log(self.rng.random(len(log_weights)))
                accept = (log_weights - log_constant) > log_u
            n_accepted = int(np.sum(accept))
            self.x = samples[accept][:n_samples]
        else:
            self.x = samples[: min(n_accepted, n_samples)]
        if not len(self.x):
            raise RuntimeError("Failed to populate the proposal pool (0 accepted samples)")
        self._finalise_population(st, n_accepted, n_proposed, ll_in_pool, plot, worst_point)

    def _finalise_population(self, st, n_accepted, n_proposed, likelihoods_in_pool, plot, worst_point) -> None:
        """The populate's tail: model-space samples, their likelihoods
        where the rounds did not evaluate them, the acceptance check, the
        pop order and the pool plot."""
        self.samples = self.convert_to_samples(self.x)
        self.population_time += datetime.datetime.now() - st
        if not likelihoods_in_pool:
            self.samples["logL"] = self.model.batch_evaluate_log_likelihood(self.samples)
        if self.check_acceptance and worst_point is not None:
            self.acceptance.append(self.compute_acceptance(worst_point["logL"]))
        self.indices = self.rng.permutation(self.samples.size).tolist()
        self.population_acceptance = n_accepted / n_proposed if n_proposed else np.nan
        self.populated_count += 1
        self.populated = True
        if self._plot_pool and plot:
            self.plot_pool(self.samples)

    def reset(self) -> None:
        super().reset()
        if self._truncation_scheme is not None:
            self._truncation_scheme.reset()
