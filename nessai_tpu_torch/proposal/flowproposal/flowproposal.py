"""FlowProposal: the flagship proposal. Counterpart of
``nessai_tpu/proposal/flowproposal/flowproposal.py``.

Two populates, as in the JAX package. ``populate_mode="auto"`` (the
default) takes the device populate loop wherever the configuration
allows it (:attr:`FlowProposal._can_device_loop`), and the rounds
populate elsewhere; ``"rounds"`` always takes the rounds populate and
``"device_loop"`` the loop, or raises.

The device populate loop (:meth:`FlowProposal._device_loop_populate`)
draws batches from the flow's base on the device, keeps the draws inside
the latent ball, inverts the flow (K1 or K2 launches) and the
reparameterisations, evaluates the prior on the device and rejection
samples each batch against its largest weight into a fixed buffer, round
after round, with one host read per chunk of rounds; the device
likelihood then runs on the buffer, and the nested-sampling scan can be
chained onto it. An unset ``max_samples`` is a soft budget there.

Each rounds populate round draws latent points (the truncated Gaussian on the
host, from ``self.rng``, or the flow's base on the device), lets the
truncation rules cut them, then makes one device call,
:meth:`FlowProposal._fused_backward`: the flow inverse (four
affine-coupling kernel launches for the flagship RealNVP), the base
log-density, the inverse reparameterisation (each stack member's
``torch_inverse``), the prior-bounds check and, where the populate fuses
it, the model's ``torch_log_likelihood``. The rules then cut the draws
after the inverse and after the likelihood, and rejection sampling
against the prior runs on the host. A proposal without a device
inverse (``uses_device_inverse`` False: the clustering proposal, whose
inverse is conditioned on sampled labels) passes each round through its
:meth:`backward_pass` instead and evaluates the likelihood on the pool
alone, as the JAX package's rounds do where it builds no device inverse
(``nessai_tpu/proposal/flowproposal/flowproposal.py:1113-1114``); it never
takes the device populate loop.

On a device mesh (the flow model's ``mesh``) the rounds populate's device
call is cut over the mesh: the latent draws are made as on one device,
then each mesh entry inverts its shard through its replica of the flow,
the reparameterisations, the bound check and the device likelihood, and
the outputs are gathered in order, so the pool is the single-device
pool; without a mesh the same call runs over a one-entry mesh. The
device populate loop is off on a mesh, as in the JAX package
(``flowproposal.py:636``); a model without a device likelihood is
evaluated on the host for the pool alone.
"""

import datetime
import logging
import math
import types
import warnings
from typing import Optional

import numpy as np
import torch
from scipy.special import logsumexp

from ...flows.distributions import StandardNormal
from ...livepoint import empty_structured_array
from ...utils.sampling import _bucket_size
from .base import BaseFlowProposal
from .truncation import TruncationScheme

logger = logging.getLogger(__name__)

__all__ = ["FlowProposal", "device_loop_counts"]

#: What the device populate loop did since the counts were last set to 0:
#: its calls, the rounds queued, the host reads of the accepted count
#: (one per chunk of rounds) and the nested-sampling scans chained onto
#: its pools.
device_loop_counts = types.SimpleNamespace(calls=0, rounds=0, chunk_reads=0, chained_scans=0)


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
      (default 1,000,000); where it is not set, the device populate loop
      takes it as a soft budget and keeps drawing while anything is
      accepted, as the JAX package does;
    - ``latent_temperature``: the latent draws of the base are scaled by
      its square root, and log q is the tempered density;
    - ``fuse_likelihood``: in the rounds populate, True evaluates a
      device likelihood on every draw in the populate's device call;
      False evaluates it only on the accepted pool; None (default) fuses
      wherever the model has a device likelihood. A rule that needs the
      likelihood forces fusing. The device populate loop evaluates the
      pool alone, as the JAX package's does;
    - ``populate_mode``: ``"auto"`` takes the device populate loop where
      :attr:`_can_device_loop` holds and the rounds populate elsewhere;
      ``"rounds"`` always the rounds; ``"device_loop"`` the loop, raising
      where the configuration does not allow it.
    """

    #: cap on the acceptance-adaptive latent draw scale
    _max_draw_scale: float = 32.0
    #: whether the populate inverts the flow and the reparameterisations
    #: in one device call (:meth:`_fused_backward`), and may take the
    #: device populate loop; else each round goes through
    #: :meth:`backward_pass`
    uses_device_inverse: bool = True

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
        #: an explicit max_samples is exact on every path; an unset one is
        #: a soft budget in the device populate loop
        self._max_samples_explicit = max_samples is not None
        self.max_samples = 1_000_000 if max_samples is None else int(max_samples)
        self.configure_population(drawsize, latent_prior=latent_prior, latent_temperature=latent_temperature)
        self.fuse_likelihood = fuse_likelihood
        if populate_mode not in ("auto", "rounds", "device_loop"):
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
        likelihood (decided once), by the JAX package's rule
        (``flowproposal.py:412-440``). A host likelihood standing in for a
        device one (``likelihood_callback``) runs on the host after the
        call on a mesh, and on rejected draws only where a rule needs the
        likelihood or ``fuse_likelihood`` asks for it. Otherwise a rule
        that needs the likelihood forces it, else ``fuse_likelihood``,
        else fused. A model with no device likelihood never fuses it."""
        model = self.model
        if self._fuse_likelihood_resolved is None:
            if not model.has_torch_likelihood and self.flow is not None and self.flow.mesh is not None:
                self._fuse_likelihood_resolved = False
            elif self.truncation.requires_log_likelihood:
                self._fuse_likelihood_resolved = True
            elif self.fuse_likelihood is not None:
                self._fuse_likelihood_resolved = bool(self.fuse_likelihood)
            else:
                self._fuse_likelihood_resolved = model.has_torch_likelihood
        return self._fuse_likelihood_resolved and (model.has_torch_likelihood or model.likelihood_callback)

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
        z = self.flow.sample_latent_distribution(n)
        if self.latent_temperature != 1.0:
            z = np.sqrt(self.latent_temperature) * z
        return z

    def _flow_inverse(self, zt):
        """z -> (x', log q(x')) on the device (cut over the mesh on one),
        with the tempered latent density where ``latent_temperature`` is
        not 1."""
        return self.flow.sharded_tempered_inverse(zt, self.latent_temperature)

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
        zt = torch.as_tensor(np.asarray(z, np.float32), device=self.device)
        if self._can_fuse_populate and self._reparameterisation.has_torch_inverse:

            def shard(flow, z):
                x_prime, log_q = self.flow.tempered_inverse(z, self.latent_temperature, flow=flow)
                return self._device_backward(x_prime, log_q, with_likelihood)

            return self._backward_to_host(self.flow.sharded(shard, zt), with_likelihood)
        return self._host_backward(*self._flow_inverse(zt))

    def _device_backward(self, x_prime, log_q, with_likelihood):
        """The device inverse of the flow's output on its device: ``[n, P
        + 2 (+ 1)]`` columns (x, log q, the in-bounds mask as 0 or 1, and
        logL with the likelihood); every stack member inverts on the
        device."""
        model = self.model
        device = x_prime.device
        cols = {pp: x_prime[:, i] for i, pp in enumerate(self.prime_parameters)}
        cols, log_j = self._reparameterisation.torch_inverse(cols)
        log_q = log_q - log_j
        x = torch.stack([cols[p] for p in self.parameters], dim=1)
        x_model = x[:, : len(model.names)]
        lower, upper = self._bounds_on(device)
        in_b = torch.all((x_model >= lower) & (x_model <= upper), dim=1)
        columns = [x, log_q[:, None], in_b[:, None].to(x.dtype)]
        if with_likelihood:
            ll_fn, ll_data = model.device_log_likelihood_fn(device)
            columns.append(ll_fn(x_model, ll_data)[:, None])
        return torch.cat(columns, dim=1)

    def _bounds_on(self, device):
        """The prior box as float32 tensors on ``device``, made once a
        device."""
        cache = self.__dict__.setdefault("_bounds_cache", {})
        if device not in cache:
            model = self.model
            cache[device] = (
                torch.as_tensor(model.lower_bounds, dtype=torch.float32, device=device),
                torch.as_tensor(model.upper_bounds, dtype=torch.float32, device=device),
            )
        return cache[device]

    def _backward_to_host(self, columns, with_likelihood):
        """The columns of :meth:`_device_backward` as float64 numpy
        ``(x, log_q, log_l or None, in_bounds)``, in one device-to-host
        copy."""
        out = columns.cpu().numpy().astype(np.float64)
        d = out.shape[1] - (3 if with_likelihood else 2)
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

    # ------------------------------------------------------------------
    # The device populate loop
    # ------------------------------------------------------------------
    @property
    def _can_device_loop(self) -> bool:
        """Whether the populate can run as the device loop, by the JAX
        package's rule (``flowproposal.py:625-651``): every member of the
        stack inverts on the device (and the flow's columns are the
        stack's), neither the unit hypercube nor ``accept_all`` nor
        ``accumulate_weights``, latent-radius rules only, a prior on the
        device (a ``torch_log_prior`` or a uniform box) with the
        auxiliary parameters' priors on the device too; one device (no
        mesh, ``flowproposal.py:636``)."""
        reparam = self._reparameterisation
        if self.flow is None or reparam is None or not self.uses_device_inverse:
            return False
        if self.flow.mesh is not None:
            return False
        if self.map_to_unit_hypercube or not self._can_fuse_populate or not reparam.has_torch_inverse:
            return False
        if self.accept_all or self.accumulate_weights:
            return False
        scheme = self._truncation_scheme
        if scheme is None or scheme.requires_log_likelihood:
            return False
        if any(r.name != "latent_radius" for r in scheme.rules):
            return False
        m = self.model
        if not (m.has_torch_prior or m.has_uniform_box_prior):
            return False
        return reparam.torch_log_prior_fn() is not None

    def _use_device_loop(self) -> bool:
        """Whether this populate takes the device loop: never with
        ``"rounds"``; with ``"device_loop"`` always, raising where
        :attr:`_can_device_loop` is False; with ``"auto"`` where it is
        True."""
        if self.populate_mode == "rounds":
            return False
        ok = self._can_device_loop
        if self.populate_mode == "device_loop" and not ok:
            raise RuntimeError(
                "populate_mode='device_loop' requested but the configuration does not support it (requires "
                "device inverse reparameterisations, latent-radius-only truncation, a torch_log_prior hook or "
                "uniform box prior, and no unit hypercube, accept_all or accumulate_weights)"
            )
        return ok

    @torch.no_grad()
    def _device_loop_populate(self, n_samples: int):
        """Fill the pool through the device populate loop, the JAX
        package's ``lax.while_loop`` populate
        (``flowproposal.py:667-985``). Sets ``self.x`` and returns
        ``(n_accepted, n_proposed, likelihoods_in_pool)``.

        Each call of :meth:`_device_loop_call` runs up to ``rounds``
        rounds of B draws (``B = _bucket_size(drawsize or 4 * poolsize)``)
        into a buffer of ``n_samples`` rows. The host loop around the
        calls is the JAX package's: each call's budget is
        ``margin * (pool left) / acceptance + B`` proposals (the reference
        ``max_samples`` before any acceptance is known), at most
        ``max(max_samples, 256 B)``. An explicit ``max_samples`` stops the
        populate there with a warning; an unset one is a soft budget,
        past which it stops only on zero acceptance; and never beyond
        ``2**31 - B - 1`` proposals. A call adds ``n_samples`` to the
        likelihood count where the likelihood is on the device.

        The host stream ``rng`` gives, in this order, the pool's pop order
        (a permutation of ``n_samples``, where the likelihood is on the
        device) and one seed per call for the call's device generator,
        exactly as the JAX package draws them; only the device's own
        draws differ from JAX's. Where the sampler asks for the
        nested-sampling scan (``_ns_scan_request``) and the first call
        fills the pool, the scan runs on its likelihoods in pop order and
        its outputs wait in ``_pending_ns_scan``."""
        model = self.model
        with_ll = bool(model.has_torch_likelihood)
        B = _bucket_size(int(self.drawsize) if self.drawsize else 4 * self._poolsize)
        cap = int(n_samples)
        int32_cap = 2**31 - B - 1
        # a resumed pickle without the flag keeps the exact cap
        explicit = getattr(self, "_max_samples_explicit", True)
        hard_cap = int(min(self.max_samples, int32_cap)) if explicit else int32_cap
        # the host re-reads the acceptance at least every soft budget, so a
        # flow that accepts nothing cannot spin to the int32 cap
        per_call_cap = int(min(max(self.max_samples, 256 * B), hard_cap))
        margin = 3.0
        rule = self._truncation_scheme.get_rule("latent_radius")
        r_max = rule.r * rule.fuzz if rule is not None and getattr(rule, "r", None) else math.inf

        self._early_perm = None
        scan_req = getattr(self, "_ns_scan_request", None)
        with_scan = bool(with_ll and scan_req is not None)
        if with_ll:
            self._early_perm = self.rng.permutation(cap)
        self._pending_ns_scan = None

        parts_x, parts_ll = [], []
        filled = total_acc = total_prop = 0
        acc_est = self.population_acceptance
        if acc_est is not None and not (np.isfinite(acc_est) and acc_est > 0):
            acc_est = None
        while filled < cap and total_prop < hard_cap:
            if acc_est:
                want = int(margin * (cap - filled) / acc_est) + B
            else:
                want = int(self.max_samples)
            budget_call = min(want, per_call_cap, hard_cap - total_prop)
            rounds = max(budget_call // B, 1)
            seed = int(self.rng.integers(2**31 - 1))
            # the first chunk: the rounds that fill the pool at the last
            # acceptance; the chunks double after it
            first_chunk = math.ceil((cap - filled) / (acc_est * B)) if acc_est else 1
            # the scan's results are valid only for a first call that fills
            # the pool: it sees exactly that call's buffer
            scan = (self._early_perm, *scan_req) if with_scan and filled == 0 else None
            x_arr, log_l, count, n_prop, scan_out = self._device_loop_call(
                seed, rounds, B, cap, r_max, with_ll, first_chunk, scan
            )
            if scan_out is not None:
                self._pending_ns_scan = scan_out
            k = min(count, cap - filled, cap)
            if k > 0:
                parts_x.append(x_arr[:k])
                if log_l is not None:
                    parts_ll.append(log_l[:k])
            filled += k
            total_acc += count
            total_prop += n_prop
            if with_ll:
                model.likelihood_evaluations += cap
            acc_est = total_acc / total_prop if total_prop else None
            if filled < cap and total_prop >= self.max_samples:
                if explicit:
                    logger.warning("Reached max samples (%s)", self.max_samples)
                    break
                if not acc_est:
                    logger.warning("Reached max samples (%s) with 0 accepted", self.max_samples)
                    break
        if filled < cap and total_prop >= hard_cap:
            logger.warning("Reached max samples (%s)", hard_cap)
        if not filled:
            raise RuntimeError("Failed to populate the proposal pool (0 accepted samples)")
        x_arr = np.concatenate(parts_x, axis=0)[:cap]
        x = empty_structured_array(len(x_arr), dtype=self.x_dtype)
        for i, name in enumerate(self.parameters):
            x[name] = x_arr[:, i]
        if parts_ll:
            x["logL"] = np.concatenate(parts_ll)[: len(x_arr)]
        self.x = x
        return total_acc, total_prop, with_ll

    def _device_loop_call(self, seed, rounds, B, cap, r_max, with_ll, first_chunk, scan=None):
        """One call of the device populate loop, the JAX package's
        ``while_loop`` program: up to ``rounds`` rounds of ``B`` draws from
        a device generator seeded with ``seed``, accepted draws written in
        order into a buffer of ``cap`` rows (and one dump row), the loop
        ending once the buffer is full; then the likelihood on the buffer
        (``with_ll``) and, where ``scan = (perm, live32, max_accepts)`` is
        given and the buffer is full, the nested-sampling scan of its
        likelihoods in the pop order ``perm``
        (:func:`~nessai_tpu_torch.samplers.ns_device.chain_scan`).

        The loop runs on the device without a host synchronisation per
        round: rounds are queued in chunks, ``first_chunk`` and then
        doubling, each ended by one host read of the accepted count. A
        round in a chunk after the buffer filled is masked: it writes
        nothing and adds nothing to the count of proposals, so the result
        is the ``while_loop``'s. No more than ``rounds`` rounds are ever
        queued.

        Returns ``(x [k, P], log_l [k] or None, accepted, proposed,
        scan outputs or None)``, x and log_l as float64 numpy arrays of
        the first ``k = min(accepted, cap)`` rows."""
        device = self.device
        model = self.model
        gen = torch.Generator(device=device).manual_seed(int(seed))
        n_params = len(self.parameters)
        loop = self._device_loop_constants(B, cap, r_max)
        buf_x = torch.zeros(cap + 1, n_params, dtype=torch.float32, device=device)
        count = torch.zeros((), dtype=torch.int64, device=device)
        n_prop = torch.zeros((), dtype=torch.int64, device=device)
        device_loop_counts.calls += 1
        done = 0
        chunk = max(1, min(int(first_chunk), int(rounds)))
        count_host = 0
        while done < rounds:
            c = min(chunk, rounds - done)
            for _ in range(c):
                self._device_loop_round(loop, gen, buf_x, count, n_prop)
            done += c
            device_loop_counts.rounds += c
            device_loop_counts.chunk_reads += 1
            count_host = int(count)
            if count_host >= cap:
                break
            chunk *= 2
        k = min(count_host, cap)
        buf = buf_x[:cap]
        columns = [buf]
        log_l_dev = None
        if with_ll:
            ll_fn, ll_data = model.device_log_likelihood_fn(device)
            log_l_dev = ll_fn(buf[:, : len(model.names)], ll_data).to(torch.float32)
            columns.append(log_l_dev[:, None])
        scan_out = None
        if scan is not None and count_host >= cap:
            from ...samplers.ns_device import chain_scan

            scan_out = chain_scan(log_l_dev, *scan)
            device_loop_counts.chained_scans += 1
        out = torch.cat(columns, dim=1)[:k].cpu().numpy().astype(np.float64)
        log_l = out[:, n_params] if with_ll else None
        return out[:, :n_params], log_l, count_host, int(n_prop), scan_out

    def _device_loop_constants(self, B, cap, r_max):
        """What every round of a call reads: the batch, the buffer size,
        the squared latent radius, the prior box and the priors."""
        model = self.model
        device = self.device
        lower = torch.as_tensor(model.lower_bounds, dtype=torch.float32, device=device)
        upper = torch.as_tensor(model.upper_bounds, dtype=torch.float32, device=device)
        log_p_box = torch.tensor(
            np.float32(-np.sum(np.log(np.asarray(model.upper_bounds) - np.asarray(model.lower_bounds)))),
            device=device,
        )
        return types.SimpleNamespace(
            B=B,
            cap=cap,
            r2=r_max * r_max,
            sqrt_t=float(np.sqrt(self.latent_temperature)),
            lower=lower,
            upper=upper,
            log_p_box=log_p_box,
            prior=model.torch_log_prior if model.has_torch_prior else None,
            aux_prior=self._reparameterisation.torch_log_prior_fn(),
            n_model=len(model.names),
        )

    def _device_loop_round(self, loop, gen, buf_x, count, n_prop) -> None:
        """One round of the loop on the device: B draws from the flow's
        base (scaled by the square root of the latent temperature), kept
        inside the latent ball, through the flow inverse and the
        reparameterisations' device inverse, the prior box, the prior on
        the device and the auxiliary priors; rejection sampling against
        the batch's largest weight; the accepted rows written in order at
        ``count`` (past the buffer into its dump row). A round that finds
        the buffer full writes nothing and leaves ``count`` and
        ``n_prop`` as they are. Updates ``buf_x``, ``count`` and
        ``n_prop`` in place."""
        flow = self.flow.flow
        active = count < loop.cap
        z0 = flow.sample_base(loop.B, gen)
        z = z0 * loop.sqrt_t if loop.sqrt_t != 1.0 else z0
        in_ball = torch.sum(z * z, dim=1) <= loop.r2
        x_prime, log_j = flow.inverse(z)
        # the tempered latent density: q(z) = base(z0) T^(-d/2) for z = sqrt(T) z0
        log_q = flow.base_log_prob(z0) - log_j
        if loop.sqrt_t != 1.0:
            log_q = log_q - z.shape[-1] * math.log(loop.sqrt_t)
        cols = {pp: x_prime[:, i] for i, pp in enumerate(self.prime_parameters)}
        cols, log_j_r = self._reparameterisation.torch_inverse(cols)
        log_q = log_q - log_j_r
        x = torch.stack([cols[p] for p in self.parameters], dim=1)
        x_model = x[:, : loop.n_model]
        in_b = torch.all((x_model >= loop.lower) & (x_model <= loop.upper), dim=1)
        log_p = loop.log_p_box if loop.prior is None else loop.prior(x_model)
        log_p = log_p + loop.aux_prior(cols)
        ok = in_ball & in_b & torch.isfinite(log_q)
        log_w = torch.where(ok, log_p - log_q, -math.inf)
        log_u = torch.log(torch.rand(loop.B, generator=gen, device=z0.device))
        accept = ok & (log_u < log_w - torch.max(log_w)) & active
        pos = count + torch.cumsum(accept, dim=0) - 1
        idx = torch.where(accept & (pos < loop.cap), pos, loop.cap)
        buf_x[idx] = x
        count += torch.sum(accept)
        n_prop += active.to(torch.int64) * loop.B

    def populate(self, worst_point, n_samples: int = 10000, plot: bool = True, r=None, max_samples=None) -> None:
        """Fill the pool with ``n_samples`` accepted draws (at most
        ``max_samples`` latent draws, by default :attr:`max_samples`;
        ``r`` overrides the latent radius)."""
        st = datetime.datetime.now()
        if not self.initialised:
            raise RuntimeError("Proposal has not been initialised; call initialise() first")
        if max_samples is not None and max_samples != self.max_samples:
            # exact for this call, on either path
            previous = self.max_samples
            previous_explicit = getattr(self, "_max_samples_explicit", True)
            self.max_samples = max_samples
            self._max_samples_explicit = True
            try:
                return self.populate(worst_point, n_samples=n_samples, plot=plot, r=r)
            finally:
                self.max_samples = previous
                self._max_samples_explicit = previous_explicit
        scheme = self.truncation
        scheme.prepare(self, worst_point, radius=r)
        self.indices = []
        device_loop = self._use_device_loop()
        if not self.populated_count:
            logger.info("Populating with the %s", "device populate loop" if device_loop else "rounds populate")
        if device_loop:
            n_accepted, n_proposed, ll_in_pool = self._device_loop_populate(n_samples)
            return self._finalise_population(st, n_accepted, n_proposed, ll_in_pool, plot, worst_point)
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
        with_ll = self.uses_device_inverse and self._resolve_fuse_likelihood()
        ll_in_pool = with_ll or scheme.requires_log_likelihood
        if (
            self.flow.mesh is not None
            and not self.model.has_torch_likelihood
            and not getattr(self, "_logged_host_likelihood_on_mesh", False)
        ):
            # the JAX package's split of a host likelihood out of the
            # sharded program (``flowproposal.py:1056-1075``), said once
            logger.info(
                "Host likelihood on a %d-entry mesh: the flow inverse, the reparameterisations and the "
                "bounds run sharded; the likelihood is evaluated on the host for the pool alone",
                self.flow.mesh.size,
            )
            self._logged_host_likelihood_on_mesh = True
        while n_accepted < n_samples:
            z = self.sample_latent_distribution(self._draw_n)
            n_proposed += len(z)
            z = scheme.apply_latent(self, z)
            if not len(z):
                if n_proposed > self.max_samples:
                    logger.warning("Reached max samples (%s)", self.max_samples)
                    break
                continue
            if self.uses_device_inverse:
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
            else:
                x, log_q, z = self.backward_pass(z, return_z=True)
                log_l = None
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
        perm = getattr(self, "_early_perm", None)
        if perm is not None:
            # drawn by the device populate loop before its first call; a
            # permutation of the capacity restricted to the filled rows is
            # a uniform permutation of them
            self._early_perm = None
            if len(perm) == self.samples.size:
                self.indices = perm.tolist()
            else:
                self.indices = [int(i) for i in perm if i < self.samples.size]
                # the chained scan saw another pool
                self._pending_ns_scan = None
        else:
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

    def __getstate__(self):
        state = super().__getstate__()
        # the populate's scratch, owned by the running sampler
        state.pop("_pending_ns_scan", None)
        state.pop("_ns_scan_request", None)
        state.pop("_early_perm", None)
        # tensors on the devices of this process
        state.pop("_bounds_cache", None)
        return state
