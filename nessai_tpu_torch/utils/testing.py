"""Testing utilities. Counterpart of ``nessai_tpu/utils/testing.py``."""

import contextlib
import math
import pickle
import signal

import numpy as np
import torch
from scipy.stats import halfnorm, norm, vonmises

from ..model import Model

__all__ = [
    "IntegrationTestModel",
    "GaussianMixture",
    "RosenbrockModel",
    "rosenbrock_log_evidence",
    "HalfGaussianModel",
    "AngleModel",
    "EggboxModel",
    "eggbox_log_evidence",
    "BimodalGaussianModel",
    "GaussianModel",
    "REPARAMETERISATION_CASES",
    "reparameterisation_case",
    "NS_SCAN_REGIMES",
    "ns_scan_case",
    "NS_SCAN_UNBOUNDED",
    "NS_SCAN_SHAPES",
    "NS_SCAN_CAPS",
    "NS_SCAN_CASE_ROWS",
    "ns_scan_rows",
    "assert_structured_arrays_equal",
    "time_limit",
    "pickled_types",
]


class IntegrationTestModel(Model):
    """n-dim unit Gaussian with a uniform prior on [-10, 10]^n and
    analytic unit-hypercube maps.

    Analytic log-evidence: ``-n * log(20)``.
    """

    uniform_prior_box = True

    def __init__(self, dims: int = 2):
        self.names = [f"x_{i}" for i in range(dims)]
        self.bounds = {n: [-10.0, 10.0] for n in self.names}

    def log_prior(self, x):
        with np.errstate(divide="ignore"):
            log_p = np.log(self.in_bounds(x), dtype="float64")
        for n in self.names:
            log_p -= np.log(self.bounds[n][1] - self.bounds[n][0])
        return log_p

    def log_likelihood(self, x):
        x = self.unstructured_view(x)
        return -0.5 * np.sum(x**2, axis=-1) - 0.5 * x.shape[-1] * np.log(
            2 * np.pi
        )

    def to_unit_hypercube(self, x):
        x_out = x.copy()
        for n in self.names:
            lo, hi = self.bounds[n]
            x_out[n] = (x[n] - lo) / (hi - lo)
        return x_out

    def from_unit_hypercube(self, x):
        x_out = x.copy()
        for n in self.names:
            lo, hi = self.bounds[n]
            x_out[n] = x[n] * (hi - lo) + lo
        return x_out

    def torch_log_likelihood(self, x: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum(x**2, dim=-1) - 0.5 * x.shape[-1] * math.log(
            2 * math.pi
        )

    @property
    def analytic_log_evidence(self) -> float:
        return -len(self.names) * np.log(20.0)


class GaussianMixture(IntegrationTestModel):
    """The model of ``examples/importance_nested_sampler/
    ins_gaussian_mixture.py``: an equal mixture of two unit Gaussians at
    (4, ..., 4) and (-4, ..., -4), a uniform prior on [-10, 10]^n and
    the analytic unit-hypercube maps, with a host (numpy) likelihood.

    Analytic log-evidence: ``-n * log(20)`` (the mass outside the box, 6σ
    from either mean, is negligible).
    """

    torch_log_likelihood = None

    def log_likelihood(self, x):
        x = self.unstructured_view(x)
        a = -0.5 * np.sum((x - 4) ** 2, axis=-1)
        b = -0.5 * np.sum((x + 4) ** 2, axis=-1)
        norm_const = x.shape[-1] * 0.5 * np.log(2 * np.pi)
        return np.logaddexp(a, b) - np.log(2) - norm_const


def rosenbrock_log_evidence(dims: int = 4, n: int = 4001, low: float = -5.0, high: float = 5.0) -> float:
    """log Z of the Rosenbrock likelihood of :class:`RosenbrockModel` on
    the uniform prior ``[low, high]^dims``, by quadrature: the likelihood
    is a chain, ``prod_i exp(-100 (x_{i+1} - x_i^2)^2 - (1 - x_i)^2)``, so
    its integral is a product of ``dims - 1`` transfer matrices on a
    trapezoid grid of ``n`` points. For 4 dimensions, 4001, 8001 and
    16001 points all give -15.1016907 (to 1e-8)."""
    x = np.linspace(low, high, n)
    w = np.full(n, x[1] - x[0])
    w[0] = w[-1] = 0.5 * (x[1] - x[0])
    v = np.ones(n)
    for _ in range(dims - 1):
        a = v * w * np.exp(-((1.0 - x) ** 2))
        # the transfer matrix exp(-100 (y - x^2)^2) a block of rows at a time
        v = np.concatenate(
            [np.exp(-100.0 * (x[s : s + 1000, None] - x[None, :] ** 2) ** 2) @ a for s in range(0, n, 1000)]
        )
    return float(np.log(np.sum(w * v)) - dims * np.log(high - low))


class RosenbrockModel(IntegrationTestModel):
    """The model of ``examples/importance_nested_sampler/
    nsf_unit_hypercube.py``: the Rosenbrock likelihood
    ``-sum_i [100 (x_{i+1} - x_i^2)^2 + (1 - x_i)^2]`` on a uniform prior
    on ``[-5, 5]^dims``, with the analytic unit-hypercube maps and the
    likelihood on the device as well (``torch_log_likelihood``).

    Log-evidence: :func:`rosenbrock_log_evidence` (-15.1016907 in 4
    dimensions).
    """

    def __init__(self, dims: int = 4):
        self.names = [f"x_{d}" for d in range(dims)]
        self.bounds = {n: [-5.0, 5.0] for n in self.names}

    def log_likelihood(self, x):
        x = self.unstructured_view(x)
        return -(
            np.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2.0) ** 2.0 + (1.0 - x[..., :-1]) ** 2.0, axis=-1)
        )

    def torch_log_likelihood(self, x: torch.Tensor) -> torch.Tensor:
        return -(
            torch.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2.0) ** 2.0 + (1.0 - x[..., :-1]) ** 2.0, dim=-1)
        )

    @property
    def analytic_log_evidence(self) -> float:
        return rosenbrock_log_evidence(len(self.names))


class _UniformBoxModel(Model):
    """A uniform prior on the box of :attr:`bounds`."""

    uniform_prior_box = True

    def log_prior(self, x):
        with np.errstate(divide="ignore"):
            log_p = np.log(self.in_bounds(x), dtype="float")
        for n in self.names:
            log_p -= np.log(self.bounds[n][1] - self.bounds[n][0])
        return log_p


class HalfGaussianModel(_UniformBoxModel):
    """The model of ``examples/half_gaussian.py``: a half-normal in x on
    [0, 10] (a density that piles up at the lower bound) and a unit
    normal in y on [-10, 10], with host (scipy) likelihoods.

    Analytic log-evidence: ``-log 200`` (the likelihood's mass outside
    the box is negligible).
    """

    def __init__(self):
        self.names = ["x", "y"]
        self.bounds = {"x": [0, 10], "y": [-10, 10]}

    def log_likelihood(self, x):
        return halfnorm.logpdf(x["x"]) + norm.logpdf(x["y"])

    @property
    def analytic_log_evidence(self) -> float:
        return -np.log(200.0)


class GaussianModel(Model):
    """The model of ``examples/mcmc_example.py`` as written: a 2-D unit
    normal likelihood (scipy, on the host) in x and y with a uniform prior
    on [-10, 10]^2 (numpy, on the host), and no device functions.

    Analytic log-evidence: ``-log 400``.
    """

    def __init__(self):
        self.names = ["x", "y"]
        self.bounds = {"x": [-10, 10], "y": [-10, 10]}

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype="float")
        for n in self.names:
            log_p -= np.log(np.ptp(self.bounds[n]))
        return log_p

    def log_likelihood(self, x):
        return norm.logpdf(x["x"]) + norm.logpdf(x["y"])

    @property
    def analytic_log_evidence(self) -> float:
        return -np.log(400.0)


def eggbox_log_evidence(n: int = 4001, block: int = 1000) -> float:
    """log Z of :class:`EggboxModel` in 2-D: the trapezoid rule on an
    ``n`` × ``n`` grid over the prior ``[0, 10 pi]^2`` of
    ``exp((2 + cos(x / 2) cos(y / 2))^5)`` (taken as ``exp(f - 243)`` and
    ``243 = max f`` added back), over the prior volume. Its peaks have a
    width of 0.1 and 4001 points space them 0.0079 apart: 4001 and 8001
    points agree to 1e-9, at 235.88 (the egg-box value of the nested
    sampling literature)."""
    x = np.linspace(0.0, 10 * np.pi, n)
    w = np.full(n, x[1] - x[0])
    w[0] = w[-1] = 0.5 * (x[1] - x[0])
    c = np.cos(x / 2.0)
    total = 0.0
    for s in range(0, n, block):
        f = (2.0 + c[s : s + block, None] * c[None, :]) ** 5 - 243.0
        total += w[s : s + block] @ (np.exp(f) @ w)
    return float(243.0 + np.log(total) - 2 * np.log(10 * np.pi))


class EggboxModel(_UniformBoxModel):
    """The model of ``examples/eggbox.py``: the egg-box likelihood
    ``(2 + prod_i cos(x_i / 2))^5`` on a uniform prior ``[0, 10 pi]^dims``,
    18 modes in 2-D (peaks of 243 where every cosine is ±1 with an even
    count of -1, and saddles of 32 between), evaluated on the host and,
    in float32, on the device.

    Analytic log-evidence (2-D): :func:`eggbox_log_evidence`.
    """

    def __init__(self, dims: int = 2):
        self.names = [f"x_{d}" for d in range(dims)]
        self.bounds = {n: [0.0, 10 * np.pi] for n in self.names}

    def log_likelihood(self, x):
        x = self.unstructured_view(x)
        return (2.0 + np.prod(np.cos(x / 2.0), axis=-1)) ** 5.0

    def torch_log_likelihood(self, x: torch.Tensor) -> torch.Tensor:
        return (2.0 + torch.prod(torch.cos(x / 2.0), dim=-1)) ** 5.0

    @property
    def analytic_log_evidence(self) -> float:
        if len(self.names) != 2:
            raise ValueError("the egg-box quadrature is two-dimensional")
        return eggbox_log_evidence()

    def modes(self) -> np.ndarray:
        """The 18 peaks in 2-D: x and y at multiples of 2 pi in
        ``[0, 10 pi]`` with ``cos(x / 2) cos(y / 2) = 1``."""
        grid = 2 * np.pi * np.arange(6)
        xx, yy = np.meshgrid(grid, grid, indexing="ij")
        peaks = np.stack([xx.ravel(), yy.ravel()], axis=1)
        return peaks[np.isclose(np.cos(peaks[:, 0] / 2) * np.cos(peaks[:, 1] / 2), 1.0)]


class BimodalGaussianModel(_UniformBoxModel):
    """The model of ``examples/augmented_example.py``: an equal mixture
    of two unit Gaussians at (-5, -5) and (5, 5) on a uniform prior
    ``[-10, 10]^2``, with a host (scipy) likelihood.

    Analytic log-evidence: ``-log 400`` (the mass outside the box, 5σ
    from either mean, is negligible).
    """

    def __init__(self):
        self.names = ["x", "y"]
        self.bounds = {"x": [-10, 10], "y": [-10, 10]}

    def log_likelihood(self, x):
        a = norm.logpdf(x["x"], loc=-5) + norm.logpdf(x["y"], loc=-5)
        b = norm.logpdf(x["x"], loc=5) + norm.logpdf(x["y"], loc=5)
        return np.logaddexp(a, b) - np.log(2)

    @property
    def analytic_log_evidence(self) -> float:
        return -np.log(400.0)


class AngleModel(_UniformBoxModel):
    """The model of ``examples/reparameterisations_example.py``: a von
    Mises angle (kappa 2 about pi) on [0, 2 pi] and a normal amplitude
    N(2, 0.5) on [0, 5], with host (scipy) likelihoods.

    Analytic log-evidence: ``log(Phi(6) - Phi(-4)) - log(10 pi)``, the
    amplitude's mass inside [0, 5] over the prior volume (the von Mises
    density integrates to one over the period).
    """

    def __init__(self):
        self.names = ["theta", "amp"]
        self.bounds = {"theta": [0, 2 * np.pi], "amp": [0, 5]}

    def log_likelihood(self, x):
        return vonmises.logpdf(x["theta"], kappa=2, loc=np.pi) + norm.logpdf(x["amp"], loc=2, scale=0.5)

    @property
    def analytic_log_evidence(self) -> float:
        return float(np.log(norm.cdf(6.0) - norm.cdf(-4.0)) - np.log(10 * np.pi))


def _uniform(lo, hi):
    return lambda rng, n: rng.uniform(lo, hi, n)


def _half_normal(lo, hi, scale, upper=False):
    """Draws that pile up at ``lo`` (at ``hi`` with ``upper``)."""

    def draw(rng, n):
        v = np.minimum(np.abs(rng.normal(0, scale, n)), 0.999 * (hi - lo))
        return hi - v if upper else lo + v

    return draw


def _normal(loc, scale, lo=-np.inf, hi=np.inf):
    return lambda rng, n: np.clip(rng.normal(loc, scale, n), lo, hi)


_BOUNDED = dict(
    parameters=["a", "b"],
    prior_bounds={"a": [-3.0, 5.0], "b": [0.0, 10.0]},
    draws={"a": _normal(1.0, 1.5, -2.99, 4.99), "b": _uniform(0.01, 9.99)},
)
_INVERSION = dict(
    parameters=["a", "b", "c"],
    prior_bounds={"a": [0.0, 10.0], "b": [0.0, 10.0], "c": [-2.0, 2.0]},
    # a piles up at its lower bound, b at its upper, c at neither
    draws={"a": _half_normal(0.0, 10.0, 2.0), "b": _half_normal(0.0, 10.0, 2.0, upper=True),
           "c": _normal(0.0, 0.3, -1.99, 1.99)},
)
_UNIT = dict(
    parameters=["a", "b"],
    prior_bounds={"a": [0.0, 1.0], "b": [0.0, 1.0]},
    draws={"a": _uniform(0.02, 0.98), "b": _normal(0.4, 0.1, 0.01, 0.99)},
)
_GAUSSIAN = dict(
    parameters=["a", "b"],
    prior_bounds={"a": [-10.0, 10.0], "b": [-10.0, 10.0]},
    draws={"a": _normal(1.0, 2.0), "b": _normal(-2.0, 0.5)},
)
_POSITIVE = dict(
    parameters=["a", "b"],
    prior_bounds={"a": [0.1, 20.0], "b": [0.1, 20.0]},
    draws={"a": lambda rng, n: np.exp(rng.normal(0.5, 0.5, n)), "b": _uniform(0.5, 10.0)},
)
_ANGLE_2PI = dict(
    parameters=["t"], prior_bounds={"t": [0.0, 2 * np.pi]}, draws={"t": _uniform(0.0, 2 * np.pi)}
)
#: an angle with its radius given as a second parameter
_ANGLE_RADIUS = dict(
    parameters=["t", "r"],
    prior_bounds={"t": [0.0, 2 * np.pi], "r": [0.0, 5.0]},
    draws={"t": _uniform(0.0, 2 * np.pi), "r": _uniform(0.1, 5.0)},
)
_DISCRETE = dict(
    parameters=["k"], prior_bounds={"k": [0.0, 4.0]}, draws={"k": lambda rng, n: rng.integers(0, 5, n).astype(float)}
)

#: For every name of the reparameterisation registry: its parameters,
#: their prior bounds, the keyword arguments it needs beyond the
#: registry's, and draws of in-range data for each parameter (``draw(rng,
#: n)``). Used to hold the port's reparameterisations against the JAX
#: package's and their device inverses against the host's.
REPARAMETERISATION_CASES = {
    **{name: _BOUNDED for name in ("default", "rescaletobounds", "rescale-to-bounds", "offset",
                                   "angle-sine", "angle-cosine", "logit", "log-rescale")},
    "inversion": _INVERSION,
    "inversion-duplicate": _INVERSION,
    "scale": dict(_GAUSSIAN, kwargs={"scale": 2.5}),
    "rescale": dict(_GAUSSIAN, kwargs={"scale": [2.5, 0.5]}),
    "scaleandshift": dict(_GAUSSIAN, kwargs={"scale": 2.0, "shift": {"a": 1.0, "b": -1.0}}),
    **{name: _GAUSSIAN for name in ("zscore", "standardize", "z-score", "zscore-gaussian-cdf",
                                    "z-score-gaussian-cdf")},
    **{name: _UNIT for name in ("z-score-logit", "zscore-logit", "z-score-inv-gaussian-cdf",
                                "zscore-inv-gaussian-cdf")},
    **{name: _POSITIVE for name in ("log-z-score", "log-standardise")},
    "angle": _ANGLE_RADIUS,
    "angle-2pi": _ANGLE_2PI,
    "angle-pi": dict(parameters=["t"], prior_bounds={"t": [0.0, np.pi]}, draws={"t": _uniform(0.0, np.pi)}),
    "periodic": dict(parameters=["t"], prior_bounds={"t": [-2.0, 2.0]}, draws={"t": _uniform(-2.0, 2.0)}),
    "angle-pair": dict(
        parameters=["ra", "dec"],
        prior_bounds={"ra": [0.0, 2 * np.pi], "dec": [-np.pi / 2, np.pi / 2]},
        draws={"ra": _uniform(0.0, 2 * np.pi), "dec": lambda rng, n: np.arcsin(rng.uniform(-0.99, 0.99, n))},
    ),
    "to-cartesian": dict(parameters=["a"], prior_bounds={"a": [-3.0, 5.0]}, draws={"a": _uniform(-2.99, 4.99)}),
    "dequantise": _DISCRETE,
    "dequantise-logit": _DISCRETE,
    **{name: _BOUNDED for name in ("none", "null", None)},
}


def reparameterisation_case(name, n: int, seed: int):
    """The registered reparameterisation ``name``'s case of
    :data:`REPARAMETERISATION_CASES`: ``(parameters, prior_bounds, kwargs,
    data)`` with ``n`` draws of each parameter from ``seed``."""
    case = REPARAMETERISATION_CASES[name]
    rng = np.random.default_rng(seed)
    data = {p: case["draws"][p](rng, n) for p in case["parameters"]}
    bounds = {p: list(b) for p, b in case["prior_bounds"].items()}
    return list(case["parameters"]), bounds, dict(case.get("kwargs", {})), data


#: The regimes of :func:`ns_scan_case`, the branches of the scan kernel
#: (``csrc/ns_scan.cu``): rejections in bulk, accepts, the capped tail.
NS_SCAN_REGIMES = ("mixed", "terminal", "ascending", "nan_inf", "ties")


def ns_scan_case(regime, n: int, k: int, seed: int):
    """Sorted live logL ``[n]`` and a pool ``[k]`` in pop order, float32
    numpy arrays from ``seed``, for the consume/insert scan in one of
    :data:`NS_SCAN_REGIMES`:

    - ``mixed``: a pool around the live set's lowest fifth, with ties to
      its worst and middle points and -inf padding in its last sixteenth
      (a bucketed pool);
    - ``terminal``: about one candidate in 400 (at least one) above the
      worst live point, the rest at or below it, as near the end of a
      run;
    - ``ascending``: an ascending pool above the worst live point, so that
      every step accepts;
    - ``nan_inf``: ``mixed`` without padding, with NaN, +inf and -inf
      candidates;
    - ``ties``: the worst eighth of the live set one value and runs of five
      candidates equal to it between candidates that may be accepted.
    """
    rng = np.random.default_rng(seed)
    live = np.sort(rng.normal(size=n)).astype(np.float32)
    if regime == "ties":
        live[: max(1, n // 8)] = live[0]
    pool = rng.normal(loc=float(live[n // 5]), scale=2.0, size=k).astype(np.float32)
    pool[1::11] = live[n // 2]
    if regime == "mixed":
        pool[::5] = live[0]
        pool[len(pool) - k // 16 :] = -np.inf
    elif regime == "terminal":
        pool = (live[0] - np.abs(rng.normal(size=k))).astype(np.float32)
        pool[::7] = live[0]
        above = rng.choice(k, size=min(k, max(1, k // 400)), replace=False)
        pool[above] = rng.uniform(live[0], live[min(n - 1, n // 10)], size=above.size) + 1e-3
    elif regime == "ascending":
        span = float(live[-1] - live[0]) + 1.0
        pool = (live[0] + 1e-2 + np.linspace(0.0, span, k)).astype(np.float32)
    elif regime == "nan_inf":
        pool[::9] = np.nan
        pool[4::13] = np.inf
        pool[7::17] = -np.inf
    elif regime == "ties":
        pool[np.arange(k) % 8 < 5] = live[0]
    else:
        raise ValueError(f"unknown scan regime {regime!r}")
    return live, pool


NS_SCAN_UNBOUNDED = 2**31 - 1
#: The scan's check rows on the card, unbounded and capped at 17 accepts
#: (``chip_smoke.py`` ``ns_scan_vs_plain``, ``utils/compare_scan.py``).
#: ``(nlive, K)`` with inputs from one CUDA generator in order: the
#: flagship's live set with a pool of its size, larger pools at nlive
#: 2000 and 10,000 (the egg-box's and the hypercube run's nlive), and
#: 40,000 live points on the global path.
NS_SCAN_SHAPES = [(1000, 1024), (2000, 4096), (10000, 16384), (40000, 4096)]
NS_SCAN_CAPS = (NS_SCAN_UNBOUNDED, 17)
#: ``(regime, nlive, K, caps)`` with inputs from :func:`ns_scan_case`: the
#: egg-box's terminal pool, a pool that accepts every step, NaN and
#: infinite candidates, runs of ties, and each side of every change of the
#: kernel's shape (``ops/ns_scan.block_shape``: 8, 16 or 32 entries a lane
#: in one warp, 16 a thread in several, 32 a thread in the rings or more)
#: and of ``ops/ns_scan.memory_path``.
NS_SCAN_CASE_ROWS = [
    ("terminal", 2000, 4096, (NS_SCAN_UNBOUNDED,)),
    ("ascending", 1000, 1024, (NS_SCAN_UNBOUNDED,)),
    ("nan_inf", 1000, 1024, (NS_SCAN_UNBOUNDED,)),
    ("ties", 1000, 1024, (NS_SCAN_UNBOUNDED,)),
    ("mixed", 256, 512, (NS_SCAN_UNBOUNDED,)),
    ("mixed", 257, 512, (NS_SCAN_UNBOUNDED,)),
    ("mixed", 512, 512, (NS_SCAN_UNBOUNDED,)),
    ("mixed", 513, 512, (NS_SCAN_UNBOUNDED,)),
    ("mixed", 1024, 512, (NS_SCAN_UNBOUNDED,)),
    ("mixed", 1025, 512, (NS_SCAN_UNBOUNDED,)),
    ("mixed", 4096, 512, NS_SCAN_CAPS),
    ("mixed", 4097, 512, NS_SCAN_CAPS),
    ("mixed", 28672, 512, NS_SCAN_CAPS),
    ("mixed", 28673, 512, NS_SCAN_CAPS),
    ("mixed", 32768, 512, (NS_SCAN_UNBOUNDED,)),
    ("mixed", 32769, 512, (NS_SCAN_UNBOUNDED,)),
    ("mixed", 57344, 512, NS_SCAN_CAPS),
    ("mixed", 57345, 512, NS_SCAN_CAPS),
]


def _ns_scan_generator_inputs(gen, n, k, device):
    """Sorted live logL and a pool with ties (to the worst live point,
    to a middle one and among themselves) and -inf padding at its end,
    as a bucketed pool has."""
    live = torch.sort(torch.randn(n, generator=gen, device=device)).values
    pool = torch.randn(k, generator=gen, device=device) * 2.0 + live[n // 5]
    pool[::5] = live[0]
    pool[1::7] = live[n // 2]
    pool[2::11] = pool[3::11][: pool[2::11].numel()]
    pool[-k // 16 :] = -math.inf
    return live.contiguous(), pool.contiguous()


def ns_scan_rows(device="cuda"):
    """Every check row of the scan: ``(row, live, pool)`` with ``row`` a
    dict of its ``regime``, ``nlive``, ``pool`` size and ``max_accepts``
    and the inputs float32 tensors on ``device``: the rows of
    :data:`NS_SCAN_SHAPES` (regime ``ties_padded``), then those of
    :data:`NS_SCAN_CASE_ROWS`."""
    gen = torch.Generator(device=device).manual_seed(20261017)
    for n, k in NS_SCAN_SHAPES:
        live, pool = _ns_scan_generator_inputs(gen, n, k, device)
        for cap in NS_SCAN_CAPS:
            yield dict(regime="ties_padded", nlive=n, pool=k, max_accepts=cap), live, pool
    for regime, n, k, caps in NS_SCAN_CASE_ROWS:
        live, pool = (torch.from_numpy(a).to(device) for a in ns_scan_case(regime, n, k, seed=n + k))
        for cap in caps:
            yield dict(regime=regime, nlive=n, pool=k, max_accepts=cap), live, pool


def assert_structured_arrays_equal(x, y, atol=0.0, rtol=0.0) -> None:
    """Assert two structured arrays are (approximately) equal field-wise."""
    if x.dtype != y.dtype:
        raise AssertionError(f"dtypes differ: {x.dtype} vs {y.dtype}")
    if x.shape != y.shape:
        raise AssertionError(f"shapes differ: {x.shape} vs {y.shape}")
    for n in x.dtype.names:
        xf, yf = x[n], y[n]
        if atol == 0.0 and rtol == 0.0:
            equal = (xf == yf) | (
                np.isnan(xf.astype(float)) & np.isnan(yf.astype(float))
                if np.issubdtype(xf.dtype, np.floating)
                else np.zeros(xf.shape, dtype=bool)
            )
            if not np.all(equal):
                raise AssertionError(f"field {n} differs: {xf} vs {yf}")
        else:
            np.testing.assert_allclose(
                xf, yf, atol=atol, rtol=rtol, err_msg=f"field {n}"
            )


@contextlib.contextmanager
def time_limit(seconds: int):
    """Raise ``TimeoutError`` in the main thread when the block runs
    longer than ``seconds`` (``signal.alarm``; the SIGALRM handler in
    place before is restored after the block)."""

    def _expired(signum, frame):
        raise TimeoutError(f"block took more than {seconds} s")

    previous = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(int(seconds))
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


class _TypeRecorder(pickle.Pickler):
    """A pickler that records every object it is asked to pickle."""

    def __init__(self, file):
        super().__init__(file)
        self.seen = []

    def persistent_id(self, obj):
        self.seen.append(obj)
        return None


def pickled_types(obj) -> list:
    """Every object that pickling ``obj`` reaches (each with its own
    ``__reduce__`` state), through a ``pickle.Pickler`` whose
    ``persistent_id`` records them."""
    import io

    recorder = _TypeRecorder(io.BytesIO())
    recorder.dump(obj)
    return recorder.seen
