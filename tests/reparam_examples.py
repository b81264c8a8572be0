"""The models of the JAX package's four reparameterisation examples
(``examples/half_gaussian.py``, ``reparameterisations_example.py``,
``discrete_parameter.py`` and ``unbounded_prior.py``), built on either
package's ``Model``, with the spec each example passes and its analytic
log-evidence where one is known."""

import numpy as np
from scipy.stats import halfnorm, norm, vonmises

#: the data of the discrete example's model selection
_RNG_DATA = np.random.default_rng(42)
X_DATA = np.linspace(0, 2 * np.pi, 50)
Y_DATA = np.sin(X_DATA) + _RNG_DATA.normal(scale=0.2, size=50)

SPECS = {
    "half_gaussian": {"x": "inversion", "y": "default"},
    "angle": {"theta": {"reparameterisation": "angle-2pi"}, "amp": "default"},
    "discrete": {"w": "dequantise", "amp": "default"},
    "unbounded_prior": {"x": "default", "y": "zscore"},
}
ANALYTIC = {
    "half_gaussian": -np.log(200.0),
    "angle": float(np.log(norm.cdf(6.0) - norm.cdf(-4.0)) - np.log(10 * np.pi)),
    # the Gaussian prior (sigma 5) on y against the unit likelihood in x
    # and y: log N(0 | 0, 1 + 25) - log 20, the x mass inside [-10, 10]
    # being one to double precision
    "unbounded_prior": float(norm.logpdf(0.0, scale=np.sqrt(26.0)) - np.log(20.0)),
}


def example_models(Model, empty_structured_array, numpy_array_to_live_points):
    """The four examples' model classes on ``Model``, by example name."""

    class HalfGaussianModel(Model):
        def __init__(self):
            self.names = ["x", "y"]
            self.bounds = {"x": [0, 10], "y": [-10, 10]}

        def log_prior(self, x):
            with np.errstate(divide="ignore"):
                log_p = np.log(self.in_bounds(x), dtype="float")
            for n in self.names:
                log_p -= np.log(self.bounds[n][1] - self.bounds[n][0])
            return log_p

        def log_likelihood(self, x):
            return halfnorm.logpdf(x["x"]) + norm.logpdf(x["y"])

    class AngleModel(Model):
        def __init__(self):
            self.names = ["theta", "amp"]
            self.bounds = {"theta": [0, 2 * np.pi], "amp": [0, 5]}

        def log_prior(self, x):
            with np.errstate(divide="ignore"):
                log_p = np.log(self.in_bounds(x), dtype="float")
            for n in self.names:
                log_p -= np.log(np.ptp(self.bounds[n]))
            return log_p

        def log_likelihood(self, x):
            return vonmises.logpdf(x["theta"], kappa=2, loc=np.pi) + norm.logpdf(x["amp"], loc=2, scale=0.5)

    class DiscreteModel(Model):
        """Signal = w sin(x) + (1 - w) cos(x) with a discrete w in {0, 1}."""

        def __init__(self):
            self.names = ["amp", "w"]
            self.bounds = {"amp": [0.1, 2.0], "w": [0, 1]}
            self.discrete_parameters = ["w"]

        def new_point(self, N=1):
            rng = self._require_rng()
            x = empty_structured_array(N, self.names)
            x["amp"] = rng.uniform(*self.bounds["amp"], size=N)
            x["w"] = rng.choice([0, 1], size=N)
            return x

        def new_point_log_prob(self, x):
            return -np.log(np.ptp(self.bounds["amp"]) * 2.0) * np.ones(len(x))

        def log_prior(self, x):
            with np.errstate(divide="ignore"):
                log_p = np.log(self.in_bounds(x), dtype="float")
                log_p -= np.log(np.ptp(self.bounds["amp"]))
                log_p += np.log(~(x["w"] % 1).astype(bool))
            return log_p - np.log(2)

        def log_likelihood(self, x):
            x = np.atleast_1d(x)
            w = np.round(x["w"])[:, None]
            signal = x["amp"][:, None] * (w * np.sin(X_DATA) + (1 - w) * np.cos(X_DATA))
            return norm.logpdf(Y_DATA - signal, scale=0.2).sum(axis=1)

    class GaussianPriorModel(Model):
        """Uniform prior on x, Gaussian prior (sigma 5) on y."""

        def __init__(self):
            self.names = ["x", "y"]
            self.bounds = {"x": [-10, 10], "y": [-100, 100]}

        def log_prior(self, x):
            return -np.log(20) * np.ones(x.size) + norm.logpdf(x["y"], scale=5)

        def new_point(self, N=1):
            rng = self._require_rng()
            arr = np.stack([rng.uniform(-10, 10, N), norm.rvs(scale=5, size=N, random_state=rng)], axis=1)
            return numpy_array_to_live_points(arr, self.names)

        def new_point_log_prob(self, x):
            return self.log_prior(x)

        def log_likelihood(self, x):
            return norm.logpdf(x["x"]) + norm.logpdf(x["y"])

    return {
        "half_gaussian": HalfGaussianModel,
        "angle": AngleModel,
        "discrete": DiscreteModel,
        "unbounded_prior": GaussianPriorModel,
    }
