"""The port's plots against the JAX package's: every function of
``plot.py``, ``_NSIntegralState.plot`` and the samplers' plot methods
draw the same data (lines, points, bars and bands, to 1e-12) from the
same inputs, and write their files."""

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")

import matplotlib.pyplot as plt  # noqa: E402

import nessai_tpu.plot as jax_plot  # noqa: E402
from nessai_tpu.evidence import _NSIntegralState as JaxNSState  # noqa: E402
from nessai_tpu.livepoint import numpy_array_to_live_points as jax_to_live_points  # noqa: E402
from nessai_tpu.samplers.importancesampler import ImportanceNestedSampler as JaxINS  # noqa: E402
from nessai_tpu.samplers.nestedsampler import NestedSampler as JaxNestedSampler  # noqa: E402
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel  # noqa: E402
import nessai_tpu_torch.plot as plot  # noqa: E402
from nessai_tpu_torch.evidence import _NSIntegralState  # noqa: E402
from nessai_tpu_torch.livepoint import numpy_array_to_live_points  # noqa: E402
from nessai_tpu_torch.samplers import ImportanceNestedSampler, NestedSampler  # noqa: E402
from nessai_tpu_torch.utils.testing import IntegrationTestModel  # noqa: E402

NAMES = ["x_0", "x_1"]


def _artists(fig):
    """The data of every axes of ``fig``: lines, point and band
    collections, bars and polygons, as float arrays."""
    out = []
    for ax in fig.axes:
        for line in ax.get_lines():
            out.append(np.asarray(line.get_xydata(), float))
        for coll in ax.collections:
            out.append(np.asarray(coll.get_offsets(), float))
            for path in coll.get_paths():
                out.append(np.asarray(path.vertices, float))
        for patch in ax.patches:
            out.append(np.asarray(patch.get_path().vertices, float))
            out.append(np.asarray(patch.get_patch_transform().get_matrix(), float))
        out.append(np.asarray(ax.get_xlim() + ax.get_ylim(), float))
    return out


def _assert_same_figures(ours, theirs):
    a, b = _artists(ours), _artists(theirs)
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-12, equal_nan=True)
    plt.close(ours)
    plt.close(theirs)


def _points(to_live_points, n=200, seed=1):
    rng = np.random.default_rng(seed)
    x = to_live_points(rng.normal(size=(n, 2)), NAMES)
    x["logL"] = -0.5 * (x["x_0"] ** 2 + x["x_1"] ** 2)
    x["logP"] = 0.0
    x["it"] = np.arange(n)
    return x


def _history():
    rng = np.random.default_rng(3)
    return dict(loss=list(rng.normal(size=20).cumsum()), val_loss=list(rng.normal(size=20).cumsum()))


CASES = {
    "plot_live_points": lambda m, lp: m.plot_live_points(lp),
    "plot_1d_comparison": lambda m, lp: m.plot_1d_comparison(lp, lp[::2], labels=["a", "b"]),
    "plot_indices": lambda m, lp: m.plot_indices(np.random.default_rng(4).integers(0, 50, size=500), 50),
    "plot_loss": lambda m, lp: m.plot_loss(7, _history()),
    "plot_trace": lambda m, lp: m.plot_trace(np.linspace(0, -5, 200), lp, live_points=lp[:20],
                                             log_x_live_points=np.linspace(-5, -6, 20)),
    "plot_histogram": lambda m, lp: m.plot_histogram(lp["x_0"], label="x_0"),
    "corner_plot": lambda m, lp: m.corner_plot(lp, exclude=["logP", "logL", "it"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plot_functions_match_the_jax_packages(name, tmp_path):
    ours = CASES[name](plot, _points(numpy_array_to_live_points))
    theirs = CASES[name](jax_plot, _points(jax_to_live_points))
    _assert_same_figures(getattr(ours, "figure", ours), getattr(theirs, "figure", theirs))
    path = tmp_path / f"{name}.png"
    fn = getattr(plot, name)
    lp = _points(numpy_array_to_live_points)
    args = {
        "plot_live_points": (lp,),
        "plot_1d_comparison": (lp,),
        "plot_indices": (np.arange(50), 50),
        "plot_loss": (3, _history()),
        "plot_trace": (np.linspace(0, -5, 200), lp),
        "plot_histogram": (lp["x_0"],),
        "corner_plot": (lp,),
    }[name]
    assert fn(*args, filename=str(path)) is None and path.exists()


def _ns_state(cls):
    state = cls(50)
    for logL in np.sort(np.random.default_rng(5).normal(size=300)):
        state.increment(logL)
    state.finalise()
    return state


def test_evidence_state_plot(tmp_path):
    _assert_same_figures(_ns_state(_NSIntegralState).plot(), _ns_state(JaxNSState).plot())
    assert _ns_state(_NSIntegralState).plot(filename=str(tmp_path / "logXlogL.png")) is None
    assert (tmp_path / "logXlogL.png").exists()


def _standard(package, tmp_path):
    """Both standard samplers with the same history, evidence state,
    nested samples and insertion indices."""
    common = dict(nlive=50, seed=2, plot=False, checkpointing=False, poolsize=50)
    if package == "torch":
        ns = NestedSampler(IntegrationTestModel(2), output=str(tmp_path / package), device="cpu", **common)
        to_lp, state = numpy_array_to_live_points, _ns_state(_NSIntegralState)
    else:
        ns = JaxNestedSampler(JaxModel(2), output=str(tmp_path / package), **common)
        to_lp, state = jax_to_live_points, _ns_state(JaxNSState)
    ns.initialise_history()
    rng = np.random.default_rng(6)
    for i in range(30):
        ns.iteration = 10 * (i + 1)
        for key in ("logZ", "dlogZ", "logLmin", "logLmax", "acceptance", "mean_acceptance"):
            ns.history[key].append(float(rng.uniform(0.01, 1)))
        ns.history["iterations"].append(ns.iteration)
    ns.history["checkpoint_iterations"] = [100, 200]
    ns.training_iterations = [50, 150, 250]
    ns.rolling_p = list(rng.uniform(size=5))
    ns.state = state
    ns.nested_samples = list(_points(to_lp, n=len(state.logLs) - 1, seed=7))
    ns.insertion_indices = list(rng.integers(0, 50, size=300))
    return ns


@pytest.mark.parametrize("method", ["plot_state", "plot_trace", "plot_insertion_indices"])
def test_standard_sampler_plots(method, tmp_path):
    ours, theirs = _standard("torch", tmp_path), _standard("jax", tmp_path)
    _assert_same_figures(getattr(ours, method)(), getattr(theirs, method)())
    path = tmp_path / f"{method}.png"
    assert getattr(ours, method)(filename=str(path)) is None and path.exists()


def _ins(package, tmp_path):
    """Both importance samplers with the same history, importance and
    sample store."""
    common = dict(nlive=100, min_samples=50, seed=2, plot=True, checkpointing=False, draw_iid_live=False)
    if package == "torch":
        ns = ImportanceNestedSampler(IntegrationTestModel(2), output=str(tmp_path / package), device="cpu", **common)
        to_lp = numpy_array_to_live_points
    else:
        ns = JaxINS(JaxModel(2), output=str(tmp_path / package), **common)
        to_lp = jax_to_live_points
    ns.initialise_history()
    rng = np.random.default_rng(8)
    h = ns.history
    for _ in range(6):
        for key in ("logZ", "min_log_likelihood", "max_log_likelihood", "logL_threshold", "live_points_ess", "logX",
                    "gradients", "leakage_live_points", "leakage_new_points", "samples_entropy", "proposal_entropy",
                    "n_added", "n_removed"):
            h[key].append(float(rng.normal()))
        for key in h["stopping_criteria"]:
            h["stopping_criteria"][key].append(float(rng.uniform()))
    h["checkpoint_iterations"] = [2, 4]
    ns.importance = {k: rng.uniform(size=5) for k in ("total", "posterior", "evidence")}
    u = rng.uniform(size=(300, 2))
    samples = to_lp(u, NAMES)
    samples["logL"] = -0.5 * ((u - 0.5) ** 2).sum(axis=1) * 50
    samples["it"] = np.repeat(np.arange(-1, 2), 100)
    samples["logW"] = rng.normal(size=300)
    samples["logQ"] = -samples["logW"]
    samples["logU"] = 0.0
    ns.training_samples.add_initial_samples(samples, np.zeros((300, 3)))
    return ns


@pytest.mark.parametrize(
    "method, args",
    [
        ("plot_state", ()),
        ("plot_trace", ()),
        ("plot_extra_state", ()),
        ("plot_likelihood_levels", ()),
        ("plot_level_cdf", (np.linspace(-3, 0, 50), np.linspace(0, 1, 50), -1.0, 0.5)),
    ],
)
def test_importance_sampler_plots(method, args, tmp_path):
    ours, theirs = _ins("torch", tmp_path), _ins("jax", tmp_path)
    _assert_same_figures(getattr(ours, method)(*args), getattr(theirs, method)(*args))
    path = tmp_path / "plots" / f"{method}.png"
    path.parent.mkdir(exist_ok=True)
    assert getattr(ours, method)(*args, filename=str(path)) is None and path.exists()


def test_importance_sampler_produce_plots(tmp_path):
    """``produce_plots`` writes the state, trace and likelihood-level
    plots (and the extra state with ``plot_extra_state``)."""
    ns = _ins("torch", tmp_path)
    ns._plot_extra_state = True
    ns.produce_plots()
    for name in ("state.png", "trace.png", "likelihood_levels.png", "state_extra.png"):
        assert (tmp_path / "torch" / name).exists(), name
