"""The port's example modules (``nessai_tpu_torch.examples``) against the
JAX package's scripts (``examples/``).

Each module's ``SAMPLER_KWARGS`` (and ``RUN_KWARGS``) must equal the
keyword arguments of the script's ``FlowSampler`` call (and of its
``run``), read from the script's source, so that a module's width cannot
drift from its script's. Each module then runs on the CPU at a small size
(nlive 100-200, a cap on the iterations or levels, short trainings), with
its gates: finite evidence of the expected shape, a pull within 3 sigma of
the analytic evidence where the capped run reaches it, the same bits with
and without the likelihood pool, the figures written and read back, and a
resume from a checkpoint that holds the checkpoint's state."""

import ast
import importlib
import math
import os
import pathlib
import pickle

import numpy as np
import pytest
import torch

from nessai_tpu_torch import config
from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.utils.testing import rosenbrock_log_evidence, time_limit

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: port module -> the JAX script it stands for
SCRIPTS = {
    "gaussian_2d": "2d_gaussian.py",
    "unbounded_prior": "unbounded_prior.py",
    "discrete_parameter": "discrete_parameter.py",
    "rosenbrock": "rosenbrock.py",
    "parallelisation_example": "parallelisation_example.py",
    "corner_plot_example": "corner_plot_example.py",
    "eggbox": "eggbox.py",
    "half_gaussian": "half_gaussian.py",
    "augmented_example": "augmented_example.py",
    "mcmc_example": "mcmc_example.py",
    "reparameterisations_example": "reparameterisations_example.py",
    "importance_nested_sampler.basic_ins_example": "importance_nested_sampler/basic_ins_example.py",
    "importance_nested_sampler.ins_gaussian": "importance_nested_sampler/ins_gaussian.py",
    "importance_nested_sampler.hypercube_prior": "importance_nested_sampler/hypercube_prior.py",
    "importance_nested_sampler.ins_resume": "importance_nested_sampler/ins_resume.py",
    "importance_nested_sampler.ins_gaussian_mixture": "importance_nested_sampler/ins_gaussian_mixture.py",
    "importance_nested_sampler.nsf_unit_hypercube": "importance_nested_sampler/nsf_unit_hypercube.py",
}

#: the small size of every CPU run: short trainings
SMALL_TRAINING = dict(max_epochs=20, patience=5)
PULL_LIMIT = 3.0


@pytest.fixture(autouse=True)
def _two_threads_and_clean_fields():
    """Two intra-op threads (the runs' eager training steps contend for the
    cores with the other test processes otherwise), and the live-point
    fields an importance nested sampler adds taken out afterwards."""
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(previous)
    config.livepoints.reset()


def _module(name):
    return importlib.import_module(f"nessai_tpu_torch.examples.{name}")


def _literal(node, assigned):
    """A keyword argument's value: a literal, a ``dict(...)`` of literals,
    or a name the script assigned one of those."""
    if isinstance(node, ast.Name) and node.id in assigned:
        return _literal(assigned[node.id], assigned)
    if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "dict" and not node.args:
        return {k.arg: _literal(k.value, assigned) for k in node.keywords}
    return ast.literal_eval(node)


def _script_calls(script):
    """``(model source, FlowSampler keywords)`` of each ``FlowSampler``
    call of the script, in order, and the keywords of each ``run`` call;
    the output and ``resume`` are left out (the modules' runners pass
    their own)."""
    tree = ast.parse((ROOT / "examples" / script).read_text())
    assigned = {
        node.targets[0].id: node.value
        for node in ast.walk(tree)
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)
    }
    calls, runs = [], []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = getattr(node.func, "id", None) or getattr(node.func, "attr", None)
        if name == "FlowSampler":
            kwargs = {k.arg: _literal(k.value, assigned) for k in node.keywords if k.arg not in ("output", "resume")}
            model = node.args[0]
            if isinstance(model, ast.Name):
                model = assigned[model.id]
            calls.append((node.lineno, ast.unparse(model), kwargs))
        elif name == "run" and isinstance(node.func, ast.Attribute):
            runs.append((node.lineno, {k.arg: _literal(k.value, assigned) for k in node.keywords}))
    calls.sort()
    runs.sort()
    return [(model, kwargs) for _, model, kwargs in calls], [kwargs for _, kwargs in runs]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_sampler_kwargs_are_the_scripts(name):
    module = _module(name)
    calls, runs = _script_calls(SCRIPTS[name])
    ours = [module.SAMPLER_KWARGS]
    if hasattr(module, "STANDARD_KWARGS"):
        ours = [module.STANDARD_KWARGS, module.SAMPLER_KWARGS]
    assert [kwargs for _, kwargs in calls] == ours
    run_kwargs = getattr(module, "RUN_KWARGS", {})
    assert all(r == run_kwargs for r in runs), (runs, run_kwargs)
    # the model of the script, by its class (and its dimensions)
    model = calls[-1][0]
    dims = getattr(module, "DIMS", None)
    assert model.endswith(f"({dims})" if dims is not None else "()"), model


def test_every_jax_script_has_a_module_or_waits_for_bilby():
    scripts = {p.relative_to(ROOT / "examples").as_posix() for p in (ROOT / "examples").rglob("*.py")}
    scripts = {s for s in scripts if not s.startswith("gw/")}
    assert scripts - set(SCRIPTS.values()) == {"bilby_example.py", "bilby_unbounded_priors.py"}


def _pull(fs, analytic):
    return (fs.logZ - analytic) / fs.logZ_error


def _run(model, output, kwargs, run_kwargs=None):
    fs = FlowSampler(model, output=str(output), resume=False, device="cpu", **kwargs)
    fs.run(**dict(dict(plot=False, save=False), **(run_kwargs or {})))
    assert np.isfinite(fs.logZ) and np.isfinite(fs.logZ_error) and fs.logZ_error > 0
    assert len(fs.posterior_samples) > 0
    assert set(model.names) <= set(fs.posterior_samples.dtype.names)
    return fs


def _small(kwargs, **extra):
    out = dict(kwargs, plot=False, checkpointing=False, training_config=SMALL_TRAINING)
    out.update(extra)
    return out


#: module -> (model arguments, the small run's overrides, whether it runs
#: to its end so that its pull is gated)
STANDARD = {
    "gaussian_2d": ((), dict(nlive=200), True),
    "unbounded_prior": ((), dict(nlive=200), True),
    "discrete_parameter": ((), dict(nlive=100, max_iteration=400), False),
    "rosenbrock": (None, dict(nlive=100, max_iteration=400), False),
    "eggbox": (None, dict(nlive=100, max_iteration=400), False),
    "half_gaussian": ((), dict(nlive=100, max_iteration=400), False),
    "augmented_example": ((), dict(nlive=100, max_iteration=400), False),
    "mcmc_example": ((), dict(nlive=100, max_iteration=400, n_steps=5), False),
    "reparameterisations_example": ((), dict(nlive=100, max_iteration=400), False),
}

_MODELS = {
    "gaussian_2d": "GaussianModel",
    "unbounded_prior": "GaussianPriorModel",
    "discrete_parameter": "DiscreteModel",
    "rosenbrock": "RosenbrockModel",
    "eggbox": "EggboxModel",
    "half_gaussian": "HalfGaussianModel",
    "augmented_example": "BimodalGaussianModel",
    "mcmc_example": "GaussianModel",
    "reparameterisations_example": "AngleModel",
}


@pytest.mark.parametrize("name", sorted(STANDARD))
def test_standard_examples_run(tmp_path, name):
    module = _module(name)
    args, small, in_full = STANDARD[name]
    args = (module.DIMS,) if args is None else args
    model = getattr(module, _MODELS[name])(*args)
    fs = _run(model, tmp_path, _small(module.SAMPLER_KWARGS, **small))
    if in_full:
        assert abs(_pull(fs, model.analytic_log_evidence)) < PULL_LIMIT
    else:
        assert fs.ns.iteration == small["max_iteration"]


def test_discrete_parameter_draws_integers_and_its_evidence():
    from nessai_tpu_torch.examples.discrete_parameter import DiscreteModel, discrete_log_evidence

    model = DiscreteModel()
    model.set_rng(np.random.default_rng(0))
    points = model.new_point(1000)
    assert set(np.unique(points["w"])) == {0.0, 1.0}
    assert np.isfinite(model.log_prior(points)).all()
    # the quadrature converged: twice the points give the same log Z
    assert abs(discrete_log_evidence(10001) - discrete_log_evidence()) < 1e-9
    assert abs(rosenbrock_log_evidence(2, n=2001) - rosenbrock_log_evidence(2)) < 1e-6


def test_unbounded_prior_draws_its_prior(tmp_path):
    from nessai_tpu_torch.examples.unbounded_prior import GaussianPriorModel

    model = GaussianPriorModel()
    model.set_rng(np.random.default_rng(1))
    points = model.new_point(20000)
    assert abs(np.std(points["y"]) - 5.0) < 0.15 and abs(np.mean(points["x"])) < 0.2
    np.testing.assert_array_equal(model.new_point_log_prob(points), model.log_prior(points))


def test_parallelisation_example_pool_gives_the_same_bits(tmp_path):
    from nessai_tpu_torch.examples.parallelisation_example import SAMPLER_KWARGS, ScalarGaussian

    small = dict(nlive=100, max_iteration=300)
    runs = {}
    for pooled in (False, True):
        kwargs = _small(SAMPLER_KWARGS, **small)
        if not pooled:
            kwargs.pop("n_pool")
        model = ScalarGaussian()
        # a forked worker can hang where the test process has threads
        with time_limit(120):
            fs = _run(model, tmp_path / str(pooled), kwargs)
        runs[pooled] = (fs, model)
    (plain, plain_model), (pooled, pooled_model) = runs[False], runs[True]
    assert pooled.logZ == plain.logZ and pooled.ns.iteration == plain.ns.iteration == 300
    assert pooled_model.likelihood_evaluations == plain_model.likelihood_evaluations
    assert pooled_model.pool is None


def _read_back(filename):
    import matplotlib.image

    image = matplotlib.image.imread(filename)
    assert image.ndim == 3 and image.shape[0] > 100 and image.shape[1] > 100
    return image


def test_corner_plot_example_writes_its_figure(tmp_path):
    module = _module("corner_plot_example")
    fs = _run(module.GaussianModel(), tmp_path, _small(module.SAMPLER_KWARGS, nlive=200), module.RUN_KWARGS)
    assert abs(_pull(fs, -math.log(400.0))) < PULL_LIMIT
    _read_back(module.plot_posterior(fs, str(tmp_path)))


#: module -> (model arguments, the small run's overrides)
INS = {
    "importance_nested_sampler.basic_ins_example": (None, dict(nlive=200, min_samples=50, max_iteration=3)),
    "importance_nested_sampler.ins_gaussian": (None, dict(nlive=200, min_samples=50, max_iteration=3)),
    "importance_nested_sampler.ins_gaussian_mixture": (
        None, dict(nlive=200, min_samples=50, max_iteration=3, tolerance=[0.0, 300])
    ),
    "importance_nested_sampler.nsf_unit_hypercube": (
        None, dict(nlive=200, min_samples=50, max_iteration=3, flow_config=dict(
            _module("importance_nested_sampler.nsf_unit_hypercube").FLOW_CONFIG, n_neurons=8))
    ),
}


@pytest.mark.parametrize("name", sorted(INS))
def test_ins_examples_run(tmp_path, name):
    module = _module(name)
    _, small = INS[name]
    model_name = [n for n in ("RosenbrockModel", "GaussianModel", "GaussianMixture") if hasattr(module, n)][0]
    model = getattr(module, model_name)(module.DIMS)
    run_kwargs = dict(getattr(module, "RUN_KWARGS", {}))
    if run_kwargs:
        run_kwargs["n_posterior_samples"] = 200
    fs = _run(model, tmp_path, _small(module.SAMPLER_KWARGS, **small), run_kwargs)
    assert fs.ns.iteration == small["max_iteration"]


def test_hypercube_prior_both_samplers_and_their_figure(tmp_path):
    module = _module("importance_nested_sampler.hypercube_prior")
    model = module.ModelWithNonUniformPrior(module.DIMS)
    analytic = model.analytic_log_evidence
    # the prior's density in the hypercube is the prior's, carried by the
    # affine map
    model.set_rng(np.random.default_rng(2))
    x = model.new_point(50)
    u = model.to_unit_hypercube(x)
    np.testing.assert_allclose(
        model.log_prior_unit_hypercube(u), model.log_prior(x) + module.DIMS * np.log(20.0), rtol=1e-9
    )
    fs = _run(model, tmp_path / "standard", _small(module.STANDARD_KWARGS, nlive=200))
    fs_ins = _run(module.ModelWithNonUniformPrior(module.DIMS), tmp_path / "ins",
                  _small(module.SAMPLER_KWARGS, nlive=200, min_samples=50))
    for run in (fs, fs_ins):
        assert abs(_pull(run, analytic)) < PULL_LIMIT
    gap = (fs.logZ - fs_ins.logZ) / math.hypot(fs.logZ_error, fs_ins.logZ_error)
    assert abs(gap) < PULL_LIMIT
    _read_back(module.plot_comparison(fs, fs_ins, str(tmp_path)))


def test_ins_resume_holds_the_checkpoint(tmp_path):
    """Interrupted at the checkpoint of its second level (a level cap), then
    resumed from the file: the state as checkpointed (the samples bit for
    bit, log_q recomputed through the reloaded levels within 1e-5, logZ
    within 1e-8), and the resumed run to its end within 3 sigma."""
    from nessai_tpu_torch.samplers.base import safe_file_dump

    module = _module("importance_nested_sampler.ins_resume")
    kwargs = dict(module.SAMPLER_KWARGS, nlive=200, min_samples=50, plot=False, training_config=SMALL_TRAINING)
    recorded = {}

    def at_checkpoint(sampler):
        if sampler.finalised:
            return
        safe_file_dump(sampler, sampler.resume_file)
        recorded.update(
            iteration=sampler.iteration,
            samples=sampler.training_samples.samples.copy(),
            log_q=sampler.training_samples.log_q.copy(),
            logZ=sampler.log_evidence,
        )

    first = FlowSampler(module.GaussianModel(), output=str(tmp_path), device="cpu",
                        **dict(kwargs, max_iteration=2, checkpoint_callback=at_checkpoint))
    first.run(plot=False, save=False)
    assert recorded["iteration"] == 2
    with open(first.ns.resume_file, "rb") as f:
        assert pickle.load(f).iteration == 2
    fs = FlowSampler(module.GaussianModel(), output=str(tmp_path), device="cpu", **kwargs)
    ns = fs.ns
    assert ns.iteration == 2
    assert ns.training_samples.samples.tobytes() == recorded["samples"].tobytes()
    assert np.abs(ns.training_samples.log_q - recorded["log_q"]).max() <= 1e-5
    assert abs(ns.log_evidence - recorded["logZ"]) <= 1e-8
    ns.configure_iterations(max_iteration=None)
    fs.run(plot=False, save=False)
    assert ns.iteration > 2
    assert abs(_pull(fs, -math.log(400.0))) < PULL_LIMIT
    assert os.path.exists(ns.resume_file)
