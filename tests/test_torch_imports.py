"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points refuse to run on the CPU unless asked."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "nessai_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "nessai_tpu")


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_imports_in_source(path):
    bad = [m for m in _top_level_imports(path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_every_module_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nessai_tpu_torch\n"
        "for m in pkgutil.walk_packages(nessai_tpu_torch.__path__, 'nessai_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('nessai_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=str(ROOT),
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) > 30


@pytest.mark.parametrize(
    "module",
    [
        "stopping_criteria",
        "flowmodel.importance",
        "proposal.importance",
        "samplers.importancesampler",
        "utils.rescaling",
        "utils.stats",
        "utils.information",
        "utils.structures",
        "utils.optimise",
    ],
)
def test_import_walk_reaches_the_importance_sampler(module):
    """The walk of ``test_import_every_module_without_jax`` imports the
    importance nested sampler's modules too."""
    import pkgutil

    import nessai_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(nessai_tpu_torch.__path__, "nessai_tpu_torch.")}
    assert f"nessai_tpu_torch.{module}" in names


@pytest.mark.parametrize(
    "module",
    [
        "reparameterisations.base",
        "reparameterisations.rescale",
        "reparameterisations.angle",
        "reparameterisations.discrete",
        "reparameterisations.combined",
        "reparameterisations.utils",
        "utils.hist",
        "utils.entry_points",
        "utils.sorting",
    ],
)
def test_import_walk_reaches_the_reparameterisations(module):
    """The walk of ``test_import_every_module_without_jax`` imports the
    reparameterisations and the modules they need."""
    import pkgutil

    import nessai_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(nessai_tpu_torch.__path__, "nessai_tpu_torch.")}
    assert f"nessai_tpu_torch.{module}" in names


def _model():
    from nessai_tpu_torch.utils.testing import IntegrationTestModel

    return IntegrationTestModel(2)


def test_flowsampler_without_gpu_raises(tmp_path, monkeypatch):
    from nessai_tpu_torch.flowsampler import FlowSampler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        FlowSampler(_model(), output=str(tmp_path), nlive=50)
    with pytest.raises(RuntimeError, match="GPU"):
        FlowSampler(_model(), output=str(tmp_path), nlive=50, device="cuda")


def test_flowsampler_on_cpu_when_asked(tmp_path):
    from nessai_tpu_torch.flowsampler import FlowSampler

    fs = FlowSampler(_model(), output=str(tmp_path), nlive=50, device="cpu")
    assert fs.ns.device == torch.device("cpu")
    assert fs.ns.flow_proposal.device == torch.device("cpu")


@pytest.mark.parametrize(
    "entry", ["flowmodel", "proposal", "model"]
)
def test_other_entry_points_without_gpu_raise(entry, tmp_path, monkeypatch):
    from nessai_tpu_torch.flowmodel import FlowModel
    from nessai_tpu_torch.proposal import FlowProposal

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        if entry == "flowmodel":
            FlowModel(dict(n_inputs=2), output=str(tmp_path))
        elif entry == "proposal":
            FlowProposal(_model(), output=str(tmp_path))
        else:
            m = _model()
            m.set_rng(np.random.default_rng(1))
            m.batch_evaluate_log_likelihood(m.new_point(4))


def test_cpu_tensors_take_the_plain_version():
    from nessai_tpu_torch.ops import coupling

    coupling.affine_coupling.launches = 0
    rng = np.random.default_rng(3)
    x, s, t = (torch.as_tensor(rng.normal(size=(16, 2)), dtype=torch.float32) for _ in range(3))
    y, ld = coupling.affine_coupling(x, s, t)
    y_ref, ld_ref = coupling.affine_coupling_plain(x, s, t)
    assert torch.equal(y, y_ref) and torch.equal(ld, ld_ref)
    assert coupling.affine_coupling.launches == 0


@pytest.mark.parametrize(
    "module",
    [
        "plot",
        "utils.io",
        "utils.threading",
        "utils.settings",
        "utils.multiprocessing",
        "utils.multirun",
    ],
)
def test_import_walk_reaches_the_persistence_layer(module):
    """The walk of ``test_import_every_module_without_jax`` imports the
    result files, plots, pool and multi-seed modules too."""
    import pkgutil

    import nessai_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(nessai_tpu_torch.__path__, "nessai_tpu_torch.")}
    assert f"nessai_tpu_torch.{module}" in names


def test_samplers_import_without_matplotlib_or_h5py(tmp_path):
    """Without matplotlib and h5py every module but ``plot`` imports, and
    a sampler runs with ``plot=False``; ``plot`` and an HDF5 result file
    raise ``ImportError``, as in the JAX package."""
    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('matplotlib', 'h5py', 'seaborn'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import nessai_tpu_torch\n"
        "for m in pkgutil.walk_packages(nessai_tpu_torch.__path__, 'nessai_tpu_torch.'):\n"
        "    if m.name != 'nessai_tpu_torch.plot':\n"
        "        importlib.import_module(m.name)\n"
        "try:\n"
        "    import nessai_tpu_torch.plot\n"
        "    raise SystemExit('plot imported')\n"
        "except ImportError:\n"
        "    pass\n"
        "from nessai_tpu_torch.flowsampler import FlowSampler\n"
        "from nessai_tpu_torch.utils.testing import IntegrationTestModel\n"
        f"out = {str(tmp_path)!r}\n"
        "fs = FlowSampler(IntegrationTestModel(2), output=out, nlive=50, seed=1, device='cpu',\n"
        "                 flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),\n"
        "                 training_config=dict(max_epochs=3, patience=2), signal_handling=False)\n"
        "fs.run(plot=False, save=False)\n"
        "fs.ns.plot_state()\n"
        "try:\n"
        "    fs.save_results(out + '/result', extension='hdf5')\n"
        "    raise SystemExit('hdf5 written')\n"
        "except ImportError:\n"
        "    pass\n"
        "fs.save_results(out + '/result', extension='json')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("module", ["flows.maf", "flows.distributions", "flows.bijectors", "flows.convert"])
def test_import_walk_reaches_the_flows_layer(module):
    """The walk of ``test_import_every_module_without_jax`` imports the
    masked autoregressive flow and the base distributions too."""
    import pkgutil

    import nessai_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(nessai_tpu_torch.__path__, "nessai_tpu_torch.")}
    assert f"nessai_tpu_torch.{module}" in names


@pytest.mark.parametrize(
    "module",
    [
        "proposal.augmented",
        "proposal.utils",
        "proposal.flowproposal.truncation",
    ],
)
def test_import_walk_reaches_the_configuration_surface(module):
    """The walk of ``test_import_every_module_without_jax`` imports the
    augmented proposal, the proposal classes by name and the truncation
    rules too."""
    import pkgutil

    import nessai_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(nessai_tpu_torch.__path__, "nessai_tpu_torch.")}
    assert f"nessai_tpu_torch.{module}" in names
