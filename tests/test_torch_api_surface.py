"""The port's public surface against the JAX package's: for every module
of ``nessai_tpu/`` with an ``__all__``, every name in it has a
counterpart in the port's module of the same path (in that module's
``__all__``), or stands in ``EXEMPT`` with its reason. Read from the
sources (``ast``), nothing imported. Only JAX idiom is exempt."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "nessai_tpu"
PORT = ROOT / "nessai_tpu_torch"

_PALLAS = "a Pallas TPU kernel's entry; ported as a CUDA kernel behind ops.coupling and ops.rqs"
_TUNNEL = "a TPU-tunnel workaround the port does not carry over (ROADMAP, North star)"
_PYTREE = "init/apply of a network as a JAX parameter tree; the port's nets are nn.Modules (flows/nets.MLP, ResNet)"

#: (module path, name) -> why the port has no counterpart; a module's
#: every name is exempt where the name is "*"
EXEMPT = {
    ("ops/coupling_pallas.py", "*"): _PALLAS,
    ("ops/rqs_pallas.py", "*"): _PALLAS,
    ("ops/__init__.py", "affine_coupling_transform"): _PALLAS,
    ("ops/__init__.py", "rqs_pallas"): _PALLAS,
    ("utils/programs.py", "*"): _TUNNEL + ": the program cache and dispatch census",
    ("utils/compilation.py", "*"): _TUNNEL + ": the persistent XLA compilation cache",
    ("utils/transfer.py", "*"): _TUNNEL + ": batched device_get of pytrees",
    ("flows/nets.py", "init_mlp"): _PYTREE,
    ("flows/nets.py", "apply_mlp"): _PYTREE,
    ("flows/nets.py", "init_resnet"): _PYTREE,
    ("flows/nets.py", "apply_resnet"): _PYTREE,
    ("utils/rescaling.py", "get_jax_rescaling"): (
        "returns jnp functions; the port's counterpart is get_torch_rescaling"
    ),
}


def _all(path: pathlib.Path):
    """The literal ``__all__`` of a module, or None."""
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        targets = node.targets if isinstance(node, ast.Assign) else [getattr(node, "target", None)]
        if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
            return list(ast.literal_eval(node.value))
    return None


JAX_MODULES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py") if _all(p))


def test_the_jax_package_has_modules_to_audit():
    assert len(JAX_MODULES) > 40
    assert "parallel/mesh.py" in JAX_MODULES and "utils/distributions.py" in JAX_MODULES


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    names = _all(JAX / module)
    if (module, "*") in EXEMPT:
        assert not (PORT / module).exists(), module
        return
    port_module = PORT / module
    assert port_module.exists(), f"the port has no {module}"
    ours = set(_all(port_module) or [])
    missing = [n for n in names if n not in ours and (module, n) not in EXEMPT]
    assert not missing, f"{module}: {missing}"


def test_every_exemption_is_jax_idiom_with_a_reason():
    for (module, name), reason in EXEMPT.items():
        assert reason and module in JAX_MODULES, (module, name)
        if name != "*":
            assert name in _all(JAX / module), (module, name)
            # an exempt name has no counterpart: where it had one, it
            # would not need the exemption
            assert name not in (_all(PORT / module) or []), (module, name)
