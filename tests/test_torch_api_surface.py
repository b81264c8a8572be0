"""The port's public surface against the JAX package's: for every module
of ``nessai_tpu/`` with an ``__all__``, every name in it has a
counterpart in the port's module of the same path (in that module's
``__all__``), or stands in ``EXEMPT`` with its reason; and every public
member of every public class has a counterpart on the port's class, is
or is JAX idiom (``EXEMPT_MEMBERS``). Read from the sources (``ast``),
nothing imported."""

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


# ---------------------------------------------------------------------------
# Members of public classes
# ---------------------------------------------------------------------------
#
# For every public class of every JAX module, each public method, property
# and class attribute (inherited ones included) has a counterpart of the
# same name on the port's class of the same module path (a method,
# property, class attribute or an attribute its methods set), or is JAX
# idiom (``EXEMPT_MEMBERS``).

#: member name, or a prefix ending in "_", -> why the port has no
#: counterpart of that name
EXEMPT_MEMBERS = {
    "init": _PYTREE + "; a bijector, base or flow makes its parameters in __init__",
    "jax_": "a jnp function or a jitted program's runtime input; the port's counterpart is the torch_ member "
    "(torch_inverse, torch_log_prior_fn, torch_log_likelihood, torch_log_prior, torch_likelihood_data)",
    "has_jax_": "the port's counterparts are has_torch_likelihood and has_torch_prior",
    "jit": "switches JAX's jit; the port runs eagerly",
    "use_pallas": "switches the Pallas kernels; the port's kernels launch on every CUDA tensor",
    "program_fingerprint": _TUNNEL + ": the key of the compiled-program cache",
    "precompile_async": _TUNNEL + ": ahead-of-time XLA compilation",
    "key": "a JAX PRNG key; the port draws from a torch.Generator (FlowModel.device_generator)",
    "next_key": "splits a JAX PRNG key; the port draws from a torch.Generator (FlowModel.device_generator)",
}

#: "module:Class" of the JAX class that defines the members (subclasses
#: inherit the entry) -> the members that were the last to be ported; each
#: has a test against the JAX member in tests/test_torch_members.py
LAST_PORTED = {
    "config.py:LivepointsConfig": ("core_parameters_defaults", "core_parameters_dtype", "reset_properties"),
    "config.py:_BaseConfig": ("asdict",),
    "flowmodel/base.py:FlowModel": (
        "base_distribution_log_prob",
        "check_batch_size",
        "freeze_transform",
        "get_optimiser",
        "move_to",
        "noise_scale",
        "noise_type",
        "numpy_array_to_tensor",
        "optimiser_kwargs",
        "sample_and_log_prob",
        "sample_latent_distribution",
        "setup_from_input_dict",
        "unfreeze_transform",
        "update_mask",
    ),
    "flowmodel/config.py:TrainingConfig": ("dtype",),
    "flowmodel/importance.py:ImportanceFlowModel": ("model",),
    "flows/base.py:Flow": ("base_distribution_log_prob", "loss"),
    "proposal/base.py:Proposal": ("evaluate_likelihoods", "reset"),
    "proposal/flowproposal/base.py:BaseFlowProposal": (
        "check_prior_bounds",
        "flow_dims",
        "internal_prime_parameters",
        "latent_log_prob",
        "population_dtype",
        "rescaled_dims",
        "reset_model_weights",
        "sample_latent_distribution",
        "x_prime_internal_dtype",
    ),
    "reparameterisations/combined.py:CombinedReparameterisation": ("update_bounds",),
    "reparameterisations/rescale.py:RescaleToBounds": ("update_bounds_enabled",),
    "reparameterisations/rescale.py:ScaleAndShift": ("as_affine",),
    "samplers/base.py:BaseNestedSampler": ("posterior_effective_sample_size",),
    "samplers/importancesampler.py:ImportanceNestedSampler": (
        "add_level_post_sampling",
        "check_configuration",
        "current_proposal_entropy",
        "get_proposal",
        "log_q",
        "posterior_samples_set",
        "sort_samples",
    ),
    "samplers/nestedsampler.py:NestedSampler": (
        "birth_log_likelihoods",
        "posterior_effective_sample_size",
        "proposal_population_time",
        "simulate_evidence_uncertainty",
    ),
}


def _trees(root: pathlib.Path):
    return {p.relative_to(root).as_posix(): ast.parse(p.read_text(), filename=str(p)) for p in sorted(root.rglob("*.py"))}


def _class_defs(trees):
    return {(rel, node.name): node for rel, tree in trees.items() for node in tree.body if isinstance(node, ast.ClassDef)}


def _imported_from(rel, tree):
    """name -> module path of each relative ``from ... import name``."""
    here = rel.split("/")[:-1]
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            parts = here[: len(here) - node.level + 1] + (node.module.split(".") if node.module else [])
            for alias in node.names:
                out[alias.asname or alias.name] = "/".join(parts)
    return out


class _Package:
    def __init__(self, root):
        self.trees = _trees(root)
        self.classes = _class_defs(self.trees)

    def resolve(self, rel, name, seen=()):
        """The class ``name`` as seen from module ``rel``: defined there,
        imported relatively, or the one class of that name."""
        if (rel, name) in self.classes:
            return (rel, name)
        module = _imported_from(rel, self.trees[rel]).get(name)
        for cand in (f"{module}.py", f"{module}/__init__.py") if module else ():
            if cand in self.trees and cand not in seen:
                found = self.resolve(cand, name, seen + (rel,))
                if found:
                    return found
        hits = [k for k in self.classes if k[1] == name]
        return hits[0] if len(hits) == 1 else None

    @staticmethod
    def own(node, with_self):
        out = set()
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.add(item.name)
                if with_self:
                    out |= {
                        sub.attr
                        for sub in ast.walk(item)
                        if isinstance(sub, ast.Attribute)
                        and isinstance(sub.ctx, ast.Store)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id == "self"
                    }
            elif isinstance(item, ast.Assign):
                out |= {t.id for t in item.targets if isinstance(t, ast.Name)}
            elif isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
                out.add(item.target.id)
        return out

    def members(self, key, with_self=False):
        """name -> the class that defines it, nearest first (own, then
        each base in order), inherited members of the package included."""
        out, order, seen = {}, [key], set()
        while order:
            k = order.pop(0)
            if k in seen:
                continue
            seen.add(k)
            node = self.classes[k]
            for name in self.own(node, with_self):
                out.setdefault(name, k)
            for b in node.bases:
                name = b.id if isinstance(b, ast.Name) else getattr(b, "attr", None)
                found = self.resolve(k[0], name) if name else None
                if found:
                    order.append(found)
        return out


JAX_PKG = _Package(JAX)
PORT_PKG = _Package(PORT)
PUBLIC_CLASSES = sorted(k for k in JAX_PKG.classes if not k[1].startswith("_"))


def _exempt(name):
    return any(name == rule or (rule.endswith("_") and name.startswith(rule)) for rule in EXEMPT_MEMBERS)


def _missing(key):
    """The public members of JAX class ``key`` without a counterpart:
    name -> "module:Class" that defines it."""
    assert key in PORT_PKG.classes, f"the port has no class {key}"
    ours = PORT_PKG.members(key, with_self=True)
    return {
        name: f"{where[0]}:{where[1]}"
        for name, where in JAX_PKG.members(key).items()
        if not name.startswith("_") and name not in ours
    }


@pytest.mark.parametrize("key", PUBLIC_CLASSES, ids=lambda k: f"{k[0]}:{k[1]}")
def test_every_public_member_has_a_counterpart(key):
    missing = {name: where for name, where in _missing(key).items() if not _exempt(name)}
    assert not missing, f"{key}: {missing}"


def test_the_last_ported_members_have_counterparts_and_tests():
    """Each of the last members to be ported is a member of its JAX class,
    has a counterpart on every port class that inherits it, and is named
    in the test file that holds it against the JAX member."""
    tests = (ROOT / "tests" / "test_torch_members.py").read_text()
    assert sum(len(v) for v in LAST_PORTED.values()) == 48
    for where, names in LAST_PORTED.items():
        key = tuple(where.split(":"))
        defined = JAX_PKG.members(key)
        for name in names:
            assert defined.get(name) == key, (where, name)
            assert name in tests, (where, name)
    for key in PUBLIC_CLASSES:
        for name, where in _missing(key).items():
            assert name not in LAST_PORTED.get(where, ()), (key, name)


def test_every_member_exemption_is_used():
    used = {
        rule
        for key in PUBLIC_CLASSES
        for name in _missing(key)
        for rule in EXEMPT_MEMBERS
        if name == rule or (rule.endswith("_") and name.startswith(rule))
    }
    assert used == set(EXEMPT_MEMBERS)


def test_model_and_errors_have_nothing_pending():
    for key in [("model.py", "Model"), ("model.py", "UniformPriorMixin"), ("utils/errors.py", "SamplingError")]:
        assert not [n for n in _missing(key) if not _exempt(n)], key
