"""The JAX package's logZ of a GW example's configuration, on the CPU.

Runs the model of one script of ``examples/gw/`` through the JAX package
with the script's sampler arguments (plots and checkpoints off) on the
host CPU and prints one JSON line: logZ, its error, the iterations (INS:
levels), the likelihood evaluations and the seconds. ``chip_smoke.py``
holds the port's GW runs on the card to these values
(``GW_JAX_CPU_LOGZ``)::

    JAX_PLATFORMS=cpu python tools/gw_jax_reference.py basic|callback|ins|toy|full|calibration [SEED]

With two threads a run (``taskset -c 0,1``) the basic model took about
2 minutes, the full model about 51. With ``--port DEVICE`` after the seed
the same configuration runs through the port instead (its model from
``nessai_tpu_torch.examples.gw``) on ``DEVICE``, for the same line from
the other package.
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples", "gw"))
sys.path.insert(0, ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")

#: the JAX script of each example, its model, and the port's module that
#: states the script's sampler (and ``run``) arguments
EXAMPLES = {
    "basic": ("basic_gw_example", "BasicGWModel", "basic_gw_example"),
    "callback": ("callback_gw_example", "LalStyleGWModel", "callback_gw_example"),
    "ins": ("basic_gw_example", "BasicGWModel", "ins_gw_example"),
    "toy": ("toy_cbc", "ToyCBCModel", "toy_cbc"),
    "full": ("full_gw_example", "FullGWModel", "full_gw_example"),
    "calibration": ("calibration_example", "CalibratedGWModel", "calibration_example"),
}


def configuration(name, package="jax"):
    """The script's model (the JAX script's, or with ``package="port"`` the
    port's module's) and sampler arguments, and its ``run`` arguments."""
    import importlib

    if name not in EXAMPLES:
        raise SystemExit(f"unknown example {name!r}")
    script, cls, port = EXAMPLES[name]
    arguments = importlib.import_module(f"nessai_tpu_torch.examples.gw.{port}")
    module = arguments if package == "port" else importlib.import_module(script)
    return getattr(module, cls)(), dict(arguments.SAMPLER_KWARGS), dict(getattr(arguments, "RUN_KWARGS", {}))


def _run_port(model, kwargs, run_kwargs, device, output):
    """The configuration through the port (``model`` is the port's)."""
    import torch

    from nessai_tpu_torch.flowsampler import FlowSampler

    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fs = FlowSampler(model, output=output, resume=False, plot=False, checkpointing=False, device=device, **kwargs)
    fs.run(plot=False, save=False, **run_kwargs)
    return fs, model


def main(argv):
    name = argv[0]
    port_device = argv[3] if argv[2:3] == ["--port"] else None
    model, kwargs, run_kwargs = configuration(name, "jax" if port_device is None else "port")
    if len(argv) > 1:
        kwargs["seed"] = int(argv[1])
    start = time.perf_counter()
    if port_device is not None:
        with tempfile.TemporaryDirectory() as output:
            fs, model = _run_port(model, kwargs, run_kwargs, port_device, output)
    else:
        import jax

        from nessai_tpu.flowsampler import FlowSampler

        with tempfile.TemporaryDirectory() as output, jax.default_device(jax.devices("cpu")[0]):
            fs = FlowSampler(model, output=output, resume=False, plot=False, checkpointing=False, **kwargs)
            fs.run(plot=False, save=False, **run_kwargs)
    result = dict(
        name=name,
        package="nessai_tpu_torch on " + port_device if port_device else "nessai_tpu",
        seed=kwargs["seed"],
        logZ=float(fs.logZ),
        sigma=float(fs.log_evidence_error),
        seconds=time.perf_counter() - start,
        likelihood_evaluations=int(model.likelihood_evaluations),
        iterations=int(fs.ns.iteration),
    )
    if run_kwargs:
        result["sampler_logZ"] = float(fs.initial_logZ)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
