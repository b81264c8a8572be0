"""The readings that the limits of ``correct`` are set from, on the card::

    python3 portbench/control.py --workload gw_basic.ns --seeds 1-12 --seconds 30

For each seed, in one process, runs the cell as a measured run does and
prints one JSON line: the program's numbers against the reference
(``program``) and, for the same inputs, the reference one precision
below the configuration's in the program's place (``control``). The lower
reading of a number is the largest over the program's seeds, the upper
the smallest over the control's. With ``--fault <name>`` (one of
:data:`portbench.faults.FAULTS`) the program runs with that fault
planted, and its numbers are the fault's readings.
"""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(HERE, ".cache", "nv"))


def seeds_of(text):
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def readings(workload, seed, seconds, device="cuda", **kwargs):
    """``(result, control)`` of one seed: the run's result, with each
    judged number beside its limit under ``checks`` and every reading of
    the program under ``program``, and the control's numbers."""
    from portbench import check, harness

    keep = {}
    result = harness.run_cell(workload, seed, seconds, False, device=device, keep=keep, **kwargs)
    spec = kwargs.get("spec") or harness.load_spec()
    cell = next(c for c in spec["workloads"] if c["name"] == workload)
    config = harness.load_config(cell["config"])
    reference = harness.load_reference(cell["config"])
    result["program"] = check.program_readings(keep["snapshot"], reference, device, config["training"])
    control = check.control_readings(keep["snapshot"], reference, device, config["training"])
    return result, control


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--fault", default=None)
    args = parser.parse_args(argv)
    from portbench.faults import FAULTS

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(seeds_of(args.seeds)):
        t = time.perf_counter()
        # the kernels and shapes are warm after the first seed's run
        with FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            result, control = readings(args.workload, seed, args.seconds, warmup=(i == 0))
        program = result["program"]
        line = dict(
            workload=args.workload,
            seed=seed,
            fault=args.fault,
            correct=result["correct"],
            iterations=result["attempted"],
            metrics={k: v["value"] for k, v in result["metrics"].items()},
            program=program,
            control=control,
            seconds=time.perf_counter() - t,
        )
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
