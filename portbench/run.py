"""Run one cell of the benchmark of ``nessai_tpu_torch``::

    python3 portbench/run.py --workload gw_basic.ns --seed 7 --seconds 30 --trace 0

Prints the metrics of the cell (its end-to-end metrics, or with ``--trace
1`` its per-layer metrics) as the last line of standard output, one JSON
object, and each number that decides ``correct`` beside its limit as the
last lines of standard error. Exits with another code than 0, and prints
no result, without a CUDA card, or where a module of JAX or of the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
# the CUDA driver's cache of compiled code, inside the checkout
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(HERE, ".cache", "nv"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness

    spec = harness.load_spec()
    cell = next((c for c in spec["workloads"] if c["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(
            f"{args.workload} needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), spec=spec, t_start=T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of JAX or of the JAX package were loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
