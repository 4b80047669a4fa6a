"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout of the repository. The last line of standard
output is one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device, with
--trace 1 the breakdown, and last the numbers the check compared, each with
its limit; the same numbers are the last lines of standard error.

Exits without a result (code 2) when torch sees fewer CUDA cards than the
cell asks for, and (code 3) when jax, jaxlib, flax or the JAX package
nlsolvers_tpu is loaded once the window has closed. A checkout without the
program fails on its import.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nlsolvers_tpu")


def forbidden_modules(modules=None):
    """The forbidden top-level names among the loaded modules, each name
    compared whole (nlsolvers_tpu_torch is not nlsolvers_tpu)."""
    names = {n.split(".")[0] for n in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    from portbench import bench, cells

    man = cells.manifest()
    entry = [w for w in man["workloads"] if w["name"] == args.workload]
    if not entry:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 1
    chips = entry[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    rec, correct, numbers, attempted, failed = bench.run_cell(
        args.workload, args.seed, args.seconds, args.trace, T_START,
        log=log)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the benchmark process: {bad}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "power_limit_w": bench.power_limit()}
    line = bench.result_line(
        rec, cells.metric_entries(man, args.workload, args.trace), correct,
        numbers, attempted, failed, device)
    for name, (value, limit) in numbers.items():
        log(f"check {name} {value} limit {limit}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
