"""The readings that the limits of `correct` are set from. Not part of a
benchmark run.

    python3 -m benchmark.tools.readings --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--control bf16 | --fault <kind>]

For each seed, one run of the cell in this process as benchmark.run
makes it (set-up, a window of `--seconds`, the judge against the float64
reference) and one JSON line: every number the judge reads (the worst
over the window's solves), `correct` against the configuration's
current limits, the window's solves and LM iterations. With `--control
bf16` the reference computed in bfloat16 takes the port's place (the
lower-precision control); with `--fault` the port runs with a fault
planted under it (systems/bundle_adjust.py FAULTS). Needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import registry, run


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", choices=("bf16",))
    p.add_argument("--fault")
    a = p.parse_args(argv)
    run._caches()
    bench = registry.Benchmark()
    system = registry.system(bench.config(
        bench.workload(a.workload)["config"])["system"])
    solve = None
    if a.control:
        solve = system.reference_solve(torch.bfloat16)
    elif a.fault:
        solve = system.FAULTS[a.fault]
    for seed in a.seeds:
        res = run.run_cell(a.workload, seed, a.seconds, False, solve=solve,
                           bench=bench)
        print(json.dumps({
            "workload": a.workload, "seed": seed,
            "side": a.control or a.fault or "port",
            "correct": res["correct"], "solves": res["attempted"],
            "failed": res["failed"], "readings": res["readings"],
            "lm_iter_ms": res["metrics"]["lm_iter_ms"]["value"],
            "kind": res["device"]["kind"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
