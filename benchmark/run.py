"""One run of one benchmark cell of the port (theiasfm_tpu_torch).

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (imports, the scene from the seed,
the port's preparation, a warm-up at the cell's shapes, and on a
checkout's first run the nvcc build of the port's kernels) is timed to
the window's start. The window runs the cell's traffic for `--seconds`.
With `--trace 0` the last line of standard output holds the cell's
end-to-end metrics; with `--trace 1` the window runs under
torch.profiler and the line holds the cell's per-layer metrics, read by
benchmark/metrics/<name>.py, with the device's busy and window seconds
and a breakdown. Either way the answers are then judged against the
plain reference, and `correct` says whether every one held, with each
number compared beside its limit (the line's last key, and the last
lines of standard error).

Without a CUDA device, with fewer than the cell's chips, or with JAX or
the JAX package loaded once the window has closed, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "theiasfm_tpu")
CACHE = Path(__file__).resolve().parent.parent / ".bench_cache"


class Refused(RuntimeError):
    """The run cannot give a result (no card, a forbidden module)."""


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (theiasfm_tpu_torch is not theiasfm_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _caches():
    """Kernel and compiler caches at fixed paths inside the checkout,
    Python's bytecode among them: the first run of a checkout compiles
    the modules it imports (torch's lazily imported ones too), and later
    runs load them."""
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def log(msg):
    """A progress line on standard error, with seconds since start."""
    print(f"[{time.perf_counter() - T0:9.3f}s] {msg}", file=sys.stderr,
          flush=True)


def _check_card(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark measures the card "
                      "and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} CUDA devices, "
                      f"{torch.cuda.device_count()} present")


class Context:
    """What a per-layer metric's reader reads."""

    def __init__(self, trace, window, shapes, peaks, peak_bytes):
        self.trace = trace
        self.counts = window.counts
        self.iterations = window.iterations
        self.shapes = shapes
        self.peaks = peaks
        self.peak_bytes = peak_bytes


def run_cell(workload, seed, seconds, trace, device="cuda", solve=None,
             bench=None):
    """Set up, run and judge one cell; returns the result line's dict. A
    per-layer metric whose reader finds nothing is left out of it."""
    import torch
    from . import registry
    from . import trace as tracing
    bench = bench or registry.Benchmark()
    wl = bench.workload(workload)
    cfg = bench.config(wl["config"])
    traffic = bench.traffic(wl["traffic"])
    if device == "cuda":
        _check_card(int(wl["chips"]))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    system = registry.system(cfg["system"])
    log(f"{workload} seed {seed}: imports done")
    cell = system.Cell(cfg, traffic, seed, device, solve=solve, log=log)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T0
    log(f"set-up done: {setup_s:.3f} s")
    tr = None
    if trace:
        with tracing.profiled(cfg["range_prefix"]) as got:
            win = cell.window(seconds)
        tr = got[0]
        log(f"trace read in {tr.read_s:.3f} s: {len(tr.ops)} device "
            f"operations, {tr.unplaced} placed by their operator")
    else:
        win = cell.window(seconds)
    log(f"window: {len(win.answers)} solves, {win.iterations} LM "
        f"iterations in {win.wall_s:.3f} s; counts {win.counts}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise Refused("loaded after the window: " + ", ".join(found))
    shapes = cell.shapes()
    cell.release()

    ok_path, path_msg = cell.path_check(win)
    failed, worst = cell.judge(win)
    log(f"judged: {failed} of {len(win.answers)} solves failed")
    limits = cfg["limits"]
    log(f"readings: {worst}")
    compared = {k: {"value": worst[k], "limit": v} for k, v in limits.items()}
    compared["kernel_path"] = {"value": int(ok_path), "limit": 1,
                               "note": path_msg}
    correct = failed == 0 and ok_path
    if trace:
        ctx = Context(tr, win, shapes, json.loads(
            (bench.dir / "peaks.json").read_text()), peak)
        metrics = {}
        for m in bench.per_layer(workload):
            v = bench.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        iters = win.iterations
        metrics = {"lm_iter_ms": {"value": win.wall_s * 1e3 / iters,
                                  "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        wanted = {m["name"] for m in bench.end_to_end(workload)}
        metrics = {k: v for k, v in metrics.items() if k in wanted}
    result = {"correct": correct, "attempted": len(win.answers),
              "failed": failed if ok_path else len(win.answers),
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if on_card
                                  else "cpu"),
                         "count": int(wl["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {
            "device_ops": tr.top_ops(10),
            "idle_gaps": tr.idle_by_range(cfg["range_prefix"], 10)}
    result["readings"] = worst
    result["compared"] = compared
    return result


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _caches()
    try:
        result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print("benchmark: loaded: " + ", ".join(found), file=sys.stderr)
        return 2
    report(result)
    return 0


def report(result, out=None, err=None):
    """Each number compared beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for k, v in result["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=err)
    err.flush()
    print(json.dumps(_finite(result)), file=out, flush=True)


if __name__ == "__main__":
    sys.exit(main())
