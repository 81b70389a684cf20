"""Holds the card's float32 reprojection errors (the batched call that
compute_reconstruction_statistics prints from) to the CPU's, observation
by observation, on the 24-view model that chip_smoke.py's `io_cli` phase
builds, and both to a float64 CPU run of the same call. Needs a CUDA
device; not a test.

    python tests/reproj_card_probe.py [--models 1]

Each model is built anew (the card's back end sums with atomics, so the
models differ a little from run to run). Prints one JSON line per model:
the largest and quantile differences in px, the median and mean of each
run, and the largest difference to float64 of each device.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from theiasfm_tpu_torch import io as tio  # noqa: E402
from theiasfm_tpu_torch.sfm.pipeline.filters import (  # noqa: E402
    _reprojection_errors)


def compare(path):
    recon = tio.read_reconstruction(str(path))
    e = {name: _reprojection_errors(recon, dtype=dt, device=dev)[1]
         for name, dt, dev in (("cuda", torch.float32, "cuda"),
                               ("cpu", torch.float32, "cpu"),
                               ("cpu64", torch.float64, "cpu"))}
    ok = np.isfinite(e["cuda"]) & np.isfinite(e["cpu"])
    d = np.abs(e["cuda"] - e["cpu"])[ok]
    return dict(
        observations=int(ok.sum()),
        same_finite=bool((np.isfinite(e["cuda"]) ==
                          np.isfinite(e["cpu"])).all()),
        max_abs_px=float(d.max()),
        quantiles_px={q: float(np.quantile(d, q))
                      for q in (0.5, 0.9, 0.99, 0.999)},
        share_equal=float((d == 0).mean()),
        median={k: float(np.median(v[ok])) for k, v in e.items()},
        mean={k: float(np.mean(v[ok])) for k, v in e.items()},
        max_abs_vs_f64_px={k: float(np.abs(e[k] - e["cpu64"])[ok].max())
                           for k in ("cuda", "cpu")})


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--models", type=int, default=1)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("reproj_card_probe: no CUDA device", file=sys.stderr)
        return 1
    cs.phase_env()
    _, _, scene24 = cs.phase_incremental_24()
    for m in range(args.models):
        keep = {}
        cs.phase_io_cli(scene24, keep=keep)
        try:
            res = compare(keep["dir"] / "out" / "model-0.npz")
        finally:
            shutil.rmtree(keep["dir"], ignore_errors=True)
        print(json.dumps(dict(model=m, **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
