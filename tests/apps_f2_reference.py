"""The JAX package's CLIs (apps/) and the port's on the inputs of
chip_smoke.py's `apps_f2` phase, on the CPU, where the phase's gates
come from JAX's readings.

    JAX_PLATFORMS=cpu python tests/apps_f2_reference.py \
        [--part calibrate|two_view] [--seeds 0 1 2 3 4] [--only jax|port] \
        [--out r.json]

--part calibrate (the default): calibrate_camera_intrinsics on the
`incremental` phase's 8 views (640x480 renderings of
chip_smoke._texture(0) at focal 600), written as 8-bit PNGs by
chip_smoke.write_png, as the phase writes them. Each CLI runs as a user
runs it (its defaults: INCREMENTAL, 2 iterations, no calibration
prior), with the seed of the matcher's and the incremental pipeline's
draws set to `seed` through ReconstructionBuilderOptions (the CLI's own
options are seed 0). Some 2 min a run for JAX on 6 CPU threads.

--part two_view: compute_two_view_geometry on views 0 and 1 of the
`incremental_24` phase's 24 views (the same renderings at 24 views), at
focal 600, its RANSAC drawn from jax.random.PRNGKey(seed) (JAX) or a
CPU torch.Generator seeded `seed` (the port; the CLI's own draw is seed
0), each run's pose error against the true cameras.

JAX runs in float32, as on a TPU; the port in float32 on the CPU. Each
run prints one JSON line; the last line is the summary chip_smoke.py's
gates are set from (PERF.md, apps_f2): for calibrate JAX's fewest views
calibrated in the last iteration, and the range of the port's last
focal lengths over seeds 0-9, which holds JAX's wherever JAX's focal
converges (chip_smoke.F2_CALIB_GATE); for two_view JAX's largest
rotation and position errors.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import tempfile
import time
import types
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import chip_smoke as cs  # noqa: E402
from theiasfm_tpu.matching import FeatureMatcherOptions as JFMOptions  # noqa
from theiasfm_tpu.sfm import reconstruction_builder as jrb  # noqa: E402
from theiasfm_tpu_torch.apps import calibrate_camera_intrinsics as tcal  # noqa
from theiasfm_tpu_torch.image import render_synthetic_views  # noqa: E402
from theiasfm_tpu_torch.matching import FeatureMatcherOptions  # noqa: E402
from torch_apps_cases import jax_cli  # noqa: E402

LINE = re.compile(r"iteration (\d+): (\d+) views calibrated; focal=([\d.]+) "
                  r"aspect=([\d.]+) pp=\(([-\d.]+),([-\d.]+)\)")


def seeded(options_cls, fm_cls, seed):
    """ReconstructionBuilderOptions with the draws of the matcher and of
    the incremental pipeline seeded `seed`."""
    def make(**kw):
        o = options_cls(**kw)
        return dataclasses.replace(
            o, matching=dataclasses.replace(o.matching, seed=seed),
            incremental_options=dataclasses.replace(
                o.incremental_options, seed=seed))
    assert fm_cls().seed == 0
    return make


def run(package, seed, images):
    out = io.StringIO()
    argv = ["--images", str(images / "*.png")]
    t0 = time.perf_counter()
    if package == "jax":
        mod = jax_cli("calibrate_camera_intrinsics")
        real = jrb.ReconstructionBuilderOptions
        jrb.ReconstructionBuilderOptions = seeded(real, JFMOptions, seed)
        sys.argv = ["calibrate_camera_intrinsics.py", *argv]
        try:
            with contextlib.redirect_stdout(out):
                rc = mod.main()
        finally:
            jrb.ReconstructionBuilderOptions = real
    else:
        real = tcal.ReconstructionBuilderOptions
        tcal.ReconstructionBuilderOptions = seeded(real,
                                                   FeatureMatcherOptions,
                                                   seed)
        try:
            with contextlib.redirect_stdout(out):
                rc = tcal.main(argv + ["--device", "cpu"])
        finally:
            tcal.ReconstructionBuilderOptions = real
    its = [dict(zip(("iteration", "views", "focal", "aspect", "ppx", "ppy"),
                    (int(m[0]), int(m[1]), *map(float, m[2:]))))
           for m in LINE.findall(out.getvalue())]
    return dict(package=package, seed=seed, rc=rc, iterations=its,
                seconds=time.perf_counter() - t0)


def run_two_view(package, seed, images, cams):
    import jax
    import torch
    from theiasfm_tpu_torch.apps import compute_two_view_geometry as ttv
    from theiasfm_tpu_torch.solvers.ransac import random_samples
    from theiasfm_tpu_torch.utils import next_bucket
    out = io.StringIO()
    argv = ["--image1", str(images / "view000.png"), "--image2",
            str(images / "view001.png"), "--focal1", "600", "--focal2",
            "600"]
    t0 = time.perf_counter()
    if package == "jax":
        mod = jax_cli("compute_two_view_geometry")
        real = jax.random.PRNGKey
        jax.random.PRNGKey = lambda _: real(seed)
        sys.argv = ["compute_two_view_geometry.py", *argv]
        try:
            with contextlib.redirect_stdout(out):
                rc = mod.main()
        finally:
            jax.random.PRNGKey = real
    else:
        def draw(num_matches, num_hypotheses, device):
            n = next_bucket(num_matches, 64)
            return random_samples(torch.Generator().manual_seed(seed), n, 5,
                                  num_hypotheses,
                                  torch.arange(n) < num_matches).to(device)
        real = ttv.ransac_samples
        ttv.ransac_samples = draw
        try:
            with contextlib.redirect_stdout(out):
                rc = ttv.main(argv + ["--device", "cpu"])
        finally:
            ttv.ransac_samples = real
    text = out.getvalue()
    errs = cs._pose_errors(types.SimpleNamespace(
        rotation_2=cs._vector(text, "relative rotation (angle-axis):"),
        position_2=cs._vector(text, "relative position (unit):")),
        cams[0], cams[1])
    return dict(package=package, seed=seed, rc=rc, printed=text.splitlines(),
                rotation_err_deg=errs[0], position_err_deg=errs[1],
                seconds=time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--part", choices=["calibrate", "two_view"],
                    default="calibrate")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--only", choices=["jax", "port"])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    n_views = 8 if args.part == "calibrate" else 24
    views, cams = render_synthetic_views(cs._texture(0), n_views,
                                         (640, 480), focal=600.0)
    images = Path(tempfile.mkdtemp())
    for i, v in enumerate(views[:8 if args.part == "calibrate" else 2]):
        cs.write_png(images / f"view{i:03d}.png", v)
    recs = []
    for seed in args.seeds:
        for package in ("jax", "port"):
            if args.only and package != args.only:
                continue
            rec = (run(package, seed, images) if args.part == "calibrate"
                   else run_two_view(package, seed, images, cams))
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    summary = {}
    for package in ("jax", "port"):
        rs = [r for r in recs if r["package"] == package]
        if not rs:
            continue
        if args.part == "two_view":
            summary[package] = dict(
                seeds=[r["seed"] for r in rs],
                rotation_err_max_deg=max(r["rotation_err_deg"] for r in rs),
                position_err_max_deg=max(r["position_err_deg"] for r in rs))
            continue
        last = [r["iterations"][-1] for r in rs if r["iterations"]]
        summary[package] = dict(
            seeds=[r["seed"] for r in rs], failed=sum(r["rc"] != 0
                                                      for r in rs),
            views_min=min((x["views"] for x in last), default=0),
            focal_min=min((x["focal"] for x in last), default=None),
            focal_max=max((x["focal"] for x in last), default=None))
    print(json.dumps({"summary": summary}))
    if args.out:
        Path(args.out).write_text(json.dumps(dict(runs=recs,
                                                   summary=summary)))


if __name__ == "__main__":
    main()
