"""Runs the port's calibrate_camera_intrinsics CLI several times in one
process on the card, on the views chip_smoke.py's `apps_f2` phase
calibrates (PNGs of the `incremental` renderings, focal 600), and says
at which stage the runs part: each round's SIFT features, putative and
verified matches (the features and matches database), and the model.
Needs a CUDA device; not a test.

    python tests/calibrate_repeat_probe.py [--runs 3] [--views 8]
        [--deterministic]

--views is the number of renderings (8 as the `incremental` phase, 24
as `incremental_24`).

--deterministic runs every CLI call under
torch.use_deterministic_algorithms(True) (set CUBLAS_WORKSPACE_CONFIG=
:4096:8 in the environment as well, as torch asks). Prints one JSON
line per run (the CLI's printout) and one per comparison with the first
run (the stages that differ, per round).
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from theiasfm_tpu_torch.image import render_synthetic_views  # noqa: E402

cal = importlib.import_module(
    "theiasfm_tpu_torch.apps.calibrate_camera_intrinsics")


def _digest(a):
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def _snapshot(builder, models):
    """Every stage of one round as comparable values."""
    s = {}
    for n in sorted(builder.db.image_names_of_features()):
        f = builder.db.get_features(n)
        s[f"features {n}"] = (_digest(f.keypoints), _digest(f.descriptors))
    for a, b in sorted(builder.db.image_pairs_of_matches()):
        m = builder.db.get_match(a, b)
        t = m.twoview_info
        s[f"match {a} {b}"] = (_digest(m.correspondences),
                               int(t.num_verified_matches),
                               _digest(np.r_[t.rotation_2, t.position_2]))
    best = max(models, key=lambda m: len(m.estimated_views()))
    s["model"] = (len(best.estimated_views()),
                  len(best.estimated_tracks()),
                  _digest(best.views[best.estimated_views()[0]]
                          .camera.intrinsics))
    return s


def run(images, deterministic):
    """The CLI's printout and one snapshot per round."""
    snaps, Real = [], cal.ReconstructionBuilder

    class Kept(Real):
        def build_reconstruction(self):
            models = super().build_reconstruction()
            snaps.append(_snapshot(self, models))
            return models
    cal.ReconstructionBuilder = Kept
    torch.use_deterministic_algorithms(deterministic)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cal.main(["--images", str(images / "*.png"),
                           "--device", "cuda"])
    finally:
        cal.ReconstructionBuilder = Real
        torch.use_deterministic_algorithms(False)
    return rc, buf.getvalue().splitlines(), snaps


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--views", type=int, default=cs.N_VIEWS)
    p.add_argument("--deterministic", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate_repeat_probe: no CUDA device", file=sys.stderr)
        return 1
    cs.phase_env()
    views, _ = render_synthetic_views(cs._texture(0), args.views,
                                      (640, 480), focal=600.0)
    images = Path(tempfile.mkdtemp())
    for i, v in enumerate(views):
        cs.write_png(images / f"view{i:03d}.png", v)
    first = None
    for r in range(args.runs):
        rc, out, snaps = run(images, args.deterministic)
        print(json.dumps(dict(run=r, rc=rc, views=args.views,
                              deterministic=args.deterministic,
                              printed=out)), flush=True)
        if first is None:
            first = snaps
            continue
        for k, (a, b) in enumerate(zip(first, snaps)):
            differ = sorted(key for key in a if a[key] != b.get(key))
            print(json.dumps(dict(compare=f"run 0 vs run {r}", round=k,
                                  stages_differing=len(differ),
                                  first=differ[:6])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
