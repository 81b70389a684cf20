"""The JAX package's verification and the port's on the putative matches
of chip_smoke.py's `frontend_verify` phase, on the CPU.

    JAX_PLATFORMS=cpu python tests/frontend_verify_reference.py \
        [--seeds 0 1 2] [--guided] [--out result.json]

The putative matches are the 28 pairs of the phase's 8 synthetic views
(640x480, focal 600), as the port makes them on the CPU (SIFT, then
FeatureMatcher with verification on, whose one verify_matches_batch
call is captured; the card's have the same counts per pair, their
keypoints agree to float32 rounding). For each seed and in float32 and
float64 (JAX's x64 mode), it runs

* JAX's verify_matches_batch from PRNGKey(seed);
* the port's on the CPU with the indices JAX drew (a second witness of
  how far float32 rounding alone splits the two packages);
* the RANSAC stage alone (estimate_twoview_info_batch) in both, on the
  same indices, to show which stage splits;

With --guided the verification grows the match set by guided
matching, as the phase's second run does; JAX then verifies 7 pairs at
a time, its key folded with the group's number. Each run
reports per pair the verified count and the rotation and position-
direction errors against the ground truth, the adjacent pairs within 1
and 3 degrees, and how many of the 28 pairs are. One JSON line per run;
the last line is a summary that chip_smoke.py's pose gates are set from
(PERF.md, the frontend_verify cell).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from theiasfm_tpu.sfm.pipeline import geometric_verification as jgv  # noqa
from theiasfm_tpu.sfm.pipeline import twoview as jtv  # noqa: E402
from theiasfm_tpu_torch.convert import features_db_from_arrays  # noqa
from theiasfm_tpu_torch.image import (SiftOptions, extract_sift,  # noqa
                                      render_synthetic_views)
from theiasfm_tpu_torch.matching import (FeatureMatcher,  # noqa: E402
                                         FeatureMatcherOptions)
from theiasfm_tpu_torch.sfm.pipeline import (  # noqa: E402
    geometric_verification as tgv)
from theiasfm_tpu_torch.sfm.pipeline import twoview as ttv  # noqa: E402
from torch_verification_cases import jax_batch_samples  # noqa: E402

ARGS = ("pix1", "pix2", "mask", "focal1", "focal2", "pp1", "pp2",
        "image_sizes")
GUIDED = ("kp1_all", "kp2_all", "desc1", "desc2", "fmask1", "fmask2")
GUIDED_PAIRS = 7


def scene():
    views, cams = render_synthetic_views(cs._texture(0), cs.N_VIEWS,
                                         (640, 480), focal=600.0)
    return views, cams


def cpu_chunk(views, guided):
    """The chunk's verify_matches_batch arguments (and the guided
    matching's features) as the port's matcher builds them on the
    CPU."""
    names = [f"view{i:03d}" for i in range(cs.N_VIEWS)]
    arrays = {}
    for n, v in zip(names, views):
        k, d, valid = extract_sift(v, SiftOptions(), device="cpu")
        arrays[n] = (k[valid], d[valid])
    priors = {n: dict(image_width=640, image_height=480, focal_length=600.0,
                      principal_point=(320.0, 240.0)) for n in names}
    got = {}
    verify = tgv.verify_matches_batch

    def capture(samples, *a, **k):
        got.update(zip(ARGS, a))
        got.update((n, k[n]) for n in GUIDED if n in k)
        return verify(samples, *a, **k)
    tgv.verify_matches_batch = capture
    try:
        fm = FeatureMatcher(FeatureMatcherOptions(guided_matching=guided),
                            features_db_from_arrays(arrays, priors),
                            device="cpu")
        fm.add_images(names)
        fm.match_images()
    finally:
        tgv.verify_matches_batch = verify
    return {k: np.asarray(v) for k, v in got.items()}


def pairs():
    return [(i, j) for i in range(cs.N_VIEWS)
            for j in range(i + 1, cs.N_VIEWS)]


def report(infos, cams, what):
    per_pair = {}
    for (i, j), info in zip(pairs(), infos):
        if info is None:
            per_pair[f"{i}-{j}"] = None
            continue
        r, d = cs._pose_errors(info, cams[i], cams[j])
        per_pair[f"{i}-{j}"] = [int(info.num_verified_matches), r, d]
    ok = [p for p, v in per_pair.items() if v and v[1] <= 1.0
          and v[2] <= 3.0]
    rec = dict(run=what, accepted=sum(v is not None
                                      for v in per_pair.values()),
               within_1deg_3deg=len(ok),
               adjacent_within=[p for p in ok if int(p.split("-")[1]) ==
                                int(p.split("-")[0]) + 1],
               pairs=per_pair)
    print(json.dumps(rec), flush=True)
    return rec


def differing(a, b):
    """Pairs two runs accept differently, or whose counts differ by more
    than 1% (or 2) or rotations by more than 0.05 degrees."""
    out = []
    for (i, j), x, y in zip(pairs(), a, b):
        if x is None or y is None:
            if (x is None) != (y is None):
                out.append(f"{i}-{j}")
            continue
        dn = abs(x.num_verified_matches - y.num_verified_matches)
        if dn > max(2, 0.01 * y.num_verified_matches) or \
                cs._rotation_error_deg(x.rotation_2, y.rotation_2) > 0.05:
            out.append(f"{i}-{j}")
    return out


def jax_ransac(key, args):
    """JAX's batched RANSAC stage (estimate_twoview_info_batch's jitted
    body) from the per-pair keys verify_matches_batch draws its
    essential samples with, as TwoViewInfo-like records."""
    import jax.numpy as jnp
    from theiasfm_tpu.math import rotation as jrot
    pix1, pix2, mask, f1, f2, pp1, pp2 = args[:7]
    keys = jnp.stack([jax.random.split(k)[0] for k in
                      jax.random.split(key, len(mask))])
    x1 = (pix1 - pp1[:, None]) / f1[:, None, None]
    x2 = (pix2 - pp2[:, None]) / f2[:, None, None]
    opts = jtv.TwoViewInfoOptions()
    _, R, _, _, n = jtv._jitted_twoview_batch(opts.num_hypotheses)(
        keys, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
        jnp.asarray(opts.max_sampson_error_pixels ** 2 / (f1 * f2)))
    aa = np.asarray(jrot.rotation_matrix_to_angle_axis(R))
    return [None if n[p] < opts.min_inliers else argparse.Namespace(
        num_verified_matches=int(n[p]), rotation_2=aa[p])
        for p in range(len(mask))]


def jax_verify(key, args, kw, opts):
    """JAX's verification from `key` and the indices it drew. Guided
    runs go GUIDED_PAIRS pairs at a time (the key folded with the
    group's number) to bound the band matrices' memory."""
    mask = args[2]
    if not kw:
        return (jgv.verify_matches_batch(key, *args, opts)[0],
                jax_batch_samples(key, mask, 256))
    infos, es, hs = [], [], []
    for c, s0 in enumerate(range(0, len(mask), GUIDED_PAIRS)):
        sl = slice(s0, s0 + GUIDED_PAIRS)
        k = jax.random.fold_in(key, c)
        infos += jgv.verify_matches_batch(
            k, *(x[sl] for x in args), opts,
            **{n: v[sl] for n, v in kw.items()})[0]
        s = jax_batch_samples(k, mask[sl], 256)
        es.append(s.essential)
        hs.append(s.homography)
    return infos, tgv.VerificationSamples(torch.cat(es), torch.cat(hs))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--guided", action="store_true",
                    help="verify with guided matching")
    ap.add_argument("--out", help="write the runs as a JSON list here")
    a = ap.parse_args()
    views, cams = scene()
    chunk = cpu_chunk(views, a.guided)
    args = [chunk[k] for k in ARGS]
    kw = {k: chunk[k] for k in GUIDED if k in chunk}
    mask = chunk["mask"]
    print(json.dumps(dict(putative=mask.sum(1).tolist())), flush=True)
    topts = tgv.GeometricVerificationOptions(guided_matching=a.guided)
    jopts = jgv.GeometricVerificationOptions(guided_matching=a.guided)
    runs, summary = [], dict(jax={}, port_jax_indices={}, split={})
    for x64, dtype in ((False, torch.float32), (True, torch.float64)):
        jax.config.update("jax_enable_x64", x64)
        name = "float64" if x64 else "float32"
        for seed in a.seeds:
            key = jax.random.PRNGKey(seed)
            ji, s = jax_verify(key, args, kw, jopts)
            runs.append(report(ji, cams, f"jax {name} seed {seed}"))
            ti, _ = tgv.verify_matches_batch(s, *args, topts, **kw,
                                             dtype=dtype, device="cpu")
            runs.append(report(ti, cams, f"port cpu {name} jax indices "
                               f"seed {seed}"))
            summary["jax"].setdefault(name, []).append(
                runs[-2]["within_1deg_3deg"])
            summary["port_jax_indices"].setdefault(name, []).append(
                runs[-1]["within_1deg_3deg"])
            split = dict(seed=seed, verification=differing(ti, ji))
            if not kw:
                # the RANSAC stage alone, from the keys the
                # verification draws its essential samples with
                split["ransac"] = differing(ttv.estimate_twoview_info_batch(
                    s.essential, *args[:7], ttv.TwoViewInfoOptions(),
                    dtype=dtype, device="cpu")[0], jax_ransac(key, args))
            summary["split"].setdefault(name, []).append(split)
            print(json.dumps(dict(dtype=name,
                                  **summary["split"][name][-1])),
                  flush=True)
    adjacent = [f"{i}-{i + 1}" for i in range(cs.N_VIEWS - 1)]
    summary["adjacent_jax_passes_always"] = [
        p for p in adjacent if all(p in r["adjacent_within"]
                                   for r in runs if r["run"]
                                   .startswith("jax"))]
    print(json.dumps(dict(summary=summary)), flush=True)
    if a.out:
        Path(a.out).write_text(json.dumps(runs + [summary], indent=1))


if __name__ == "__main__":
    main()
