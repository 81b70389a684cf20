"""The JAX package's readings on the inputs of chip_smoke.py's solver
phases (`uncalibrated`, `transforms`, `radial_homography`, `evsac`,
`minimal_solvers`), on the CPU, and the port's on the same inputs with
the indices JAX drew.

    JAX_PLATFORMS=cpu python tests/solvers_reference.py \
        [--parts minimal uncalibrated transforms radial evsac] \
        [--seeds 0 1 2] [--out result.json]

Not a test. The synthetic inputs come from
theiasfm_tpu_torch/solver_problems.py with the phases' seeds; the
matched pairs are the phases' 8 synthetic views (640x480, focal 600)
through the port's SIFT and chip_smoke.putative_pairs on the CPU (the
card's features agree to float32 rounding). For each seed, in float32
as on the card, it runs JAX's estimator from PRNGKey(seed) (folded with
the problem's number where JAX runs one problem per call) and reports
the phase's quality reading (pairs or problems within the phase's
tolerances); then the port on the CPU in float32 with JAX's indices,
and how many problems the two agree on (inlier counts within max(2,
1%), the compared values within the phase's relative bound). The last
line is a summary: JAX's worst reading and the fewest agreements over
the seeds, which chip_smoke.GATES is set from, and the port's float32
CPU share of every minimal solver on the 4,096 problems
(chip_smoke.MINIMAL_CPU_SHARE) beside JAX's float32 share on the first
512 of them.
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
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from theiasfm_tpu.sfm.estimators import transforms as jtr  # noqa: E402
from theiasfm_tpu.sfm.estimators import twoview_estimators as jte  # noqa
from theiasfm_tpu.sfm.estimators import uncalibrated as jun  # noqa: E402
from theiasfm_tpu.solvers import RansacOptions as JOpts  # noqa: E402
from theiasfm_tpu.solvers.evsac import (  # noqa: E402
    evsac_probabilities as j_evsac_probabilities, weighted_samples as jws)
from theiasfm_tpu.solvers.ransac import random_samples as jrs  # noqa
from theiasfm_tpu_torch import solver_problems as sp  # noqa: E402
from theiasfm_tpu_torch.image import (SiftOptions, extract_sift,  # noqa
                                      render_synthetic_views)
from theiasfm_tpu_torch.sfm.estimators import uncalibrated as tun  # noqa

import importlib  # noqa: E402

jransac = importlib.import_module("theiasfm_tpu.solvers.ransac")
jpose = {n: importlib.import_module(f"theiasfm_tpu.sfm.pose.{n}") for n in (
    "focal_from_fundamental", "seven_point", "known_rotation", "dlt_pnp",
    "epnp", "p4pf", "pnp_focal_radial", "upnp", "gdls",
    "radial_homography", "partial_rotation")}

F32 = torch.float32


def emit(**kw):
    print(json.dumps(kw), flush=True)
    return kw


def jopts(o):
    return JOpts(error_thresh=o.error_thresh, num_hypotheses=o.num_hypotheses,
                 sampler=o.sampler)


def j32(x):
    return jnp.asarray(np.asarray(x), jnp.float32)


def t32(x):
    return torch.as_tensor(np.asarray(x), dtype=F32)


# ------------------------------------------------------------ minimal

def _jax_minimal(name, x):
    """JAX's solver on float32 inputs, outputs as the port's tuple."""
    v = jax.vmap
    m = jpose
    a = {k: j32(val) for k, val in x.items()}
    if name == "focal_from_fundamental":
        z = jnp.zeros(a["F"].shape[:-2] + (2,), jnp.float32)
        out = v(m[name].focal_lengths_from_fundamental)(a["F"], z, z)
    elif name == "seven_point":
        out = v(m[name].seven_point_fundamental)(a["x1"], a["x2"])
    elif name == "known_rotation":
        out = v(m[name].relative_pose_from_two_points_with_known_rotation)(
            a["x1"], a["x2"], a["R"])
    elif name == "dlt_pnp":
        out = v(m[name].six_point_pnp)(a["world"], a["image"])
    elif name == "epnp":
        out = v(m[name].epnp)(a["world"], a["image"])
    elif name == "p4pf":
        out = v(m[name].p4pf)(a["world"], a["image"])
    elif name == "pnp_focal_radial":
        out = v(m[name].four_point_focal_length_radial_distortion)(
            a["world"], a["image"])
    elif name == "upnp":
        out = v(m[name].upnp)(a["origins"], a["dirs"], a["world"])
    elif name == "gdls":
        out = v(m[name].gdls_similarity_transform)(a["origin"], a["dir"],
                                                   a["point"])
    elif name == "radial_homography":
        mo, valid = v(m[name].six_point_radial_distortion_homography)(
            a["x1"], a["x2"])
        out = (jnp.concatenate([mo["H"].reshape(valid.shape + (9,)),
                                mo["l1"][..., None], mo["l2"][..., None]],
                               -1), valid)
    else:
        out = v(m[name].three_point_relative_pose_partial_rotation)(
            a["axis"], a["rays1"], a["rays2"])
    return tuple(torch.as_tensor(np.asarray(o, np.float64)
                                 if np.asarray(o).dtype != bool
                                 else np.asarray(o)) for o in out)


def part_minimal(seeds):
    res = {}
    for name in sp.MINIMAL_SOLVERS:
        x, truth = sp.minimal_problems(name, 0, cs.MINIMAL_PROBLEMS)
        out = sp.run_minimal(name, x, F32, "cpu",
                             chunk=cs.MINIMAL_CHUNK.get(name, 1024))
        port = float(np.mean(sp.minimal_hits(name, out, truth)))
        xs = {k: v[:512] for k, v in x.items()}
        ts = {k: v[:512] for k, v in truth.items()}
        jshare = float(np.mean(sp.minimal_hits(name, _jax_minimal(name, xs),
                                               ts)))
        res[name] = emit(part="minimal", solver=name, port_cpu_f32=port,
                         jax_f32_first512=jshare)
    return res


# ------------------------------------------------------- matched pairs

def pairs_scene():
    views, cams = render_synthetic_views(cs._texture(0), cs.N_VIEWS,
                                         (640, 480), focal=600.0)
    names = [f"view{i:03d}" for i in range(cs.N_VIEWS)]
    arrays = {}
    for n, v in zip(names, views):
        k, d, valid = extract_sift(v, SiftOptions(), device="cpu")
        arrays[n] = (k[valid], d[valid])
    P = cs.putative_pairs(arrays, names, "cpu")
    return P, cams


def _pair_arrays(P, p):
    n = int(P["mask"][p].sum())
    return P["x1"][p, :n].numpy(), P["x2"][p, :n].numpy(), n


def part_uncalibrated(seeds):
    P, cams = pairs_scene()
    aa_true, _ = cs.pair_truth(cams, P["pairs"])
    o = cs.UNCAL_REL_OPTS
    runs = []
    for seed in seeds:
        jerr, agree = [], 0
        for p in range(len(P["pairs"])):
            x1, x2, n = _pair_arrays(P, p)
            key = jax.random.fold_in(jax.random.PRNGKey(seed), p)
            ref = jun.estimate_uncalibrated_relative_pose(
                key, j32(x1), j32(x2), jopts(o))
            b = cs.next_bucket(n, 64)
            idx = torch.as_tensor(np.array(jrs(key, b, 8, o.num_hypotheses,
                                               jnp.arange(b) < n)))
            out = cs.estimate_uncalibrated_relative_pose(idx, t32(x1),
                                                         t32(x2), o)
            f = [float(ref["focal_length_1"]), float(ref["focal_length_2"])]
            ferr = max(abs(v - cs.FOCAL) for v in f) / cs.FOCAL
            rerr = float(cs._rel_rotation_err_deg(
                torch.as_tensor(np.asarray(ref["R"]))[None],
                aa_true[p:p + 1])[0])
            jerr.append((ferr, rerr))
            # inlier counts only, as chip_smoke's uncalibrated phase
            agree += cs._agree(([int(ref["num_inliers"])], [f]),
                               ([int(out["num_inliers"])], [f]), np.inf)
        within = sum(f <= cs.UNCAL_FOCAL_TOL and r <= cs.UNCAL_ROT_TOL_DEG
                     for f, r in jerr)
        runs.append(emit(part="uncalibrated_relative", seed=seed,
                         jax_pairs_within=within, port_jax_agree=agree,
                         jax_focal_err=[e[0] for e in jerr],
                         jax_rotation_err_deg=[e[1] for e in jerr]))

    B, N = cs.UNCAL_ABS
    prob = sp.absolute_pose(np.random.default_rng(0), B, N,
                            focal=(400, 1600), noise_px=1.0, outliers=0.3)
    ao = cs.UNCAL_ABS_OPTS
    specs = {"p4pf": (4, jun.p4pf_spec(), tun.p4pf_spec()),
             "dlt": (6, jun.uncalibrated_absolute_pose_spec(),
                     tun.uncalibrated_absolute_pose_spec())}
    for seed in seeds:
        rec = {}
        for name, (s, jspec, spec) in specs.items():
            keys = jax.random.split(jax.random.PRNGKey(seed), B)
            run = jax.jit(jax.vmap(lambda k, w, i: jransac.ransac(
                k, jspec, {"world": w, "image": i}, jopts(ao))))
            jm, js = run(keys, j32(prob["world"]), j32(prob["image"]))
            jm = np.asarray(jm, np.float64)
            fe, re_ = cs.abs_errors(torch.as_tensor(jm[:, :6]),
                                    torch.as_tensor(jm[:, 6]), prob)
            share = float(np.mean((fe <= cs.ABS_FOCAL_TOL) &
                                  (re_ <= cs.ABS_ROT_TOL_DEG)))
            idx = torch.as_tensor(np.stack([np.array(jrs(
                keys[b], N, s, ao.num_hypotheses, None)) for b in range(8)]))
            d = {"world": t32(prob["world"][:8]),
                 "image": t32(prob["image"][:8])}
            tm, ts = cs.ransac_batch(idx, spec, d, ao)
            agree = cs._agree((np.asarray(js.num_inliers[:8]), jm[:8, 6]),
                              (ts.num_inliers, tm[:, 6]), 1e-3)
            rec[name] = dict(jax_share_within=share, port_jax_agree_of_8=agree)
        runs.append(emit(part="uncalibrated_absolute", seed=seed, **rec))
    return runs


# -------------------------------------------------------- transforms

def part_transforms(seeds):
    city = cs._city(*cs.CITY)
    origins, dirs, mask, pts = cs.city_rays(city)
    to = cs.TRI_OPTS
    L = mask.shape[1]
    spec = jtr.triangulation_spec()
    run = jax.jit(jax.vmap(lambda k, o, d, m: jransac.ransac(
        k, spec, {"origins": o, "directions": d}, jopts(to), data_mask=m)))
    runs = []
    for seed in seeds:
        keys = jax.random.split(jax.random.PRNGKey(seed), len(mask))
        X, summ = run(keys, j32(origins), j32(dirs), jnp.asarray(mask))
        err = cs.nearest_point_err(np.asarray(X), pts, "cpu")
        share = float(np.mean(err <= cs.TRI_POINT_TOL))
        idx = cs.exhaustive_pair_samples(L, to.num_hypotheses, "cpu").expand(
            len(mask), -1, -1)
        out = cs.estimate_triangulation(idx, t32(origins), t32(dirs), to,
                                        torch.as_tensor(mask))
        agree = cs._agree((np.asarray(summ.num_inliers),
                           np.asarray(X, np.float64)),
                          (out["num_inliers"], out["point"]), 1e-4) / len(mask)
        po = cs.PLANE_OPTS
        pkey = jax.random.PRNGKey(seed)
        plane = jtr.estimate_dominant_plane_from_points(pkey, j32(pts),
                                                        jopts(po))
        b = cs.next_bucket(len(pts), 16)
        tplane = cs.estimate_dominant_plane_from_points(
            torch.as_tensor(np.array(jrs(pkey, b, 3, po.num_hypotheses,
                                         jnp.arange(b) < len(pts)))),
            t32(pts), po)
        rec = dict(tri_jax_share_within=share, tri_port_jax_agree=agree,
                   plane_jax_inliers=int(plane["num_inliers"]),
                   plane_port_jax_inliers_diff=abs(
                       int(plane["num_inliers"]) -
                       int(tplane["num_inliers"])))
        for name, with_scale in (("rigid", False), ("similarity", True)):
            B, N = cs.RIGID
            prob = sp.rigid_pairs(np.random.default_rng(2 + with_scale), B,
                                  N, with_scale, noise=0.01, outliers=0.3)
            rspec = jtr.rigid_transform_spec(with_scale)
            rrun = jax.jit(jax.vmap(lambda k, s_, d_: jransac.ransac(
                k, rspec, {"src": s_, "dst": d_}, jopts(cs.RIGID_OPTS))))
            rkeys = jax.random.split(jax.random.PRNGKey(seed), B)
            m, summ = rrun(rkeys, j32(prob["src"]), j32(prob["dst"]))
            m = np.asarray(m, np.float64)
            e = cs.transform_errors(dict(
                R=torch.as_tensor(m[:, :9].reshape(B, 3, 3)),
                t=torch.as_tensor(m[:, 9:12]),
                scale=torch.as_tensor(m[:, 12])), prob)
            rec[f"{name}_jax_share_within"] = float(np.mean(e <= cs.RIGID_TOL))
            idx = torch.as_tensor(np.stack([np.array(jrs(
                rkeys[b], N, 3, cs.RIGID_OPTS.num_hypotheses, None))
                for b in range(8)]))
            out = cs.estimate_rigid_transform(
                idx, t32(prob["src"][:8]), t32(prob["dst"][:8]),
                cs.RIGID_OPTS, with_scale=with_scale)
            rec[f"{name}_port_jax_agree_of_8"] = cs._agree(
                (np.asarray(summ.num_inliers[:8]), m[:8, :9]),
                (out["num_inliers"], out["R"]), 1e-4)
        B, N = cs.SIM
        prob = sp.generalized_similarity(np.random.default_rng(4), B, N,
                                         noise=1e-3, outliers=0.3)
        sspec = jtr.similarity_transform_2d_3d_spec()
        srun = jax.jit(jax.vmap(lambda k, o_, d_, p_: jransac.ransac(
            k, sspec, {"origin": o_, "dir": d_, "point": p_},
            jopts(cs.SIM_OPTS))))
        skeys = jax.random.split(jax.random.PRNGKey(seed), B)
        m, summ = srun(skeys, j32(prob["origin"]), j32(prob["dir"]),
                       j32(prob["point"]))
        m = np.asarray(m, np.float64)
        e = cs.transform_errors(dict(
            R=torch.as_tensor(m[:, :9].reshape(B, 3, 3)),
            t=torch.as_tensor(m[:, 9:12]), scale=torch.as_tensor(m[:, 12])),
            prob)
        rec["sim2d3d_jax_share_within"] = float(np.mean(e <= cs.SIM_TOL))
        idx = torch.as_tensor(np.stack([np.array(jrs(
            skeys[b], N, 4, cs.SIM_OPTS.num_hypotheses, None))
            for b in range(4)]))
        out = cs.estimate_similarity_transform_2d_3d(
            idx, t32(prob["origin"][:4]), t32(prob["dir"][:4]),
            t32(prob["point"][:4]), cs.SIM_OPTS)
        rec["sim2d3d_port_jax_agree_of_4"] = cs._agree(
            (np.asarray(summ.num_inliers[:4]), m[:4, :9]),
            (out["num_inliers"], out["R"]), 1e-3)
        runs.append(emit(part="transforms", seed=seed, **rec))
    return runs


# ------------------------------------------------------------ radial

def part_radial(seeds):
    B, N = cs.RADIAL
    prob = sp.radial_pairs(np.random.default_rng(5), B, N,
                           noise=0.5 / cs.FOCAL, outliers=0.2)
    o = cs.RADIAL_OPTS
    spec = jte.radial_distortion_homography_spec()
    run = jax.jit(jax.vmap(lambda k, a, b: jransac.ransac(
        k, spec, {"x1": a, "x2": b}, jopts(o))))
    runs = []
    for seed in seeds:
        keys = jax.random.split(jax.random.PRNGKey(seed), B)
        m, summ = run(keys, j32(prob["x1"]), j32(prob["x2"]))
        lt = np.stack([prob["l1"], prob["l2"]], -1)
        l = np.stack([np.asarray(m["l1"]), np.asarray(m["l2"])], -1)
        share = float(np.mean(np.abs(l - lt).max(-1) <= cs.RADIAL_LAMBDA_TOL))
        outs = [cs.estimate_radial_distortion_homography(
            torch.as_tensor(np.array(jrs(keys[b], N, 6, o.num_hypotheses,
                                         None))),
            t32(prob["x1"][b]), t32(prob["x2"][b]), o) for b in range(4)]
        agree = cs._agree(
            (np.asarray(summ.num_inliers[:4]), l[:4]),
            ([int(x["num_inliers"]) for x in outs],
             [[float(x["l1"]), float(x["l2"])] for x in outs]), 1e-3)
        runs.append(emit(part="radial_homography", seed=seed,
                         jax_share_within=share, port_jax_agree_of_4=agree))
    return runs


# ------------------------------------------------------------- evsac

def part_evsac(seeds):
    P, cams = pairs_scene()
    aa_true, c_true = cs.pair_truth(cams, P["pairs"])
    ratio = P["ratio"].numpy()
    mask = P["mask"].numpy()
    jw = np.stack([np.asarray(j_evsac_probabilities(
        j32(ratio[p]), jnp.asarray(mask[p]))) for p in range(len(mask))])
    tw = cs.evsac_probabilities(P["ratio"], P["mask"]).numpy()
    o = cs.EVSAC_OPTS
    x1 = P["x1"].numpy() / cs.FOCAL
    x2 = P["x2"].numpy() / cs.FOCAL
    spec = jte.relative_pose_spec()
    run = jax.jit(jax.vmap(lambda k, a, b, m, w: jransac.ransac(
        k, spec, {"x1": a, "x2": b}, jopts(o), data_mask=m,
        sample_weights=w)))
    from theiasfm_tpu.sfm.pose.twoview_utils import \
        relative_pose_from_essential as jrpe
    runs = []
    for seed in seeds:
        keys = jax.random.split(jax.random.PRNGKey(seed), len(mask))
        E, summ = run(keys, j32(x1), j32(x2), jnp.asarray(mask), j32(jw))
        R, t, _ = jax.vmap(jrpe)(E, j32(x1), j32(x2), summ.inliers)
        _, _, within = cs.pose_within(torch.as_tensor(np.asarray(R)),
                                      torch.as_tensor(np.asarray(t)),
                                      aa_true, c_true)
        idx = torch.as_tensor(np.stack([np.asarray(jws(
            keys[p], j32(jw[p] * mask[p]), 5, o.num_hypotheses))
            for p in range(len(mask))]))
        out = cs.weighted_relative_pose(idx, P, torch.as_tensor(jw),
                                        device="cpu")
        agree = cs._agree((np.asarray(summ.num_inliers),
                           np.asarray(R, np.float64)), (out[3], out[0]), 1e-3)
        runs.append(emit(part="evsac", seed=seed, jax_within_1deg_3deg=within,
                         port_jax_agree=agree,
                         prob_port_jax_max_abs=float(np.abs(tw - jw).max())))
    return runs


PARTS = {"minimal": part_minimal, "uncalibrated": part_uncalibrated,
         "transforms": part_transforms, "radial": part_radial,
         "evsac": part_evsac}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", nargs="+", default=list(PARTS),
                    choices=list(PARTS))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--out", help="write the readings as JSON here")
    a = ap.parse_args()
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(os.cpu_count() or 1)
    out = {p: PARTS[p](a.seeds) for p in a.parts}
    summary = {}
    for p, runs in out.items():
        if p == "minimal":
            summary["minimal_port_cpu_f32"] = {
                n: r["port_cpu_f32"] for n, r in runs.items()}
            summary["minimal_jax_f32_first512"] = {
                n: r["jax_f32_first512"] for n, r in runs.items()}
            continue
        for r in runs:
            flat = {f"{r['part']}.{k}": v for k, v in r.items()
                    if isinstance(v, (int, float)) and k != "seed"}
            flat.update({f"{r['part']}.{n}.{k}": v for n, d in r.items()
                         if isinstance(d, dict) for k, v in d.items()})
            for k, v in flat.items():
                # JAX's worst reading and the fewest agreements; the
                # largest probability difference
                worst = max if ("max_abs" in k or "diff" in k) else min
                summary[k] = worst(summary.get(k, v), v)
    emit(summary=summary, seeds=a.seeds)
    if a.out:
        Path(a.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
