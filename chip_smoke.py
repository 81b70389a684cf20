#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (theiasfm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (nvcc, at first use), holds each kernel
against its plain PyTorch version on the card, and drives the port's
main paths:

* the bundle adjuster (the Schur-PCG LM solve at the 1DSfM Notre-Dame
  scale: 550 cameras, 140k points, 560k observations, the `pcg_fast_pt`
  options of scripts/bench_probe.py) and its bucketed entry point;
* the rest of the bundle adjuster at the same scale: `pcg_fast_pblocks`
  (make_blocks through the ba_blocks kernel), the reconstruction-level
  entry points on a Reconstruction built view by view, the dense-Schur
  solver (`dense_schur_fast`) and the float64 polish
  (`bundle_adjust_host_f64`);
* the feature front end: 8 synthetic 640x480 views -> SIFT (default
  options) -> the batched top-2 matcher on all 28 pairs -> putative
  matches in the features-and-matches database (no geometric
  verification), checked against the views' ground-truth epipolar
  geometry;
* the front end with geometric verification (FeatureMatcher's default
  options, then guided matching): the same 28 pairs matched and
  verified in one batched call per chunk, the verified poses held to
  the ground truth and the default run's verification to the port's on
  the CPU;
* from pixels to a reconstruction: the same views' card features in a
  ReconstructionBuilder(INCREMENTAL) with the default options
  (extract_and_match_features, then build_reconstruction: P3P
  localization, track triangulation, BA and the outlier filters),
  held to the ground truth, to the gate tests/incremental_reference.py
  sets from the JAX package on the CPU, and to the same reconstruction
  on the CPU from the card's database; then 24 views with Fisher-vector
  pair selection, the matcher kernel held on that run's own chunks;
* the global pipeline at full width (`global_1dsfm`): the 1DSfM-class
  city scene of bench_problem.build_city_scene at Notre-Dame's 553 views
  (about 13,000 tracks, 0.5M observations, 5,530 edges) through
  global_reconstruction with GlobalOptions() (robust rotation averaging,
  the view-graph filters, LUD positions, triangulation, BA), cold, warm
  and profiled, held to the gate tests/global_reference.py sets from the
  JAX package on the CPU, then at 200 views;
* from pixels with the builder's default options (GLOBAL) on the 24
  views (`global_24`), held to JAX's reading, its rotation averaging to
  the CPU's on the same inputs, and its model to the CPU's build from
  the card's database; and with HYBRID on the 8 views (`hybrid`).

Every phase prints one JSON line; any failure raises, and the script
exits non-zero without printing a result. It imports neither JAX nor the
JAX package. Without a CUDA device it fails at once.

The last three lines are the `kernels` summary (one entry per replaced
TPU kernel: launches on its path, error against the plain version, its
time, the plain version's time, the library yardstick's time where one
PyTorch call computes the same product, and the bound), the card's name
and power limit from nvidia-smi, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import hashlib
import json
import pickle
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

from theiasfm_tpu_torch import _kernels
from theiasfm_tpu_torch.bench_problem import build_city_scene, make_problem
from theiasfm_tpu_torch.camera import models as cm
from theiasfm_tpu_torch.convert import features_db_from_arrays
from theiasfm_tpu_torch.image import (SiftOptions, extract_sift,
                                      extract_sift_batch,
                                      render_synthetic_views)
from theiasfm_tpu_torch.matching import FeatureMatcher, FeatureMatcherOptions
from theiasfm_tpu_torch.matching import fused_matcher as tfm
from theiasfm_tpu_torch.math import rotation as rot
from theiasfm_tpu_torch.sfm.ba import (BAOptions, bundle_adjust,
                                       bundle_adjust_reconstruction,
                                       bundle_adjust_track,
                                       bundle_adjust_view)
from theiasfm_tpu_torch.sfm.ba import bundle_adjustment as ba
from theiasfm_tpu_torch.sfm.ba import fused_matvec as fm
from theiasfm_tpu_torch.sfm.pipeline import geometric_verification as gvm
from theiasfm_tpu_torch.sfm.pipeline import global_pipeline as tgp
from theiasfm_tpu_torch.sfm.pipeline import incremental as tinc
from theiasfm_tpu_torch.sfm.pipeline import twoview as tvm
from theiasfm_tpu_torch.sfm.pose import five_point as fpm
from theiasfm_tpu_torch.sfm.reconstruction import Reconstruction
from theiasfm_tpu_torch.sfm.view_graph import ViewGraph
from theiasfm_tpu_torch.sfm.reconstruction_builder import (
    ReconstructionBuilder, ReconstructionBuilderOptions)
from theiasfm_tpu_torch.utils import (dispatch_counts, next_bucket,
                                      reset_dispatch_counts)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, the f32 rate
# outside the tensor cores (the BA kernels multiply in f32) and the dense
# TF32 tensor-core rate (top2_match's split-TF32 products)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12

SOURCE = "theiasfm_tpu_torch/csrc/schur_matvec.cu"
PALLAS = "theiasfm_tpu/sfm/ba/pallas_matvec.py"
# (kernel, layout) -> the TPU kernel it replaces
REPLACES = {("schur_pass1", "t"): f"{PALLAS}:259",
            ("schur_pass2", "t"): f"{PALLAS}:333",
            ("schur_pass1", "row"): f"{PALLAS}:147",
            ("schur_pass2", "row"): f"{PALLAS}:203"}
# max |kernel - plain| <= TOL * max|plain|: the point segments (pass 1)
# and the camera segments (pass 2) reorder the f32 sums; under bf16 a
# rounded intermediate (d = u - Jp·zp) may land one bf16 ulp apart when
# the two sum Jp·zp in another order
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# kernel shapes: (name, cameras, points, observations per point)
SHAPES = [("notre_dame", 550, 140_000, 4),
          ("nc1300", 1300, 140_000, 4),
          ("trafalgar", 5288, 1_250_000, 4),
          ("nc12000", 12_000, 140_000, 4)]
# the pcg_fast_pt options of scripts/bench_probe.py:100-127,219-220
FAST_PT = BAOptions(max_iterations=10, loss="huber", loss_scale=2.0,
                    function_tolerance=0.0, point_indices_sorted=True,
                    matvec_bf16=True, cg_eta=0.1, pallas_matvec=True,
                    pallas_transposed=True)
# pcg_fast_pblocks (scripts/bench_probe.py:86-88): make_blocks through
# the ba_blocks kernel as well
FAST_PBLOCKS = dataclasses.replace(FAST_PT, pallas_blocks=True)
BLOCKS_SOURCE = "theiasfm_tpu_torch/csrc/ba_blocks.cu"


T0 = time.perf_counter()


def emit(phase, **fields):
    """One JSON line; `elapsed_s` counts from the script's start."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - T0}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class Timer:
    """Median time of one call, from CUDA events around each call, after
    warm-up. cold: a buffer larger than the 50 MB L2 is zeroed before each
    timed call, so the call finds its inputs in device memory, and the
    zeroing (1 GiB, some 0.3 ms) keeps the card busy while the host
    enqueues the call: the events then time the device's work alone (a
    256 MiB zeroing, some 0.08 ms, was shorter than the host's enqueue of
    a Schur pass on a slow host, and the events then timed the host).
    Without it the calls run back to back, and where the host takes
    longer to enqueue a call than the card to run it, the events time the
    host."""

    def __init__(self):
        self.flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps=20, cold=True):
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(reps):
            if cold:
                self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)


# ------------------------------------------------------------------ env

def phase_env():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", nvidia_smi=nvidia_smi(), torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    t0 = time.perf_counter()
    info = _kernels.build()
    for stem in info:
        _kernels.library(stem)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for v in info.values()
             for ln in v["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit("build", seconds=build_s, sources=sorted(info), ptxas=ptxas)


# -------------------------------------------------------------- kernels

def _ids(g, n_cams, n_pts, opp):
    """Point-sorted ids as the bench problem has them, padded to a
    multiple of 1024 like pad_obs_to_multiple (last point repeated)."""
    obs_pt = np.repeat(np.arange(n_pts), opp)
    obs_cam = g.integers(0, n_cams, obs_pt.size)
    pad = (-obs_pt.size) % 1024
    obs_pt = np.concatenate([obs_pt, np.full(pad, n_pts - 1)])
    obs_cam = np.concatenate([obs_cam, np.zeros(pad, np.int64)])
    return obs_cam, obs_pt


def _bytes_ops(name, js, M, Nc, Np, P):
    """Bytes the pass must move (each input read once, each output
    written once) and its f32 operations (an FMA counts 2)."""
    jac = sum(j.numel() * j.element_size() for j in js)
    if name == "schur_pass1":
        # jacobians, ids, vc, vg in; u (2, M), wp (Np, 3) out
        nbytes = jac + 8 * M + 24 * Nc + 4 * P + 8 * M + 12 * Np
        # u: 2(6+P) FMAs; Jpᵀu: 6 FMAs; 3 adds into wp
        ops = M * (4 * (6 + P) + 12 + 3)
    else:
        # jacobians, ids, u, zp in; yc (Nc, 6), yg (2P, 2) out
        nbytes = jac + 8 * M + 8 * M + 12 * Np + 24 * Nc + 16 * P
        # Jp·z: 6 FMAs; 2 subs; Jcᵀd: 12 FMAs, 6 adds; Jiᵀd: 4P FMAs
        ops = M * (12 + 2 + 24 + 6 + 8 * P)
    return nbytes, ops


def phase_kernels(timer):
    """Each kernel against its plain version, f32 and bf16, both
    layouts, at every shape; the kernel's and the plain version's
    median ms (L2 flushed before each call), and the kernel's wrapper
    called back to back."""
    results = {}
    P = 1
    for shape, Nc, Np, opp in SHAPES:
        g = np.random.default_rng(11)
        obs_cam, obs_pt = _ids(g, Nc, Np, opp)
        M = obs_pt.size
        ids = (torch.tensor(obs_cam, dtype=torch.int32, device="cuda"),
               torch.tensor(obs_pt, dtype=torch.int32, device="cuda"))
        jac32 = [torch.randn(F, M, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(F))
                 for F in (12, 2 * P, 6)]
        vc = torch.randn(Nc, 6, device="cuda")
        vg = torch.randn(P, device="cuda")
        zp = torch.randn(Np, 3, device="cuda")
        # the point and camera indices, built once per solve in
        # bundle_adjust
        pt_index = fm.point_index(ids[1], Np)
        cam_index = fm.camera_index(ids[0], Nc)
        for dtype in (torch.float32, torch.bfloat16):
            for layout in ("t", "row"):
                if layout == "t":
                    js = [j.to(dtype) for j in jac32]
                else:
                    # (M, F) row-major storage seen as (F, M) views
                    js = [j.T.contiguous().to(dtype).T for j in jac32]
                u_ref, wp_ref = fm.pass1_plain(*js, *ids, vc, vg, Np)
                yc_ref, yg_ref = fm.pass2_plain(*js, *ids, u_ref, zp, Nc)
                u, wp = fm.pass1(*js, *ids, vc, vg, Np, pt_index)
                u2, wp2 = fm.pass1(*js, *ids, vc, vg, Np, pt_index)
                yc, yg = fm.pass2(*js, *ids, u_ref, zp, Nc, cam_index)
                yc2, yg2 = fm.pass2(*js, *ids, u_ref, zp, Nc, cam_index)
                torch.cuda.synchronize()
                check(torch.equal(u, u2) and torch.equal(wp, wp2),
                      f"{shape} {dtype} {layout}: pass 1 not repeatable")
                check(torch.equal(yc, yc2) and torch.equal(yg, yg2),
                      f"{shape} {dtype} {layout}: pass 2 not repeatable")
                errs = {}
                for key, got, ref in (("u", u, u_ref), ("wp", wp, wp_ref),
                                      ("yc", yc, yc_ref), ("yg", yg, yg_ref)):
                    check(bool(torch.isfinite(got).all()),
                          f"{shape} {dtype} {layout}: {key} not finite")
                    err = (got - ref).abs().max().item()
                    scale = ref.abs().max().item()
                    errs[key] = (err, scale)
                    check(err <= TOL[dtype] * scale,
                          f"{shape} {dtype} {layout}: {key} max abs err "
                          f"{err} > {TOL[dtype]} * {scale}")
                calls = {
                    "schur_pass1": (
                        lambda: fm.pass1(*js, *ids, vc, vg, Np, pt_index),
                        lambda: fm.pass1_plain(*js, *ids, vc, vg, Np),
                        ("u", "wp")),
                    "schur_pass2": (
                        lambda: fm.pass2(*js, *ids, u_ref, zp, Nc,
                                         cam_index),
                        lambda: fm.pass2_plain(*js, *ids, u_ref, zp, Nc),
                        ("yc", "yg")),
                }
                for name, (kern, plain, outs) in calls.items():
                    nbytes, ops = _bytes_ops(name, js, M, Nc, Np, P)
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    t_ops = ops / F32_OPS_PER_S * 1e3
                    rec = dict(
                        kernel=name, shape=shape, dtype=str(dtype)[6:],
                        layout=layout, M=M, Nc=Nc, Np=Np, P=P,
                        max_abs_err=max(errs[k][0] for k in outs),
                        rel_err=max(errs[k][0] / max(errs[k][1], 1e-30)
                                    for k in outs),
                        tol_rel=TOL[dtype],
                        ms=timer.ms(kern),
                        ms_back_to_back=timer.ms(kern, cold=False),
                        plain_ms=timer.ms(plain),
                        bytes=nbytes, ops=ops,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations")
                    emit("kernels", **rec)
                    results[(name, shape, rec["dtype"], layout)] = rec
        del jac32, ids, vc, zp, u_ref, wp_ref, yc_ref, yg_ref, cam_index
        del pt_index
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------- blocks_kernel

def _bench_jacobians(n_cams, n_pts, opp):
    """The weighted f32 jacobians and residuals of the bench problem at
    this shape (perturbed start, padded to a multiple of 1024 with masked
    observations, focal length only: P = 1), as bundle_adjust's
    build_system hands them to make_blocks."""
    prob = make_problem(n_cams, n_pts, opp, torch.float32, "cuda",
                        perturb_seed=7)
    prob = ba.pad_obs_to_multiple(prob, 1024)
    with torch.no_grad():
        r, Jc, Ji, Jp = ba._all_jacobians(
            int(cm.CameraModelType.PINHOLE), prob,
            prob.obs_mask.to(torch.float32))
    M = r.shape[0]
    return ((Jc.reshape(M, 12), Ji[:, :, :1].reshape(M, 2),
             Jp.reshape(M, 6), r.contiguous()),
            (prob.obs_cam, prob.obs_pt))


def phase_blocks_kernel(timer):
    """ba_blocks against blocks_plain on the bench problem's jacobians at
    every shape, with the camera and point indices built as bundle_adjust
    builds them: max |kernel - plain| <= 1e-4 max |plain| per output (the
    segments reorder the f32 sums), two launches give the same bits;
    median ms of the kernel (L2 flushed before each call, and back to
    back) and of the plain version."""
    results = {}
    P = 1
    for shape, Nc, Np, opp in SHAPES:
        t0 = time.perf_counter()
        js, ids = _bench_jacobians(Nc, Np, opp)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        M = js[0].shape[0]
        index = dict(cam_index=fm.camera_index(ids[0], Nc),
                     pt_index=fm.point_index(ids[1], Np))
        ref = fm.blocks_plain(*js, *ids, Nc, Np)
        got = fm.blocks(*js, *ids, Nc, Np, **index)
        again = fm.blocks(*js, *ids, Nc, Np, **index)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{shape}: ba_blocks not repeatable")
        errs = []
        for key, g, f in zip(("pt", "cam", "X", "Y"), got, ref):
            check(bool(torch.isfinite(g).all()), f"{shape}: {key} not finite")
            err, scale = (g - f).abs().max().item(), f.abs().max().item()
            check(err <= 1e-4 * scale, f"{shape}: ba_blocks {key} max abs "
                  f"err {err} > 1e-4 * {scale}")
            errs.append((err, scale))
        # each input read once (jc, ji, jp, r, two int32 ids), each output
        # written once; per observation 9+3 point and 36+6 camera values
        # (2 products and a sum each, then an add), X and Y
        nbytes = (sum(j.numel() * 4 for j in js) + 8 * M +
                  48 * Np + 168 * Nc + 4 * (4 * P * P + 4 * P))
        ops = M * (12 * 4 + 42 * 4 + 8 * P * P + 8 * P)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        rec = dict(
            kernel="ba_blocks", shape=shape, M=M, Nc=Nc, Np=Np, P=P,
            setup_s=setup_s,
            max_abs_err=max(e for e, _ in errs),
            rel_err=max(e / max(sc, 1e-30) for e, sc in errs),
            tol_rel=1e-4,
            ms=timer.ms(lambda: fm.blocks(*js, *ids, Nc, Np, **index)),
            ms_back_to_back=timer.ms(
                lambda: fm.blocks(*js, *ids, Nc, Np, **index), cold=False),
            plain_ms=timer.ms(lambda: fm.blocks_plain(*js, *ids, Nc, Np)),
            bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        emit("blocks_kernel", **rec)
        results[shape] = rec
        del js, ids, ref, got, again, index
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------- ba_main

def _counts_check(counts, what):
    n = counts.get("schur_matvec", 0)
    check(n > 0, f"{what}: no Schur products")
    for k in ("schur_pass1", "schur_pass2"):
        check(counts.get(k, 0) == n,
              f"{what}: {k} launched {counts.get(k, 0)} times for {n} "
              f"Schur products: {counts}")
    return n


def _solve(prob, opts):
    """One solve, its wall seconds (ends in a synchronize) and the
    launch counts of exactly this run."""
    reset_dispatch_counts()
    (out, s), sec = sync_time(lambda: bundle_adjust(prob, opts))
    counts = dispatch_counts()
    for x in (out.extrinsics, out.intrinsics, out.points):
        check(bool(torch.isfinite(x).all()), "non-finite parameters")
    return out, s, sec, counts


def _profile(fn, prefix):
    """Over one call of fn (torch.profiler, CPU and CUDA activity): the
    device's busy and idle share (device-side events other than the
    mirrors of the profiler ranges, so a range is not counted as a
    kernel), device time by kernel, and host and device time by the
    profiler ranges whose names start with `prefix` (a range's device
    time: the kernels launched by host ops that start inside it).
    Reads the profiler's raw events: building torch's event tree for
    the some 10^5 events of a reconstruct costs minutes. Returns (fn's
    result, the summary)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    op_start, ranges, device, kernels = {}, [], [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU:
            if ev.linked_correlation_id() == 0:
                op_start[ev.correlation_id()] = ev.start_ns()
            if ev.name().startswith(prefix):
                ranges.append((ev.name(), ev.start_ns(), ev.end_ns()))
        elif ev.device_type() == DeviceType.CUDA and \
                not ev.is_user_annotation():
            k = kernels.setdefault(ev.name(), [0.0, 0])
            k[0] += ev.duration_ns() / 1e3
            k[1] += 1
            device.append((ev.linked_correlation_id(), ev.duration_ns()))
    device = sorted((op_start.get(c, -1), d) for c, d in device)
    starts = [t for t, _ in device]
    cum = np.concatenate([[0], np.cumsum([d for _, d in device])]).tolist()
    phases = {}
    for name, a, b in ranges:
        ph = phases.setdefault(name, [0.0, 0.0, 0])
        ph[0] += (b - a) / 1e6
        ph[1] += (cum[bisect.bisect_right(starts, b)] -
                  cum[bisect.bisect_left(starts, a)]) / 1e6
        ph[2] += 1
    busy_us = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return out, dict(
        wall_s=wall,
        device_busy_s=busy_us / 1e6 if kernels else "not measured",
        device_idle_share=(1 - busy_us / 1e6 / wall) if kernels
        else "not measured",
        device_launches=sum(n for _, n in kernels.values()),
        phases={k: {"host_ms": c, "device_ms": d, "calls": n}
                for k, (c, d, n) in sorted(phases.items())},
        top=[{"kernel": k[:80], "device_ms": us / 1e3, "calls": n}
             for k, (us, n) in top],
        events_s=time.perf_counter() - t1)


def phase_ba_main():
    t0 = time.perf_counter()
    prob = make_problem(550, 140_000, 4, torch.float32, "cuda",
                        perturb_seed=7)
    prob = ba.add_pallas_matvec_plan(ba.pad_obs_to_multiple(prob, 1024),
                                     block=1024)
    setup_s = time.perf_counter() - t0
    check(ba.kernels_eligible(prob, FAST_PT), "main path not eligible")
    M = prob.obs_cam.shape[0]
    # warm-up (cuBLAS handles, the allocator's pools)
    _solve(prob, dataclasses.replace(FAST_PT, max_iterations=2))

    runs = {}
    for layout, transposed in (("t", True), ("row", False)):
        opts = dataclasses.replace(FAST_PT, pallas_transposed=transposed)
        torch.cuda.reset_peak_memory_stats()
        _, s, sec, counts = _solve(prob, opts)
        n_sv = _counts_check(counts, f"ba_main[{layout}]")
        c0, c1 = float(s.initial_cost), float(s.final_cost)
        check(np.isfinite(c1) and c1 < 0.5 * c0,
              f"ba_main[{layout}]: cost {c0} -> {c1} did not halve")
        runs[layout] = counts
        emit("ba_main", config="pcg_fast_" + ("pt" if transposed else "prow"),
             n_cams=prob.extrinsics.shape[0], n_pts=prob.points.shape[0],
             n_obs=M, setup_s=setup_s, initial_cost=c0, final_cost=c1,
             iterations=s.num_iterations, wall_s=sec,
             lm_iters_per_s=s.num_iterations / sec,
             schur_products=n_sv,
             schur_products_per_lm_iter=n_sv / s.num_iterations,
             peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
             launches={k: counts[k] for k in ("schur_pass1", "schur_pass2")})

    # f32, exact CG: the kernels against the plain matvec on the card
    exact = dataclasses.replace(FAST_PT, matvec_bf16=False, cg_eta=0.0,
                                trace_costs=True)
    _, s_k, sec_k, counts_k = _solve(prob, exact)
    _counts_check(counts_k, "ba_pair[kernels]")
    _, s_p, sec_p, counts_p = _solve(
        prob, dataclasses.replace(exact, pallas_matvec=False))
    check("schur_pass1" not in counts_p, "plain solve launched kernels")
    ck, cp = float(s_k.final_cost), float(s_p.final_cost)
    rel = abs(ck - cp) / abs(cp)
    emit("ba_pair", config="f32 matvec, cg_eta=0", kernel_final_cost=ck,
         plain_final_cost=cp, rel_diff=rel, tol_rel=1e-3,
         kernel_wall_s=sec_k, plain_wall_s=sec_p,
         kernel_iterations=s_k.num_iterations,
         plain_iterations=s_p.num_iterations,
         kernel_trace=s_k.cost_trace.tolist(),
         plain_trace=s_p.cost_trace.tolist())
    check(rel <= 1e-3, f"kernel and plain solves disagree: {ck} vs {cp}")

    s, prof = _profile(lambda: bundle_adjust(
        prob, dataclasses.replace(FAST_PT, max_iterations=3))[1], "ba.")
    emit("ba_profile", config="pcg_fast_pt", iterations=s.num_iterations,
         **prof)
    return runs


# ------------------------------------------------------------- bucketed

def phase_bucketed():
    prob = make_problem(64, 2000, 4, torch.float32, "cuda", perturb_seed=7)
    opts = dataclasses.replace(FAST_PT, max_iterations=5)
    reset_dispatch_counts()
    (out, s), sec = sync_time(lambda: ba.bundle_adjust_bucketed(prob, opts))
    counts = dispatch_counts()
    _counts_check(counts, "bucketed")
    check(out.points.shape == prob.points.shape, "bucketed: shape")
    c0, c1 = float(s.initial_cost), float(s.final_cost)
    check(np.isfinite(c1) and c1 < c0, f"bucketed: cost {c0} -> {c1}")
    emit("bucketed", n_cams=64, n_pts=2000, initial_cost=c0, final_cost=c1,
         iterations=s.num_iterations, wall_s=sec,
         launches={k: counts[k] for k in ("schur_pass1", "schur_pass2")})


# ------------------------------------------------------------ ba_blocks

def phase_ba_blocks():
    """pcg_fast_pblocks beside pcg_fast_pt on the Notre-Dame problem (the
    plan at block 512, as scripts/bench_probe.py attaches it for
    pblocks), in turns pt, pblocks, pblocks, pt; the f32 cg_eta=0 solve
    with the blocks kernel against the one with plain blocks; a profile
    of 3 LM iterations. Returns (ba_blocks launches of the first
    pcg_fast_pblocks run, the plain-blocks f32 cg_eta=0 final cost)."""
    prob = make_problem(550, 140_000, 4, torch.float32, "cuda",
                        perturb_seed=7)
    prob = ba.add_pallas_matvec_plan(ba.pad_obs_to_multiple(prob, 512),
                                     block=512)
    check(ba.blocks_kernel_eligible(prob, FAST_PBLOCKS),
          "pcg_fast_pblocks not eligible for the blocks kernel")
    _solve(prob, dataclasses.replace(FAST_PBLOCKS, max_iterations=2))
    runs = {"pcg_fast_pt": [], "pcg_fast_pblocks": []}
    launches = None
    for name in ("pcg_fast_pt", "pcg_fast_pblocks", "pcg_fast_pblocks",
                 "pcg_fast_pt"):
        opts = FAST_PBLOCKS if name == "pcg_fast_pblocks" else FAST_PT
        torch.cuda.reset_peak_memory_stats()
        _, s, sec, counts = _solve(prob, opts)
        n_sv = _counts_check(counts, name)
        n_blocks = counts.get("ba_blocks", 0)
        if name == "pcg_fast_pblocks":
            # one make_blocks per LM iteration (no jacobian reuse)
            check(n_blocks == s.num_iterations,
                  f"{name}: ba_blocks launched {n_blocks} times in "
                  f"{s.num_iterations} LM iterations")
            launches = n_blocks if launches is None else launches
        else:
            check(n_blocks == 0, f"{name}: launched ba_blocks")
        c0, c1 = float(s.initial_cost), float(s.final_cost)
        check(np.isfinite(c1) and c1 < 0.5 * c0,
              f"{name}: cost {c0} -> {c1} did not halve")
        runs[name].append(s.num_iterations / sec)
        emit("ba_blocks", config=name, n_obs=prob.obs_cam.shape[0],
             initial_cost=c0, final_cost=c1, iterations=s.num_iterations,
             wall_s=sec, lm_iters_per_s=s.num_iterations / sec,
             schur_products=n_sv,
             peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
             launches={k: counts.get(k, 0) for k in
                       ("schur_pass1", "schur_pass2", "ba_blocks")})

    exact = dataclasses.replace(FAST_PBLOCKS, matvec_bf16=False,
                                cg_eta=0.0)
    _, s_k, sec_k, counts_k = _solve(prob, exact)
    check(counts_k.get("ba_blocks", 0) == s_k.num_iterations,
          f"blocks pair: ba_blocks launches {counts_k}")
    _, s_p, sec_p, counts_p = _solve(
        prob, dataclasses.replace(exact, pallas_blocks=False))
    check("ba_blocks" not in counts_p, "plain-blocks solve launched it")
    ck, cp = float(s_k.final_cost), float(s_p.final_cost)
    rel = abs(ck - cp) / abs(cp)
    emit("ba_blocks_pair", config="f32 matvec, cg_eta=0",
         blocks_kernel_final_cost=ck, plain_blocks_final_cost=cp,
         rel_diff=rel, tol_rel=1e-3, kernel_wall_s=sec_k,
         plain_wall_s=sec_p, kernel_iterations=s_k.num_iterations,
         plain_iterations=s_p.num_iterations)
    check(rel <= 1e-3, f"blocks kernel and plain blocks disagree: {ck} "
          f"vs {cp}")

    s, prof = _profile(lambda: bundle_adjust(
        prob, dataclasses.replace(FAST_PBLOCKS, max_iterations=3))[1], "ba.")
    emit("ba_blocks_profile", config="pcg_fast_pblocks",
         iterations=s.num_iterations, **prof)
    emit("ba_blocks_summary", lm_iters_per_s=runs)
    return launches, cp


# ------------------------------------------------------------- ba_entry

def _recon_from_problem(prob):
    """A Reconstruction holding the problem's cameras (one shared
    intrinsics group), points and unmasked observations, built through
    add_view / add_track / add_observation as a pipeline builds it."""
    extr = prob.extrinsics.double().cpu().numpy()
    intr = prob.intrinsics[0].double().cpu().numpy()
    pts = prob.points.double().cpu().numpy()
    keep = prob.obs_mask.cpu().numpy()
    cams = prob.obs_cam.cpu().numpy()[keep]
    pids = prob.obs_pt.cpu().numpy()[keep]
    pix = prob.obs_pix.double().cpu().numpy()[keep]
    rec = Reconstruction()
    for i in range(extr.shape[0]):
        v = rec.add_view(f"view{i:05d}", group=0)
        cam = rec.views[v].camera
        cam.extrinsics = extr[i].copy()
        cam.intrinsics = intr.copy()
        rec.views[v].is_estimated = True
    for j in range(pts.shape[0]):
        t = rec.add_track()
        rec.tracks[t].point = np.append(pts[j], 1.0)
        rec.tracks[t].is_estimated = True
    for c, p, x in zip(cams.tolist(), pids.tolist(), pix):
        rec.add_observation(c, p, x)
    return rec


def _small_scene(V=6, N=80, seed=42):
    """tests/test_ba_entry_points.py's scene: noiseless projections of N
    points into V views of one intrinsics group."""
    g = np.random.default_rng(seed)
    positions = g.uniform(-1, 1, (V, 3))
    orient = g.uniform(-0.1, 0.1, (V, 3))
    pts = g.uniform(-2, 2, (N, 3))
    pts[:, 2] += 8.0
    Rs = rot.angle_axis_to_rotation_matrix(torch.from_numpy(orient)).numpy()
    rec = Reconstruction()
    for i in range(V):
        v = rec.add_view(f"v{i}", group=77)
        cam = rec.views[v].camera
        cam.intrinsics[0] = 600.0
        cam.intrinsics[3:5] = [320.0, 240.0]
        cam.extrinsics = np.concatenate([positions[i], orient[i]])
        rec.views[v].is_estimated = True
    for p in pts:
        t = rec.add_track()
        rec.tracks[t].point = np.append(p, 1.0)
        rec.tracks[t].is_estimated = True
    for i in range(V):
        Xc = (Rs[i] @ (pts - positions[i]).T).T
        px = 600.0 * Xc[:, :2] / Xc[:, 2:3] + np.array([320.0, 240.0])
        for t, x in enumerate(px):
            rec.add_observation(i, t, x)
    return rec, g


def phase_ba_entry():
    """bundle_adjust_reconstruction with the pcg_fast_pblocks options on
    the Notre-Dame problem built as a Reconstruction (host seconds of
    building and of one snapshot reported apart from the solve); then
    bundle_adjust_view and bundle_adjust_track on a small scene, both in
    the default float32 on the card."""
    prob = make_problem(550, 140_000, 4, torch.float32, "cpu",
                        perturb_seed=7)
    t0 = time.perf_counter()
    rec = _recon_from_problem(prob)
    build_s = time.perf_counter() - t0
    (snap, _), snapshot_s = sync_time(lambda: rec.to_ba_problem())
    n_obs = snap.obs_cam.shape[0]
    del snap
    reset_dispatch_counts()
    torch.cuda.reset_peak_memory_stats()
    summary, sec = sync_time(lambda: bundle_adjust_reconstruction(
        rec, FAST_PBLOCKS))
    counts = dispatch_counts()
    _counts_check(counts, "ba_entry")
    check(counts.get("ba_blocks", 0) == summary["num_iterations"],
          f"ba_entry: ba_blocks launches {counts}")
    c0, c1 = summary["initial_cost"], summary["final_cost"]
    check(np.isfinite(c1) and c1 < 0.5 * c0,
          f"ba_entry: cost {c0} -> {c1} did not halve")
    pts = np.stack([rec.tracks[t].xyz() for t in range(20)])
    check(bool(np.isfinite(pts).all()), "ba_entry: points not finite")

    # one view's pose and one track's point, recovered
    small, g = _small_scene()
    true_extr = small.views[2].camera.extrinsics.copy()
    small.views[2].camera.extrinsics = true_extr + g.normal(0, 0.02, 6)
    others = [small.views[u].camera.extrinsics.copy() for u in (0, 1, 3)]
    (s_view, view_s) = sync_time(lambda: bundle_adjust_view(small, 2))
    view_err = float(np.abs(small.views[2].camera.extrinsics -
                            true_extr).max())
    check(view_err <= 1e-4, f"bundle_adjust_view: pose off by {view_err}")
    for u, e in zip((0, 1, 3), others):
        # a held view comes back as the float32 snapshot held it
        check(np.array_equal(small.views[u].camera.extrinsics,
                             e.astype(np.float32).astype(np.float64)),
              "bundle_adjust_view moved a held view")
    true_pt = small.tracks[5].point.copy()
    small.tracks[5].point = true_pt + np.array([0.05, -0.03, 0.08, 0.0])
    s_track, track_s = sync_time(lambda: bundle_adjust_track(small, 5))
    track_err = float(np.abs(small.tracks[5].xyz() - true_pt[:3]).max())
    check(track_err <= 1e-4, f"bundle_adjust_track: point off by "
          f"{track_err}")
    emit("ba_entry", config="pcg_fast_pblocks",
         views=len(rec.views), tracks=len(rec.tracks), n_obs=n_obs,
         build_s=build_s, snapshot_s=snapshot_s, entry_wall_s=sec,
         initial_cost=c0, final_cost=c1,
         iterations=summary["num_iterations"],
         peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches={k: counts.get(k, 0) for k in
                   ("schur_pass1", "schur_pass2", "ba_blocks")},
         view_pose_err=view_err, view_final_cost=s_view["final_cost"],
         view_wall_s=view_s, track_point_err=track_err,
         track_final_cost=s_track["final_cost"], track_wall_s=track_s)


# ------------------------------------------------------ ba_dense, ba_f64

def phase_ba_dense(c_pcg):
    """dense_schur_fast (dense Schur with the correction blocks kept
    across rejected steps) on the Notre-Dame problem, with the point and
    camera-pair tables attached as scripts/bench_probe.py does: final
    cost within rtol 1e-3 of the f32 PCG solve with cg_eta=0."""
    prob = make_problem(550, 140_000, 4, torch.float32, "cuda",
                        perturb_seed=7)
    t0 = time.perf_counter()
    prob = ba.add_cam_pair_tables(ba.add_point_obs_map(prob))
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    opts = BAOptions(max_iterations=10, loss="huber", loss_scale=2.0,
                     function_tolerance=0.0, point_indices_sorted=True,
                     linear_solver="dense_schur", precond_reuse=True,
                     trace_costs=True)
    _solve(prob, dataclasses.replace(opts, max_iterations=1))
    torch.cuda.reset_peak_memory_stats()
    _, s, sec, counts = _solve(prob, opts)
    check(not counts, f"ba_dense launched {counts}")
    c1 = float(s.final_cost)
    rel = abs(c1 - c_pcg) / abs(c_pcg)
    emit("ba_dense", config="dense_schur_fast", tables_s=tables_s,
         initial_cost=float(s.initial_cost), final_cost=c1,
         pcg_f32_eta0_final_cost=c_pcg, rel_diff=rel, tol_rel=1e-3,
         iterations=s.num_iterations, wall_s=sec,
         lm_iters_per_s=s.num_iterations / sec,
         rejected=int((s.cost_trace < 0).sum()),
         peak_device_gib=torch.cuda.max_memory_allocated() / 2**30)
    check(rel <= 1e-3, f"dense Schur and PCG disagree: {c1} vs {c_pcg}")


def phase_ba_f64():
    """The float64 polish on the card from a converged float32 state: an
    f32 solve (kernels, cg_eta=0) to function tolerance 1e-9, then
    bundle_adjust_host_f64 with the exact options of
    scripts/bench_probe.py's matched mode, 12 iterations. Its final cost
    may exceed the float64 cost of the state it started from by at most a
    factor 1 + 1e-6, and lies within 1e-4 of the f32 final cost: the f32
    cost itself is off by some 2e-5 (its projections round in f32), so
    the two precisions' costs are compared only to that."""
    prob = make_problem(550, 140_000, 4, torch.float32, "cuda",
                        perturb_seed=7)
    prob = ba.add_pallas_matvec_plan(ba.pad_obs_to_multiple(prob, 1024),
                                     block=1024)
    warm = dataclasses.replace(FAST_PT, matvec_bf16=False, cg_eta=0.0,
                               max_iterations=30, function_tolerance=1e-9)
    out32, s32, sec32, _ = _solve(prob, warm)
    c32 = float(s32.final_cost)
    polish = BAOptions(max_iterations=12, cg_iterations=100, cg_tol=1e-6,
                       loss="huber", loss_scale=2.0,
                       function_tolerance=1e-12, point_indices_sorted=True)
    reset_dispatch_counts()
    (out64, s64), sec = sync_time(
        lambda: ba.bundle_adjust_host_f64(out32, polish))
    counts = dispatch_counts()
    check(out64.points.dtype == torch.float64 and
          out64.points.device.type == "cuda", "ba_f64: not f64 on the card")
    for x in (out64.extrinsics, out64.intrinsics, out64.points):
        check(bool(torch.isfinite(x).all()), "ba_f64: non-finite")
    c64, c64_0 = float(s64.final_cost), float(s64.initial_cost)
    emit("ba_f64", f32_final_cost=c32, f32_iterations=s32.num_iterations,
         f32_wall_s=sec32, f64_initial_cost=c64_0, f64_final_cost=c64,
         f64_iterations=s64.num_iterations, f64_wall_s=sec,
         rel_gain=(c64_0 - c64) / c64_0, rel_diff_f32=(c64 - c32) / c32,
         schur_products=counts.get("schur_matvec", 0))
    check(c64 <= c64_0 * (1 + 1e-6),
          f"ba_f64: {c64} > {c64_0} * (1 + 1e-6)")
    check(abs(c64 - c32) <= 1e-4 * c32, f"ba_f64: {c64} vs f32 {c32}")


# ------------------------------------------------------ matcher_kernels

MATCH_SOURCE = "theiasfm_tpu_torch/csrc/top2_match.cu"
MATCHER = "theiasfm_tpu/matching/pallas_matcher.py"
RATIO = 0.8
# (name, pairs B, padded rows N, D, valid rows per pair lo..hi): the
# chunks of `frontend` (28 pairs) and of `incremental_24` (174 pairs in
# chunks of 32: five of 32 and one of 14), whose views hold some 1,500
# SIFT features each
MATCH_SHAPES = [("frontend", 28, 2048, 128, 1400, 1600),
                ("incremental_24", 32, 2048, 128, 1400, 1600),
                ("incremental_24_last", 14, 2048, 128, 1400, 1600),
                ("unbatched_8192", 1, 8192, 128, 8192, 8192),
                ("ragged", 3, 200, 32, 150, 200)]


def _desc_stack(g, B, N, D, lo, hi):
    """B pairs of SIFT-like descriptor stacks (non-negative, unit rows)
    padded with zeros to N rows, lo..hi valid rows each; half of each
    pair's keys are noisy copies of its queries, so the ratio test
    passes on some rows and fails on others."""
    d = np.zeros((2, B, N, D), np.float32)
    m = np.zeros((2, B, N), bool)
    for b in range(B):
        n1, n2 = g.integers(lo, hi + 1, 2)
        a = np.abs(g.normal(size=(n1, D)))
        k = np.abs(g.normal(size=(n2, D)))
        share = min(n1, n2) // 2
        k[:share] = a[g.permutation(n1)[:share]] + \
            0.3 * np.abs(g.normal(size=(share, D)))
        for i, (x, n) in enumerate(((a, n1), (k, n2))):
            d[i, b, :n] = x / np.linalg.norm(x, axis=1, keepdims=True)
            m[i, b, :n] = True
    t = [torch.from_numpy(x).cuda() for x in (d[0], d[1], m[0], m[1])]
    return t


def _near_tie(best, second):
    return (second - best).abs() <= 1e-5 * best.abs()


def _check_top2(what, got, ref):
    """idx identical except at near-ties; best and second to 1e-5 of the
    largest entry. Returns (max abs err, idx mismatches at near-ties)."""
    (gb, gs, gi), (rb, rs, ri) = got, ref
    tie = _near_tie(rb, rs)
    bad = int(((gi != ri) & ~tie).sum())
    check(bad == 0, f"{what}: {bad} idx differ away from a near-tie")
    err = max((gb - rb).abs().max().item(), (gs - rs).abs().max().item())
    scale = max(rb.abs().max().item(), rs.abs().max().item())
    check(err <= 1e-5 * scale, f"{what}: max abs err {err} > 1e-5*{scale}")
    for x in got:
        check(bool(torch.isfinite(x.float()).all()), f"{what}: not finite")
    return err, int(((gi != ri) & tie).sum())


def _check_wrapper(what, got, ref, fwd, rev=None):
    """A fused wrapper on the kernel route against the same wrapper on
    the plain route (CPU tensors): idx as _check_top2; best to 1e-5 of
    the largest entry; valid identical except where the ratio is within
    1e-5 of lowes_ratio² or an idx sits on a near-tie (forward, or in
    the reverse pass the back-check reads), on at most 0.1% of rows.
    fwd/rev: plain (best, second) of each direction with ||a||² added."""
    gi, gv, gb = got
    ri, rv, rb = (x.cuda() for x in ref)
    tie = _near_tie(*fwd)
    check(bool(((gi == ri) | tie).all()), f"{what}: idx differ")
    err = (gb - rb).abs().max().item()
    check(err <= 1e-5 * rb.abs().max().item(), f"{what}: best err {err}")
    diff = gv != rv
    ok = ((fwd[0] / fwd[1] - RATIO ** 2).abs() <= 1e-5) | tie
    if rev is not None:
        ok = ok | _near_tie(*rev).gather(-1, gi.long())
    n_diff = int(diff.sum())
    check(bool((~diff | ok).all()) and n_diff <= 1e-3 * diff.numel(),
          f"{what}: {n_diff} valid rows differ")
    return err, n_diff


def _plain_full(d1, d2, n2m):
    """The plain (best, second) with ||a||² added, for the tolerances."""
    b, s, _ = tfm.top2_plain(d1, d2, n2m)
    n1 = (d1 * d1).sum(-1)
    return (b + n1).clamp_min(0), (s + n1).clamp_min(0)


def phase_matcher_kernels(timer):
    """top2_match against top2_plain on the card at each shape, then the
    fused wrappers on the kernel route against the same wrappers on the
    plain route; median ms of 20 calls (L2 flushed) of the kernel, the
    plain version and torch.bmm of the same product (TF32 off)."""
    results = {}
    for shape, B, N, D, lo, hi in MATCH_SHAPES:
        g = np.random.default_rng(21)
        d1, d2, m1, m2 = _desc_stack(g, B, N, D, lo, hi)
        n2m = torch.where(m2, (d2 * d2).sum(-1), 1e30)
        n1m = torch.where(m1, (d1 * d1).sum(-1), 1e30)
        ref = tfm.top2_plain(d1, d2, n2m)
        got = tfm.top2(d1, d2, n2m)
        torch.cuda.synchronize()
        err, ties = _check_top2(shape, got, ref)

        fwd = _plain_full(d1, d2, n2m)
        cpu = [x.cpu() for x in (d1, d2, m1, m2)]
        if B == 1:
            w_got = tfm.match_descriptors_fused(d1[0], d2[0], m1[0], m2[0])
            w_ref = tfm.match_descriptors_fused(*(x[0] for x in cpu))
            w_err, w_diff = _check_wrapper(
                f"{shape} match_descriptors_fused",
                [x[None] for x in w_got], [x[None] for x in w_ref], fwd)
        else:
            rev = _plain_full(d2, d1, n1m)
            w_got = tfm.match_descriptors_fused_batch(d1, d2, m1, m2)
            w_ref = tfm.match_descriptors_fused_batch(*cpu)
            w_err, w_diff = _check_wrapper(
                f"{shape} match_descriptors_fused_batch", w_got, w_ref,
                fwd, rev)
        n_valid = int(w_got[1].sum())

        # split TF32: three tensor-core products per dot product
        ops = 3 * 2 * B * N * N * D
        nbytes = 4 * (2 * B * N * D + B * N) + 12 * B * N
        t_ops = ops / TF32_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        d2t = d2.transpose(1, 2)
        rec = dict(
            kernel="top2_match", shape=shape, B=B, M=N, N=N, D=D,
            valid_rows=f"{lo}..{hi}", max_abs_err=err,
            idx_diff_at_near_ties=ties, wrapper_max_abs_err=w_err,
            wrapper_valid_rows_differing=w_diff, wrapper_valid=n_valid,
            tol="idx except near-ties; best/second 1e-5 of max; valid "
                "except |ratio-0.64|<=1e-5 on <=0.1%",
            ms=timer.ms(lambda: tfm.top2(d1, d2, n2m)),
            plain_ms=timer.ms(lambda: tfm.top2_plain(d1, d2, n2m)),
            library_ms=timer.ms(lambda: torch.bmm(d1, d2t)),
            ops=ops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        rec["ms_back_to_back"] = timer.ms(
            lambda: tfm.top2(d1, d2, n2m), cold=False)
        emit("matcher_kernels", **rec)
        results[shape] = rec
        del d1, d2, m1, m2, n1m, n2m, ref, got, fwd, cpu, w_got, w_ref
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------- frontend

N_VIEWS = 8


def _texture(seed=0):
    """Band-limited noise: sum over s of s·gaussian_filter(N(0,1), s)
    for s = 1, 2, 4, 8 (a fresh draw per scale), scaled to [0, 1]."""
    from scipy import ndimage
    g = np.random.default_rng(seed)
    tex = sum(s * ndimage.gaussian_filter(g.normal(size=(768, 1024)), s)
              for s in (1, 2, 4, 8))
    return (tex - tex.min()) / (tex.max() - tex.min())


def _epipolar_px(corr, cam1, cam2):
    """Distance (px) of each match's second point from the epipolar line
    of its first, under the ground-truth cameras (x_cam = R X + t).
    Keypoints index pixels; synth.py samples pixel centres, so +0.5."""
    R = cam2["R"] @ cam1["R"].T
    t = cam2["t"] - R @ cam1["t"]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Kinv = np.linalg.inv(cam1["K"])
    F = np.linalg.inv(cam2["K"]).T @ tx @ R @ Kinv
    x1 = np.concatenate([corr[:, :2] + 0.5, np.ones((len(corr), 1))], 1)
    x2 = np.concatenate([corr[:, 2:] + 0.5, np.ones((len(corr), 1))], 1)
    lines = x1 @ F.T
    return np.abs((x2 * lines).sum(1)) / np.hypot(lines[:, 0], lines[:, 1])


def _kp_agree(a, b, tol=1e-2):
    """Share of a's valid keypoints with one of b's within tol px."""
    pa, pb = a[0][a[2], :2], b[0][b[2], :2]
    d = np.linalg.norm(pa[:, None] - pb[None], axis=-1)
    return float(np.mean(d.min(1) <= tol))


def phase_frontend():
    """The front end at full width: 8 views of 640x480, SIFT with the
    default options (4 octaves, 1024 features per octave), the batched
    matcher on all 28 pairs (one chunk), putative matches stored."""
    t0 = time.perf_counter()
    views, cams = render_synthetic_views(_texture(0), N_VIEWS, (640, 480),
                                         focal=600.0)
    names = [f"view{i:03d}" for i in range(N_VIEWS)]
    setup_s = time.perf_counter() - t0
    opts = SiftOptions()

    torch.cuda.reset_peak_memory_stats()
    reset_dispatch_counts()
    feats, cold_s = sync_time(lambda: extract_sift_batch(views, opts,
                                                     device="cuda"))
    n_feat = [int(v.sum()) for _, _, v in feats]
    max_n = next_bucket(max(n_feat), 128)
    check(max_n == 2048, f"frontend: max_n {max_n} != 2048 ({n_feat}): "
          "the batched matcher would not route to the kernel")
    arrays = {n: (k[v], d[v]) for n, (k, d, v) in zip(names, feats)}
    priors = {n: dict(image_width=640, image_height=480, focal_length=600.0,
                      principal_point=(320.0, 240.0)) for n in names}

    def match_all():
        db = features_db_from_arrays(arrays, priors)
        fm = FeatureMatcher(FeatureMatcherOptions(
            perform_geometric_verification=False), db, device="cuda")
        fm.add_images(names)
        return fm.match_images(), db

    (n_pairs, db), match_s = sync_time(match_all)
    counts = dispatch_counts()
    check(counts == {"top2_match": 2},
          f"frontend: launches {counts}, expected 2 top2_match")
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(n_pairs == len(db.image_pairs_of_matches()),
          "frontend: stored pair count")

    warm = []
    for _ in range(3):
        _, sec = sync_time(lambda: extract_sift_batch(views, opts,
                                                     device="cuda"))
        warm.append(sec)
    match_warm = []
    for _ in range(3):
        reset_dispatch_counts()
        _, sec = sync_time(match_all)
        check(dispatch_counts() == {"top2_match": 2},
              "frontend: top2_match launches per match_images != 2")
        match_warm.append(sec)

    # where the time goes: one warm SIFT call and one match_images
    _, sift_prof = _profile(lambda: extract_sift_batch(
        views, opts, device="cuda"), "sift.")
    emit("frontend_profile", stage="sift", **sift_prof)
    _, match_prof = _profile(match_all, "match.")
    emit("frontend_profile", stage="match_images", **match_prof)

    per_pair, shares = {}, {}
    for (a, b) in db.image_pairs_of_matches():
        m = db.get_match(a, b)
        i, j = names.index(a), names.index(b)
        dist = _epipolar_px(m.correspondences, cams[i], cams[j])
        per_pair[f"{i}-{j}"] = len(m.correspondences)
        shares[f"{i}-{j}"] = float(np.mean(dist <= 2.0))
    adjacent = [f"{i}-{i + 1}" for i in range(N_VIEWS - 1)]
    for p in adjacent:
        check(per_pair.get(p, 0) >= 30,
              f"frontend: adjacent pair {p} stored {per_pair.get(p, 0)}")
        check(shares[p] >= 0.8, f"frontend: pair {p}: only {shares[p]:.3f}"
              " of putative matches within 2 px of the epipolar line")

    # the card's SIFT against the port's SIFT on the CPU, view 0
    cpu0, cpu_s = sync_time(lambda: extract_sift(views[0], opts,
                                                 device="cpu"))
    agree = (_kp_agree(feats[0], cpu0), _kp_agree(cpu0, feats[0]))
    check(min(agree) >= 0.99, f"frontend: card vs CPU SIFT {agree}")

    # one pair through the unbatched entry point, as a user matches a
    # single pair (symmetry composed from a reverse call): the matches
    # the batched run stored for the pair, but for rows whose ratio test
    # the padded batch's other float32 norms may flip (at most 1%)
    (k0, d0), (k1, d1) = arrays[names[0]], arrays[names[1]]
    a, b = torch.from_numpy(d0).cuda(), torch.from_numpy(d1).cuda()
    reset_dispatch_counts()
    idx, valid, _ = tfm.match_descriptors_fused(a, b)
    ridx, _, _ = tfm.match_descriptors_fused(b, a)
    pair_counts = dispatch_counts()
    check(pair_counts == {"top2_match": 2},
          f"frontend pair: launches {pair_counts}")
    valid = valid & (ridx[idx.long()] == torch.arange(len(a), device="cuda",
                                                      dtype=ridx.dtype))
    sel = torch.nonzero(valid)[:, 0].cpu().numpy()
    corr = np.concatenate([k0[sel, :2], k1[idx.cpu().numpy()[sel], :2]], 1)
    stored = db.get_match(names[0], names[1]).correspondences
    n_sym = len({tuple(r) for r in corr} ^ {tuple(r) for r in stored})
    check(n_sym <= 0.01 * len(stored),
          f"frontend pair: unbatched and batched differ in {n_sym} rows")

    emit("frontend", views=N_VIEWS, size=[640, 480], sift="SiftOptions()",
         setup_s=setup_s, features_per_view=n_feat, max_n=max_n,
         sift_cold_s=cold_s, sift_ms_per_image=statistics.median(warm) /
         N_VIEWS * 1e3, sift_warm_s=warm, pairs_stored=n_pairs,
         matcher_ms_per_chunk=statistics.median(match_warm) * 1e3,
         matcher_first_s=match_s, matcher_warm_s=match_warm,
         putative_per_pair=per_pair, epipolar_share_2px=shares,
         epipolar_share_adjacent_min=min(shares[p] for p in adjacent),
         launches=counts, pair_launches=pair_counts,
         pair_rows_differing=n_sym,
         card_vs_cpu_sift=list(agree), cpu_sift_s=cpu_s,
         peak_device_gib=peak)
    scene = dict(names=names, arrays=arrays, priors=priors, cams=cams,
                 sift_s=statistics.median(warm))
    return counts["top2_match"], pair_counts["top2_match"], scene


# ------------------------------------------------------ frontend_verify

def _true_relative(cam1, cam2):
    """Ground-truth relative rotation (angle-axis) and unit position of
    camera 2 in camera 1's frame (x_cam = R X + t)."""
    R = cam2["R"] @ cam1["R"].T
    t = cam2["t"] - R @ cam1["t"]
    c = -R.T @ t
    aa = rot.rotation_matrix_to_angle_axis(torch.from_numpy(R)).numpy()
    return aa, c / np.linalg.norm(c)


def _rotation_error_deg(aa1, aa2):
    R1 = rot.angle_axis_to_rotation_matrix(torch.from_numpy(
        np.asarray(aa1, float))).numpy()
    R2 = rot.angle_axis_to_rotation_matrix(torch.from_numpy(
        np.asarray(aa2, float))).numpy()
    c = (np.trace(R1.T @ R2) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _pose_errors(info, cam1, cam2):
    """Rotation error and position-direction error (degrees) of a
    TwoViewInfo against the ground truth."""
    aa, c = _true_relative(cam1, cam2)
    pos = np.asarray(info.position_2, float)
    return (_rotation_error_deg(info.rotation_2, aa),
            float(np.degrees(np.arccos(np.clip(
                pos @ c / max(np.linalg.norm(pos), 1e-12), -1.0, 1.0)))))


def _pair_records(db, scene, what):
    """Per stored pair: verified and homography-inlier counts, pose
    errors against the ground truth, share of the stored matches within
    2 px of the true epipolar line. Raises unless every adjacent pair is
    verified with >= 30 matches, >= 90% of them within 2 px."""
    names, cams = scene["names"], scene["cams"]
    rec = {}
    for (a, b) in db.image_pairs_of_matches():
        m = db.get_match(a, b)
        i, j = names.index(a), names.index(b)
        rot_err, dir_err = _pose_errors(m.twoview_info, cams[i], cams[j])
        rec[f"{i}-{j}"] = dict(
            verified=m.twoview_info.num_verified_matches,
            homography_inliers=m.twoview_info.num_homography_inliers,
            rotation_err_deg=rot_err, direction_err_deg=dir_err,
            epipolar_share_2px=float(np.mean(_epipolar_px(
                m.correspondences, cams[i], cams[j]) <= 2.0)))
    for p in (f"{i}-{i + 1}" for i in range(N_VIEWS - 1)):
        r = rec.get(p)
        check(r is not None and r["verified"] >= 30,
              f"{what}: adjacent pair {p} not verified with >= 30 ({r})")
        check(r["epipolar_share_2px"] >= 0.9,
              f"{what}: pair {p} epipolar share {r['epipolar_share_2px']}")
    return rec


# Bounds of frontend_verify, from tests/frontend_verify_reference.py on
# the CPU over this scene's putative matches (seeds 0-9, float32 and
# float64): JAX's own verification puts 10-15 of the 28 pairs within 1
# and 3 degrees of the true pose (guided: 8-14), and no adjacent pair in
# every run (a planar twin of the essential matrix explains about as
# many matches as the true one on the nearly planar pairs). With the
# same sample indices, float32 rounding alone makes the port's and
# JAX's verdicts differ on 8-15 of the 28 pairs (the RANSAC stage alone
# on 5-15), float64 on 0-2 (guided 0-4, the guided matcher's top-k
# ties); the card and the CPU split 8 in float32 and 1 in float64
# (PERF.md, the frontend_verify cell).
POSE_PAIRS_MIN = {"default": 10, "guided": 8}
DIFFERING_MAX = {torch.float32: 16, torch.float64: 2}


def _check_pose(pose, run, what):
    """At least POSE_PAIRS_MIN[run] of the verified pairs within 1
    degree of the true rotation and 3 degrees of the true position
    direction: the least JAX's verification reaches on the same putative
    matches with the same options."""
    check(pose["within_1deg_3deg"] >= POSE_PAIRS_MIN[run],
          f"{what}: poses against the ground truth: {pose}")


def _pose_summary(errors):
    """[(rotation, direction) error] -> the share within 1 and 3
    degrees and the medians."""
    rot_e = np.array([e[0] for e in errors])
    dir_e = np.array([e[1] for e in errors])
    return dict(pairs=len(errors),
                within_1deg_3deg=int(np.sum((rot_e <= 1.0) &
                                            (dir_e <= 3.0))),
                median_rotation_err_deg=float(np.median(rot_e)),
                median_direction_err_deg=float(np.median(dir_e)))


class _VerifySpy:
    """Records, during a run of the matcher, the arguments of its
    verify_matches_batch call, the samples it drew and the call's wall
    time (synchronized)."""

    def __init__(self):
        self.calls = []
        self._draw = gvm.draw_verification_samples
        self._verify = gvm.verify_matches_batch

    def __enter__(self):
        def draw(*a, **k):
            out = self._draw(*a, **k)
            self.calls[-1]["samples"] = out
            return out

        def verify(*a, **k):
            self.calls.append(dict(args=a, kwargs=k))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._verify(*a, **k)
            torch.cuda.synchronize()
            self.calls[-1]["seconds"] = time.perf_counter() - t0
            self.calls[-1]["out"] = out
            return out
        gvm.draw_verification_samples = draw
        gvm.verify_matches_batch = verify
        return self

    def __exit__(self, *exc):
        gvm.draw_verification_samples = self._draw
        gvm.verify_matches_batch = self._verify


def _to_cpu(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


def _agreement(a_infos, b_infos, pairs):
    """Pairs that two runs accept differently or whose verified counts
    differ by more than 1% (or 2) or rotations by more than 0.05
    degrees, and the largest differences over the pairs both accept."""
    out = dict(accepted=[int(sum(i is not None for i in a_infos)),
                         int(sum(i is not None for i in b_infos))],
               max_count_diff=0, max_rotation_diff_deg=0.0, differing={})
    for (i, j), a, b in zip(pairs, a_infos, b_infos):
        if a is None or b is None:
            if (a is None) != (b is None):
                out["differing"][f"{i}-{j}"] = [
                    None if x is None else x.num_verified_matches
                    for x in (a, b)]
            continue
        dn = abs(a.num_verified_matches - b.num_verified_matches)
        dr = _rotation_error_deg(a.rotation_2, b.rotation_2)
        out["max_count_diff"] = max(out["max_count_diff"], dn)
        out["max_rotation_diff_deg"] = max(out["max_rotation_diff_deg"], dr)
        if dn > max(2, 0.01 * b.num_verified_matches) or dr > 0.05:
            out["differing"][f"{i}-{j}"] = [a.num_verified_matches,
                                            b.num_verified_matches, dr]
    return out


def _card_vs_cpu(call, scene, run):
    """The chunk's verify_matches_batch once more with the samples the
    card drew, on the CPU in float32 and on both in float64, and its
    RANSAC stage alone (estimate_twoview_info_batch) on both in each
    type: which stage splits. Per pair: the acceptance, the verified
    counts (within 1% or 2) and the rotations (within 0.05 degrees);
    at most DIFFERING_MAX pairs may differ. Every adjacent pair is
    accepted by the CPU too, and the float64 poses are held to the
    ground truth as the float32 ones are (_check_pose)."""
    what = f"frontend_verify {run}"
    names, cams = scene["names"], scene["cams"]
    pairs = [(i, j) for i in range(len(names)) for j in range(i + 1,
                                                              len(names))]
    check(len(pairs) == len(call["out"][0]), f"{what}: a pair had too few "
          "putative matches to be verified")
    s = call["samples"]
    args, kwargs = call["args"][1:], call["kwargs"]
    cpu_args = [_to_cpu(a) for a in args]
    cpu_kwargs = {k: _to_cpu(v) for k, v in kwargs.items()}
    cpu_kwargs["device"] = "cpu"
    cpu_samples = gvm.VerificationSamples(s.essential.cpu(),
                                          s.homography.cpu())
    gv = args[8] if len(args) > 8 else kwargs.get("opts")
    ropts = (gv or gvm.GeometricVerificationOptions()).estimate_twoview_info
    out, runs = {}, {}
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        if dtype == torch.float32:
            card = call["out"][0]
        else:
            (card, _), out["card_f64_s"] = sync_time(
                lambda: gvm.verify_matches_batch(s, *args, **kwargs,
                                                 dtype=dtype))
        (cpu, _), out[f"cpu_{tag}_s"] = sync_time(
            lambda: gvm.verify_matches_batch(cpu_samples, *cpu_args,
                                             **cpu_kwargs, dtype=dtype))
        ransac = [tvm.estimate_twoview_info_batch(
            e, *a[:7], ropts, dtype=dtype, device=dev)[0]
            for e, a, dev in ((s.essential, args, kwargs["device"]),
                              (cpu_samples.essential, cpu_args, "cpu"))]
        out[f"{tag}_card_vs_cpu"] = _agreement(card, cpu, pairs)
        out[f"{tag}_ransac_card_vs_cpu"] = _agreement(*ransac, pairs)
        runs[dtype] = card
        for key in (f"{tag}_card_vs_cpu", f"{tag}_ransac_card_vs_cpu"):
            check(len(out[key]["differing"]) <= DIFFERING_MAX[dtype],
                  f"{what}: card and CPU disagree ({key}): {out[key]}")
        for (i, j), info in zip(pairs, cpu):
            check(j != i + 1 or info is not None,
                  f"{what}: the CPU's {tag} run rejects pair {i}-{j}")
    out["f64_pose"] = _pose_summary([
        _pose_errors(info, cams[i], cams[j])
        for (i, j), info in zip(pairs, runs[torch.float64])
        if info is not None])
    _check_pose(out["f64_pose"], run, f"{what}, float64")
    return out


def _five_point_ms(P, Hn):
    """Host-inclusive wall ms (median of 5, synchronized) of the
    five-point stage at the chunk's shape (P pairs x Hn samples)."""
    g = torch.Generator("cuda").manual_seed(0)
    x1 = torch.rand((P, Hn, 5, 2), generator=g, device="cuda") - 0.5
    x2 = x1 + 0.05 * torch.rand((P, Hn, 5, 2), generator=g, device="cuda")
    fpm.five_point_essential(x1, x2)
    return statistics.median(sync_time(
        lambda: fpm.five_point_essential(x1, x2))[1] * 1e3
        for _ in range(5))


def phase_frontend_verify(scene):
    """The front end with geometric verification on, as FeatureMatcher
    runs it by default: the 28 pairs of `frontend` matched and verified
    in one chunk (5-point RANSAC with 256 hypotheses, homography count,
    two-view BA, triangulation gates), then again with guided
    matching."""
    names, arrays, priors = scene["names"], scene["arrays"], scene["priors"]

    def match_all(opts):
        db = features_db_from_arrays(arrays, priors)
        fm = FeatureMatcher(opts, db, device="cuda")
        fm.add_images(names)
        return fm.match_images(), db

    results, verified = {}, {}
    for run, opts in (("default", FeatureMatcherOptions()),
                      ("guided", FeatureMatcherOptions(
                          guided_matching=True))):
        torch.cuda.reset_peak_memory_stats()
        # what earlier phases still hold (the timer's 1 GiB flush buffer)
        held = torch.cuda.memory_allocated() / 2**30
        reset_dispatch_counts()
        with _VerifySpy() as spy:
            (n_pairs, db), first_s = sync_time(lambda: match_all(opts))
        counts = dispatch_counts()
        check(counts == {"top2_match": 2},
              f"frontend_verify {run}: launches {counts}, expected 2 "
              "top2_match")
        check(len(spy.calls) == 1, f"frontend_verify {run}: "
              f"{len(spy.calls)} verify_matches_batch calls per chunk")
        peak = torch.cuda.max_memory_allocated() / 2**30
        pairs = _pair_records(db, scene, f"frontend_verify {run}")
        check(n_pairs == len(pairs), f"frontend_verify {run}: stored count")
        # the card-vs-CPU reruns for the default options only: the
        # guided run shares their stages, and its reruns took some 21 s
        # of the script's time
        cpu = (_card_vs_cpu(spy.calls[0], scene, run) if run == "default"
               else "not rerun")

        warm, verify_warm = [], []
        for _ in range(3):
            reset_dispatch_counts()
            with _VerifySpy() as spy:
                _, sec = sync_time(lambda: match_all(opts))
            check(dispatch_counts() == {"top2_match": 2},
                  "frontend_verify: top2_match launches per match_images "
                  "!= 2")
            warm.append(sec)
            verify_warm.append(spy.calls[0]["seconds"])
        _, prof = _profile(lambda: match_all(opts), ("match.", "verify."))
        emit("frontend_verify_profile", run=run, **prof)
        if run == "guided":
            for p, r in pairs.items():
                base = verified.get(p, 0)
                i, j = map(int, p.split("-"))
                if j == i + 1:
                    check(r["verified"] >= base,
                          f"frontend_verify guided: pair {p} verified "
                          f"{r['verified']} < {base} without guidance")
        verified.update({p: r["verified"] for p, r in pairs.items()})
        putative = spy.calls[0]["args"][3].sum(axis=1)
        results[run] = dict(
            pairs_verified=n_pairs, pairs_putative=len(putative),
            putative_max=int(putative.max()),
            ms_per_chunk=statistics.median(warm) * 1e3,
            verify_ms=statistics.median(verify_warm) * 1e3,
            warm_s=warm, verify_warm_s=verify_warm, first_call_s=first_s,
            card_vs_cpu=cpu, peak_device_gib=peak,
            peak_above_held_gib=peak - held, launches=counts,
            pairs=pairs, pose=_pose_summary([
                (r["rotation_err_deg"], r["direction_err_deg"])
                for r in pairs.values()]),
            adjacent_rotation_err_max_deg=max(
                pairs[f"{i}-{i + 1}"]["rotation_err_deg"]
                for i in range(N_VIEWS - 1)),
            adjacent_direction_err_max_deg=max(
                pairs[f"{i}-{i + 1}"]["direction_err_deg"]
                for i in range(N_VIEWS - 1)),
            adjacent_epipolar_share_min=min(
                pairs[f"{i}-{i + 1}"]["epipolar_share_2px"]
                for i in range(N_VIEWS - 1)))
        emit("frontend_verify", run=run, **results[run])
        _check_pose(results[run]["pose"], run, f"frontend_verify {run}")
        del db
        torch.cuda.empty_cache()
    P = len(names) * (len(names) - 1) // 2
    Hn = FeatureMatcherOptions().geometric_verification.num_hypotheses
    emit("frontend_verify_five_point", shape=[P, Hn],
         five_point_ms=_five_point_ms(P, Hn))
    return results


# ---------------------------------------------------------- incremental

# Gate of the incremental phases (views reconstructed, mean reprojection
# error), from tests/incremental_reference.py: JAX's
# ReconstructionBuilder(INCREMENTAL) on the CPU on the same 8 views,
# seeds 0-4, reconstructs every view at 0.1121-0.7839 px (PERF.md, the
# incremental cell). The gate is JAX's worst reading: every view, and a
# mean error of at most 0.784 px (0.7839 rounded up at the third decimal).
INCR_VIEWS_MIN_SHARE = 1.0
INCR_REPROJ_MAX_PX = 0.784
# The card's reconstruction against the same one on the CPU from the card's
# database (each device draws its own localization samples): the same views
# estimated, and estimated tracks within this share of the card's.
INCR_CPU_TRACKS_REL = 0.05


def _rodrigues(aa):
    aa = np.asarray(aa, float)
    th = np.linalg.norm(aa)
    if th < 1e-12:
        return np.eye(3)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _umeyama(src, dst):
    """Similarity (s, R, t) with dst ~ s R src + t (least squares)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    U, S, Vt = np.linalg.svd(dc.T @ sc / len(src))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((sc ** 2).sum() / len(src))
    return s, R, mu_d - s * R @ mu_s


def _view_index(name):
    return int(name[4:])


def model_report(model, cams):
    """A reconstruction (this package's or the JAX package's: the same
    fields) against the rendered views' ground truth (x_cam = R X + t):
    views and tracks estimated, the reprojection error of every
    observation of an estimated track in an estimated view (pinhole, no
    distortion), and after a similarity alignment of the camera centres
    to the true ones (Umeyama) the rotation errors and the position
    errors as a fraction of the scene size (the largest distance between
    two true centres of the estimated views)."""
    views = sorted(model.estimated_views())
    errs = _reprojection_errors(model, views)
    out = dict(views_estimated=len(views),
               tracks_estimated=len(model.estimated_tracks()),
               reproj_mean_px=float(errs.mean()) if errs.size else None,
               reproj_median_px=float(np.median(errs)) if errs.size
               else None, observations=int(errs.size))
    if len(views) >= 3:
        idx = [_view_index(model.views[v].name) for v in views]
        est = np.stack([model.views[v].camera.extrinsics[:3] for v in views])
        Rt = [cams[i]["R"] for i in idx]
        true = np.stack([-R.T @ cams[i]["t"] for R, i in zip(Rt, idx)])
        out.update(_aligned_errors(model, views, est, true, Rt))
        out["median_position_err_frac"] = out.pop("median_position_err") \
            / out["scene_size"]
        out["max_position_err_frac"] = out.pop("max_position_err") \
            / out["scene_size"]
    return out


def _reprojection_errors(model, views):
    """Pixel reprojection error of every observation of an estimated
    track in the given views (pinhole, no distortion)."""
    errs = []
    for v in views:
        view = model.views[v]
        ext, intr = np.asarray(view.camera.extrinsics, float), \
            np.asarray(view.camera.intrinsics, float)
        tids = [t for t in view.features if t in model.tracks and
                model.tracks[t].is_estimated]
        if not tids:
            continue
        X = np.stack([model.tracks[t].point[:3] / model.tracks[t].point[3]
                      for t in tids])
        pix = np.stack([view.features[t] for t in tids])
        pc = (X - ext[:3]) @ _rodrigues(ext[3:]).T
        xy = pc[:, :2] / pc[:, 2:]
        proj = np.stack([intr[0] * xy[:, 0] + intr[2] * xy[:, 1] + intr[3],
                         intr[0] * intr[1] * xy[:, 1] + intr[4]], 1)
        errs.append(np.linalg.norm(proj - pix, axis=1))
    return np.concatenate(errs) if errs else np.zeros(0)


def _aligned_errors(model, views, est, true, Rt):
    """After a similarity alignment of the estimated centres `est` to the
    true ones (Umeyama): the rotation errors (true world->camera
    rotations Rt) and the position errors in the truth's units, with the
    scene size (the largest distance between two true centres)."""
    s, Ra, ta = _umeyama(est, true)
    size = np.linalg.norm(true[:, None] - true[None], axis=-1).max()
    pos = np.linalg.norm(s * est @ Ra.T + ta - true, axis=1)
    rot_e = []
    for v, R in zip(views, Rt):
        Re = _rodrigues(model.views[v].camera.extrinsics[3:]) @ Ra.T
        c = (np.trace(R.T @ Re) - 1) / 2
        rot_e.append(float(np.degrees(np.arccos(np.clip(c, -1, 1)))))
    return dict(median_rotation_err_deg=float(np.median(rot_e)),
                max_rotation_err_deg=float(np.max(rot_e)),
                median_position_err=float(np.median(pos)),
                max_position_err=float(np.max(pos)),
                scene_size=float(size))


def city_report(model, extrs):
    """A reconstruction of bench_problem.build_city_scene (this
    package's or the JAX package's) against the scene's true cameras
    `extrs` (V, 6): views and tracks estimated, the reprojection errors,
    and after a similarity alignment the rotation errors and the
    position errors in scene units (the camera loop's diameter is 60)."""
    views = sorted(model.estimated_views())
    errs = _reprojection_errors(model, views)
    out = dict(views_estimated=len(views),
               tracks_estimated=len(model.estimated_tracks()),
               reproj_mean_px=float(errs.mean()) if errs.size else None,
               observations=int(errs.size))
    if len(views) >= 3:
        idx = [int(model.views[v].name[1:5]) for v in views]
        est = np.stack([np.asarray(model.views[v].camera.extrinsics[:3],
                                   float) for v in views])
        Rt = [_rodrigues(extrs[i, 3:]) for i in idx]
        out.update(_aligned_errors(model, views, est, extrs[idx, :3], Rt))
    return out


class PoseSpy:
    """Records, while active, the cameras a global-pipeline module (this
    package's or the JAX package's) hands its first estimate_all_tracks:
    rotation averaging, the view-graph filters and the positions done,
    no track triangulated yet. The spy copies the estimated cameras (a
    millisecond at 553 views); `report`, city_report's reading of them
    against the truth `extrs`, is computed when read, outside any timed
    window."""

    def __init__(self, module, extrs):
        self.module, self.extrs = module, extrs
        self.cameras = None
        self._report = None

    def __enter__(self):
        self._real = self.module.estimate_all_tracks

        def spy(recon, *a, **k):
            if self.cameras is None:
                self.cameras = _CameraSnapshot(recon)
            return self._real(recon, *a, **k)
        self.module.estimate_all_tracks = spy
        return self

    def __exit__(self, *exc):
        self.module.estimate_all_tracks = self._real

    @property
    def report(self):
        if self._report is None and self.cameras is not None:
            self._report = city_report(self.cameras, self.extrs)
        return self._report


class _CameraSnapshot:
    """A copy of a reconstruction's estimated cameras (names, extrinsics
    and intrinsics), with no track: enough of a Reconstruction for
    city_report."""

    def __init__(self, recon):
        self.views = {v: types.SimpleNamespace(
            name=recon.views[v].name, features={},
            camera=types.SimpleNamespace(
                extrinsics=np.array(recon.views[v].camera.extrinsics,
                                    float),
                intrinsics=np.array(recon.views[v].camera.intrinsics,
                                    float)))
            for v in recon.estimated_views()}
        self.tracks = {}

    def estimated_views(self):
        return list(self.views)

    def estimated_tracks(self):
        return []


class SeedSpy:
    """Records, while active, the pairs an incremental module's
    _initialize_from_pair places and the tracks each triangulates; the
    last one placed is the seed. Works on this package's module and on
    the JAX package's (the same function name and first arguments)."""

    def __init__(self, module):
        self.module = module
        self.calls = []

    def __enter__(self):
        self._real = self.module._initialize_from_pair

        def spy(recon, graph, pair, *a, **k):
            n = self._real(recon, graph, pair, *a, **k)
            names = [recon.views[v].name for v in pair]
            self.calls.append(dict(pair=names, tracks=int(n),
                                   info=graph.edge(*pair)))
            return n
        self.module._initialize_from_pair = spy
        return self

    def __exit__(self, *exc):
        self.module._initialize_from_pair = self._real

    def seed(self, cams):
        """The seed pair, its triangulated tracks, its TwoViewInfo's
        counts and its pose errors against the ground truth."""
        if not self.calls:
            return None
        c = self.calls[-1]
        i, j = (_view_index(n) for n in c["pair"])
        rot_err, dir_err = _pose_errors(c["info"], cams[i], cams[j])
        return dict(pair=f"{i}-{j}", tracks=c["tracks"],
                    pairs_tried=len(self.calls),
                    verified=int(c["info"].num_verified_matches),
                    homography_inliers=int(c["info"].num_homography_inliers),
                    rotation_err_deg=rot_err, direction_err_deg=dir_err)


def builder_gate(report, n_views, views_min_share, reproj_max_px):
    """A builder phase's gate: at least views_min_share of the views
    reconstructed at a mean reprojection error of at most
    reproj_max_px."""
    return (report["views_estimated"] >= views_min_share * n_views
            and report["reproj_mean_px"] is not None
            and report["reproj_mean_px"] <= reproj_max_px)


def incremental_gate(report, n_views):
    """The incremental phases' gate (INCR_VIEWS_MIN_SHARE,
    INCR_REPROJ_MAX_PX)."""
    return builder_gate(report, n_views, INCR_VIEWS_MIN_SHARE,
                        INCR_REPROJ_MAX_PX)


def _builder(scene, opts, device="cuda", db=None):
    """A ReconstructionBuilder on `device` whose database holds the
    scene's card SIFT features and priors (or `db`), with every view
    added by name: extract_and_match_features then skips extraction and
    matches, as it does for images the database already holds."""
    if db is None:
        db = features_db_from_arrays(scene["arrays"], scene["priors"])
    b = ReconstructionBuilder(opts, db, device=device)
    for n in scene["names"]:
        b.add_image(n)
    return b


def _builder_run(scene, opts, what, gate=(INCR_VIEWS_MIN_SHARE,
                                           INCR_REPROJ_MAX_PX),
                 seed_module=tinc):
    """extract_and_match_features, then build_reconstruction, on the
    card: wall seconds of each (synchronized), the counts of exactly
    this run, the pairs matched, the seed pair (of seed_module's
    _initialize_from_pair; None skips it), the model's report and the
    builder (its database holds the verified matches). `gate`: the
    views share and mean reprojection error (px) the model must
    meet."""
    b = _builder(scene, opts)
    reset_dispatch_counts()
    n_pairs, em_s = sync_time(b.extract_and_match_features)
    match_counts = dispatch_counts()
    pairs = b._matcher._pairs
    n_matched = (len(pairs) if pairs is not None else
                 len(scene["names"]) * (len(scene["names"]) - 1) // 2)
    chunks = -(-n_matched // opts.matching.pair_batch_size)
    check(match_counts.get("top2_match", 0) == 2 * chunks,
          f"{what}: top2_match launched {match_counts} for {chunks} "
          "chunks, expected 2 per chunk")
    reset_dispatch_counts()
    spy = SeedSpy(seed_module) if seed_module else None
    with spy or contextlib.nullcontext():
        models, rec_s = sync_time(b.build_reconstruction)
    counts = dispatch_counts()
    check(len(models) >= 1, f"{what}: no model")
    report = model_report(models[0], scene["cams"])
    check(builder_gate(report, len(scene["names"]), *gate),
          f"{what}: gate (>= {gate[0]:.3f} of the views, "
          f"mean reprojection <= {gate[1]} px) failed: {report}")
    for m in models:
        for v in m.estimated_views():
            check(np.isfinite(m.views[v].camera.extrinsics).all(),
                  f"{what}: non-finite camera")
    return dict(extract_and_match_s=em_s, reconstruct_s=rec_s,
                pairs_matched=n_matched, pairs_verified=n_pairs,
                chunks=chunks, top2_match=match_counts["top2_match"],
                match_launches=match_counts, device_dispatches=counts,
                models=len(models),
                seed_pair=spy.seed(scene["cams"]) if spy else None,
                **report), b, models


def phase_incremental(scene):
    """From pixels to a reconstruction at full width: the `frontend`
    views' card features in a ReconstructionBuilder(INCREMENTAL) with
    every other option at its default (SiftOptions(),
    FeatureMatcherOptions() with verification, IncrementalOptions());
    one cold run and one warm run of extract_and_match_features and
    build_reconstruction, one profiled build_reconstruction, and the
    same reconstruction once on the CPU from the card's database."""
    opts = ReconstructionBuilderOptions(
        reconstruction_estimator_type="INCREMENTAL")
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    cold, b, _ = _builder_run(scene, opts, "incremental cold")
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm = [_builder_run(scene, opts, "incremental warm")[0]]
    models, prof = _profile(
        lambda: _builder(scene, opts, db=b.db).build_reconstruction(),
        "incr.")
    emit("incremental_profile", **prof)
    cpu_b = _builder(scene, opts, device="cpu", db=b.db)
    with SeedSpy(tinc) as spy:
        cpu_models, cpu_s = sync_time(cpu_b.build_reconstruction)
    check(len(cpu_models) >= 1, "incremental: no model on the CPU")
    cpu = dict(reconstruct_s=cpu_s, models=len(cpu_models),
               seed_pair=spy.seed(scene["cams"]),
               **model_report(cpu_models[0], scene["cams"]))
    card_views = sorted(models[0].estimated_views())
    check(sorted(cpu_models[0].estimated_views()) == card_views,
          f"incremental: the CPU rerun estimates other views than the "
          f"card: {cpu['views_estimated']} against {len(card_views)}")
    n_card = len(models[0].estimated_tracks())
    check(abs(cpu["tracks_estimated"] - n_card) <=
          INCR_CPU_TRACKS_REL * n_card,
          f"incremental: the CPU rerun estimates {cpu['tracks_estimated']} "
          f"tracks, the card {n_card} (at most "
          f"{INCR_CPU_TRACKS_REL:.0%} apart)")
    res = dict(views=len(scene["names"]), size=[640, 480],
               options="ReconstructionBuilderOptions(INCREMENTAL)",
               gate=dict(views_min_share=INCR_VIEWS_MIN_SHARE,
                         reproj_max_px=INCR_REPROJ_MAX_PX,
                         cpu_tracks_rel=INCR_CPU_TRACKS_REL),
               sift_s=scene["sift_s"], cold=cold, warm=warm,
               extract_and_match_warm_s=[w["extract_and_match_s"]
                                         for w in warm],
               reconstruct_warm_s=[w["reconstruct_s"] for w in warm],
               peak_device_gib=peak, peak_above_held_gib=peak - held,
               cpu_from_card_db=cpu,
               nvidia_smi=nvidia_smi())
    emit("incremental", **res)
    return cold["top2_match"], res


def phase_incremental_24():
    """The same at 24 views, pairs chosen by Fisher vectors (8 nearest
    neighbours and query expansion, as scripts/bench_e2e.py sets them at
    24 views): the views' SIFT on the card, then one run (the first at
    this size)."""
    n = 24
    views, cams = render_synthetic_views(_texture(0), n, (640, 480),
                                         focal=600.0)
    names = [f"view{i:03d}" for i in range(n)]
    opts_s = SiftOptions()
    extract_sift_batch(views[:2], opts_s, device="cuda")
    feats, sift_s = sync_time(lambda: extract_sift_batch(views, opts_s,
                                                         device="cuda"))
    scene = dict(names=names, cams=cams, sift_s=sift_s,
                 arrays={nm: (k[v], d[v]) for nm, (k, d, v) in
                         zip(names, feats)},
                 priors={nm: dict(image_width=640, image_height=480,
                                  focal_length=600.0,
                                  principal_point=(320.0, 240.0))
                         for nm in names})
    opts = ReconstructionBuilderOptions(
        reconstruction_estimator_type="INCREMENTAL",
        select_image_pairs_with_global_descriptors=True,
        num_nearest_neighbors_for_global_descriptor_matching=8)
    # the run keeps the inputs of the first top2 call at each chunk
    # shape; top2_match is then held against top2_plain on them
    chunks, real = {}, tfm.top2

    def keep(d1, d2, n2):
        chunks.setdefault(tuple(d1.shape),
                          (d1.clone(), d2.clone(), n2.clone()))
        return real(d1, d2, n2)
    torch.cuda.reset_peak_memory_stats()
    tfm.top2 = keep
    try:
        run, _, _ = _builder_run(scene, opts, "incremental_24")
    finally:
        tfm.top2 = real
    chunk_check = {}
    for shape, (d1, d2, n2) in sorted(chunks.items()):
        what = "incremental_24 chunk " + "x".join(map(str, shape))
        err, ties = _check_top2(what, tfm.top2(d1, d2, n2),
                                tfm.top2_plain(d1, d2, n2))
        chunk_check[what] = dict(max_abs_err=err, idx_diff_at_near_ties=ties)
    del chunks
    res = dict(views=n, all_pairs=n * (n - 1) // 2, sift_s=sift_s,
               gate=dict(views_min_share=INCR_VIEWS_MIN_SHARE,
                         reproj_max_px=INCR_REPROJ_MAX_PX),
               top2_on_chunks=chunk_check,
               peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
               nvidia_smi=nvidia_smi(), **run)
    emit("incremental_24", **res)
    return run["top2_match"], max(c["max_abs_err"]
                                  for c in chunk_check.values()), scene


# ------------------------------------------------------ global pipeline

# The global phases' inputs and gates. The gates are JAX's worst readings
# on the same inputs from tests/global_reference.py (JAX's pipelines on
# the CPU, float32 as on a TPU, and x64 where it says; PERF.md, the
# global cells).
# global_1dsfm: bench_problem.build_city_scene at the 1DSfM Notre-Dame view
# count (scripts/bench_global_stages.py) with seed 0, and at
# tests/test_large_scale.py's size.
CITY = (553, 14_000)
CITY_SMALL = (200, 4_000)
# At 553 views JAX's GlobalOptions() (seeds 0-2, float32 and x64: six
# runs) averages the rotations to a median error of 0.166-0.367 deg and
# places 551-553 views by LUD at a median position error of 1.10-2.13
# units (of the 60-unit loop) before the first triangulation, which then
# triangulates no track that survives, so no view is left: JAX misses
# test_large_scale's rule (>= 95% of the views, median position error <
# 0.3) there. The gate is JAX's worst reading of each pose-stage number
# over those runs, rounded up at the third decimal; the final model is
# printed, not gated. The LUD's reading is chaotic there: seed 0's scene,
# the one this phase builds, reads 1.27 in float32 and 2.13 in x64.
GLOBAL_POSES_VIEWS_MIN_SHARE = 551 / 553
GLOBAL_POSES_ROT_MAX_DEG = 0.367
GLOBAL_POSES_POS_MAX = 2.132
# At 200 views JAX (seeds 0-9, float32) reconstructs 192-200 views at a
# median position error of 0.0099-0.2401 units, and 0.527 at seed 9: the
# gate is JAX's least views, 192, and test_large_scale's 0.3, which caps
# JAX's worst position reading.
GLOBAL_SMALL_VIEWS_MIN_SHARE = 192 / 200
GLOBAL_SMALL_POS_MAX = 0.3
# global_24 (ReconstructionBuilderOptions() on incremental_24's views and
# Fisher-vector pairs) and hybrid (HYBRID on the 8 incremental views):
# JAX's worst reading (views share, mean reprojection px, rounded up at
# the third decimal). JAX's GLOBAL reconstructs 23-24 of the 24 views at
# 0.1102-0.1295 px over seeds 0-9 (ten: its outcome is unstable, below).
# Its HYBRID builds no model at seeds 3 and 6 of 0-9 (its seed pair's
# verification lands on the planar twin, ROADMAP queue 3) and every
# view at 0.1117-0.1146 px at the others: the gate is that of its models.
GLOBAL24_GATE = (23 / 24, 0.130)
HYBRID_GATE = (1.0, 0.115)
# global_24's card run against the CPU from the card's database. The
# translation refinement solves in float64 in both packages' stead
# (global_pipeline._refine_relative_translations: in float32 its normal
# matrix is singular up to the 1e-10 damping, and JAX's own float32 run
# on one database lands elsewhere than its x64 run; tests/
# global_reference.py --part global_24_db, ROADMAP queue 3), so the
# float32 model is a function of its database. The card's float32 run is
# held to the port's float32 rerun on the CPU from the card's database:
# the same views, tracks within G24_CPU_TRACKS_REL, mean reprojection
# errors within G24_CPU_REPROJ_REL and median rotation errors within
# G24_CPU_ROT_DEG of each other; and its rotation averaging, rerun on
# the CPU on the card's inputs, within G24_ROTATIONS_CPU_TOL rad.
G24_ROTATIONS_CPU_TOL = 1e-4
G24_CPU_TRACKS_REL = 0.05
G24_CPU_REPROJ_REL = 0.01
G24_CPU_ROT_DEG = 0.5


def _city(n_views, n_points):
    """bench_problem.build_city_scene(default_rng(0), ...) on the host,
    pickled once (each run unpickles its own copy, faster than a
    deepcopy of 0.5M observations), with its build seconds and sizes."""
    t0 = time.perf_counter()
    recon, graph, extrs = build_city_scene(np.random.default_rng(0),
                                           n_views, n_points)
    build_s = time.perf_counter() - t0
    return dict(blob=pickle.dumps((recon, graph)), extrs=extrs,
                build_s=build_s, views=n_views,
                points=n_points, tracks=recon.num_tracks(),
                observations=sum(len(v.features)
                                 for v in recon.views.values()),
                edges=graph.num_edges())


class FilterSpy:
    """Records, while active, the inputs and the keep or remove decisions
    of the global pipeline's two angle filters (the rotation-cycle filter
    and the orientation filter, both at 5 degrees; float32 on the card).
    The records are references and a shallow copy of the edge map (the
    cycle filter reads only each edge's rotation): `flips()`, called
    after the run, reruns both filters on the CPU in float64 on those
    inputs and counts the edges whose decision differs."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        self._orient = tgp.filter_view_pairs_from_orientation
        self._cycle = tgp.filter_view_graph_cycles_by_rotation

        def orient(*a, **k):
            keep = self._orient(*a, **k)
            self.calls["orientation"] = (a, dict(k), keep)
            return keep

        def cycle(graph, *a, **k):
            before = dict(graph.edges())
            n = self._cycle(graph, *a, **k)
            self.calls["cycle"] = (before, a, dict(k), set(graph.edges()))
            return n
        tgp.filter_view_pairs_from_orientation = orient
        tgp.filter_view_graph_cycles_by_rotation = cycle
        return self

    def __exit__(self, *exc):
        tgp.filter_view_pairs_from_orientation = self._orient
        tgp.filter_view_graph_cycles_by_rotation = self._cycle

    def flips(self):
        f64 = dict(dtype=torch.float64, device="cpu")
        out = {}
        if "orientation" in self.calls:
            a, k, keep = self.calls["orientation"]
            out["orientation"] = int(np.sum(keep != self._orient(
                *a, **{**k, **f64})))
        if "cycle" in self.calls:
            before, a, k, kept = self.calls["cycle"]
            ref = ViewGraph()
            for (v1, v2), info in before.items():
                ref.add_edge(v1, v2, info)
            self._cycle(ref, *a, **{**k, **f64})
            out["cycle"] = len(kept ^ set(ref.edges()))
        return out


def _global_run(city, what, profile=False, filter_spy=False):
    """global_reconstruction with GlobalOptions() on the card, on a copy
    of the city's reconstruction and view graph: wall seconds (ends in a
    synchronize), the summary's stage seconds, the counts of exactly
    this run, the cameras' reading before the first triangulation
    (PoseSpy) and the final model's (city_report), peak memory; with
    `profile`, under _profile and its summary of the global.* ranges;
    with `filter_spy`, the angle filters' float32 flips (FilterSpy).
    Both spies only record inside the timed window; their readings and
    the float64 reruns come after it."""
    recon, graph = pickle.loads(city["blob"])
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    reset_dispatch_counts()
    prof = None

    def run():
        return tgp.global_reconstruction(recon, graph, tgp.GlobalOptions())
    fspy = FilterSpy() if filter_spy else None
    with PoseSpy(tgp, city["extrs"]) as spy, \
            fspy or contextlib.nullcontext():
        if profile:
            summary, prof = _profile(run, "global.")
            sec = prof["wall_s"]
        else:
            summary, sec = sync_time(run)
    counts = dispatch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(summary["success"], f"{what}: {summary}")
    check(spy.report is not None, f"{what}: no pose reached triangulation")
    for v in recon.estimated_views():
        check(np.isfinite(recon.views[v].camera.extrinsics).all(),
              f"{what}: non-finite camera")
    return dict(wall_s=sec, timings=summary["timings"],
                device_dispatches=counts, peak_device_gib=peak,
                peak_above_held_gib=peak - held, poses=spy.report,
                filter_flips_vs_cpu_f64=fspy.flips() if fspy else None,
                **city_report(recon, city["extrs"])), prof


def _check_poses(run, n_views, what):
    p = run["poses"]
    check(p["views_estimated"] >= GLOBAL_POSES_VIEWS_MIN_SHARE * n_views
          and p.get("median_rotation_err_deg", np.inf) <=
          GLOBAL_POSES_ROT_MAX_DEG
          and p.get("median_position_err", np.inf) <= GLOBAL_POSES_POS_MAX,
          f"{what}: pose gate (>= {GLOBAL_POSES_VIEWS_MIN_SHARE:.4f} of the "
          f"views, median rotation <= {GLOBAL_POSES_ROT_MAX_DEG} deg, "
          f"median position <= {GLOBAL_POSES_POS_MAX}) failed: {p}")


def phase_global_1dsfm():
    """The global pipeline at full width: build_city_scene at 553 views
    (14,000 points, 0.5 px, 5% outlier edges) through
    global_reconstruction with GlobalOptions() in float32 on the card,
    one cold run, one warm and one profiled; then at 200 views (4,000
    points), where JAX reconstructs, once."""
    city = _city(*CITY)
    sizes = {k: city[k] for k in ("views", "points", "tracks",
                                  "observations", "edges", "build_s")}
    cold, _ = _global_run(city, "global_1dsfm cold", filter_spy=True)
    warm, _ = _global_run(city, "global_1dsfm warm")
    profiled, prof = _global_run(city, "global_1dsfm profiled",
                                 profile=True)
    emit("global_1dsfm_profile", **prof)
    for run, what in ((cold, "cold"), (warm, "warm"),
                      (profiled, "profiled")):
        _check_poses(run, CITY[0], f"global_1dsfm {what}")
    del city
    small = _city(*CITY_SMALL)
    small_run, _ = _global_run(small, "global_1dsfm 200 views")
    check(small_run["views_estimated"] >=
          GLOBAL_SMALL_VIEWS_MIN_SHARE * CITY_SMALL[0] and
          small_run.get("median_position_err", np.inf) <
          GLOBAL_SMALL_POS_MAX,
          f"global_1dsfm 200 views: gate (>= "
          f"{GLOBAL_SMALL_VIEWS_MIN_SHARE:.3f} of the views, median "
          f"position < {GLOBAL_SMALL_POS_MAX}) failed: {small_run}")
    res = dict(options="GlobalOptions()", scene=sizes, cold=cold,
               warm=warm, profiled_wall_s=profiled["wall_s"],
               gate=dict(poses_views_min_share=GLOBAL_POSES_VIEWS_MIN_SHARE,
                         poses_rotation_max_deg=GLOBAL_POSES_ROT_MAX_DEG,
                         poses_position_max=GLOBAL_POSES_POS_MAX,
                         small_views_min_share=GLOBAL_SMALL_VIEWS_MIN_SHARE,
                         small_position_max=GLOBAL_SMALL_POS_MAX),
               small=dict(scene={k: small[k] for k in sizes}, **small_run),
               nvidia_smi=nvidia_smi())
    emit("global_1dsfm", **res)
    return res


class RotationSpy:
    """Records, while active, the inputs and output of the global
    pipeline's robust_rotation_averaging (the last call); `cpu_diff()`,
    called after the run, reruns it on the CPU in the same dtype on
    those inputs and returns the largest angle-axis difference (rad)."""

    def __enter__(self):
        self._real = tgp.robust_rotation_averaging
        self.call = None

        def spy(*a, **k):
            out = self._real(*a, **k)
            self.call = (a, dict(k), np.asarray(out))
            return out
        tgp.robust_rotation_averaging = spy
        return self

    def __exit__(self, *exc):
        tgp.robust_rotation_averaging = self._real

    def cpu_diff(self):
        a, k, out = self.call
        ref = self._real(*a, **{**k, "device": "cpu"})
        return float(np.max(np.abs(out - np.asarray(ref))))


def _model_views(model):
    return sorted(model.views[v].name for v in model.estimated_views())


def _db_fingerprint(db):
    """A digest of the database's verified matches (pairs,
    correspondences to 1e-3 px, relative rotations to 1e-4) and their
    count: equal digests mean the same input to the estimator."""
    h, n = hashlib.sha1(), 0
    for a, b in sorted(db.image_pairs_of_matches()):
        m = db.get_match(a, b)
        h.update(f"{a}/{b}".encode())
        h.update(np.round(np.asarray(m.correspondences, np.float64), 3)
                 .tobytes())
        h.update(np.round(np.asarray(m.twoview_info.rotation_2,
                                     np.float64), 4).tobytes())
        n += len(m.correspondences)
    return h.hexdigest()[:12], n


def phase_global_24(scene):
    """From pixels with the builder's default options (GLOBAL) on
    incremental_24's views and card features, Fisher-vector pairs (8
    neighbours): one run on the card (float32), its rotation averaging
    rerun on the CPU on the card's inputs, then the same build on the CPU
    from the card's database."""
    opts = ReconstructionBuilderOptions(
        select_image_pairs_with_global_descriptors=True,
        num_nearest_neighbors_for_global_descriptor_matching=8)
    check(opts.reconstruction_estimator_type == "GLOBAL",
          "the builder's default estimator is not GLOBAL")
    torch.cuda.reset_peak_memory_stats()
    with RotationSpy() as rspy:
        run, b, models = _builder_run(scene, opts, "global_24",
                                      gate=GLOBAL24_GATE, seed_module=None)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(rspy.call is not None, "global_24: no rotation averaging")
    rot_diff = rspy.cpu_diff()
    check(rot_diff <= G24_ROTATIONS_CPU_TOL,
          f"global_24: the card's rotation averaging is {rot_diff} rad "
          f"from the CPU's on the same inputs (> {G24_ROTATIONS_CPU_TOL})")
    cpu_models, cpu_s = sync_time(_builder(scene, opts, device="cpu",
                                           db=b.db).build_reconstruction)
    check(len(cpu_models) >= 1, "global_24 on the CPU: no model")
    cpu = dict(reconstruct_s=cpu_s, models=len(cpu_models),
               **model_report(cpu_models[0], scene["cams"]))
    rel = dict(
        tracks=abs(cpu["tracks_estimated"] /
                   max(run["tracks_estimated"], 1) - 1),
        reproj=abs((cpu["reproj_mean_px"] or np.inf) /
                   run["reproj_mean_px"] - 1),
        rotation_deg=abs(cpu["median_rotation_err_deg"] -
                         run["median_rotation_err_deg"]))
    check(_model_views(cpu_models[0]) == _model_views(models[0]) and
          rel["tracks"] <= G24_CPU_TRACKS_REL and
          rel["reproj"] <= G24_CPU_REPROJ_REL and
          rel["rotation_deg"] <= G24_CPU_ROT_DEG,
          f"global_24: the CPU's build from the card's database differs "
          f"from the card's (the same views, tracks within "
          f"{G24_CPU_TRACKS_REL}, reprojection within {G24_CPU_REPROJ_REL}"
          f", rotation error within {G24_CPU_ROT_DEG} deg): {rel} {cpu}")
    res = dict(views=len(scene["names"]),
               options="ReconstructionBuilderOptions() (GLOBAL), "
               "Fisher-vector pairs",
               gate=dict(views_min_share=GLOBAL24_GATE[0],
                         reproj_max_px=GLOBAL24_GATE[1],
                         rotations_cpu_tol_rad=G24_ROTATIONS_CPU_TOL,
                         cpu_tracks_rel=G24_CPU_TRACKS_REL,
                         cpu_reproj_rel=G24_CPU_REPROJ_REL,
                         cpu_rotation_deg=G24_CPU_ROT_DEG),
               db_fingerprint=_db_fingerprint(b.db),
               peak_device_gib=peak, rotations_vs_cpu_rad=rot_diff,
               cpu_vs_card=rel, cpu_from_card_db=cpu,
               nvidia_smi=nvidia_smi(), **run)
    emit("global_24", **res)
    return run["top2_match"]


def phase_hybrid(scene):
    """From pixels with ReconstructionBuilder(HYBRID) on the `frontend`
    views' card features: one run."""
    opts = ReconstructionBuilderOptions(
        reconstruction_estimator_type="HYBRID")
    run, _, _ = _builder_run(scene, opts, "hybrid", gate=HYBRID_GATE,
                             seed_module=None)
    emit("hybrid", views=len(scene["names"]),
         options="ReconstructionBuilderOptions(HYBRID)",
         gate=dict(views_min_share=HYBRID_GATE[0],
                   reproj_max_px=HYBRID_GATE[1]),
         nvidia_smi=nvidia_smi(), **run)


# ----------------------------------------------------------------- main

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.manual_seed(0)
    timer_start = time.perf_counter()
    phase_env()
    timer = Timer()
    kres = phase_kernels(timer)
    bres = phase_blocks_kernel(timer)
    mres = phase_matcher_kernels(timer)
    runs = phase_ba_main()
    phase_bucketed()
    n_blocks, c_pcg = phase_ba_blocks()
    phase_ba_entry()
    phase_ba_dense(c_pcg)
    phase_ba_f64()
    n_batched, n_pair, scene = phase_frontend()
    phase_frontend_verify(scene)
    n_incr, _ = phase_incremental(scene)
    n_incr24, err_incr24, scene24 = phase_incremental_24()
    phase_global_1dsfm()
    n_global24 = phase_global_24(scene24)
    phase_hybrid(scene)

    summary = []
    for (name, layout), replaces in REPLACES.items():
        rec = kres[(name, "notre_dame", "bfloat16", layout)]
        tra = kres[(name, "trafalgar", "bfloat16", layout)]
        summary.append(dict(
            name=name if layout == "t" else f"{name}[row]",
            route="cuda", source=SOURCE, replaces=replaces,
            launches=runs[layout][name],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=None,
            shape="notre_dame bf16", trafalgar_ms=tra["ms"],
            trafalgar_plain_ms=tra["plain_ms"],
            trafalgar_bound_ms=tra["bound_ms"]))
    rec, tra = bres["notre_dame"], bres["trafalgar"]
    summary.append(dict(
        name="ba_blocks", route="cuda", source=BLOCKS_SOURCE,
        replaces=f"{PALLAS}:644", launches=n_blocks,
        max_abs_err=rec["max_abs_err"], ms=rec["ms"],
        plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by=rec["bound_by"], library_ms=None,
        shape="notre_dame f32", trafalgar_ms=tra["ms"],
        trafalgar_plain_ms=tra["plain_ms"],
        trafalgar_bound_ms=tra["bound_ms"]))
    for name, shape, line, launches, extra in (
            ("top2_match", "frontend", 120, n_batched,
             dict(incremental_launches=n_incr,
                  incremental_24_launches=n_incr24,
                  global_24_launches=n_global24,
                  incremental_24_max_abs_err=max(
                      err_incr24, mres["incremental_24"]["max_abs_err"],
                      mres["incremental_24_last"]["max_abs_err"]))),
            ("top2_match[B=1]", "unbatched_8192", 30, n_pair, {})):
        rec = mres[shape]
        summary.append(dict(
            name=name, route="cuda", source=MATCH_SOURCE,
            replaces=f"{MATCHER}:{line}", launches=launches,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            shape=f"{shape}: B={rec['B']} M=N={rec['N']} D={rec['D']}",
            **extra))
    emit("done", seconds=time.perf_counter() - timer_start)
    print(json.dumps({"kernels": summary}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
