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
  geometry.

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

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from theiasfm_tpu_torch import _kernels
from theiasfm_tpu_torch.bench_problem import make_problem
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
from theiasfm_tpu_torch.sfm.reconstruction import Reconstruction
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
# max |kernel - plain| <= TOL * max|plain|: atomics (pass 1) and the
# camera segments (pass 2) reorder the f32 sums; under bf16 a rounded
# intermediate (d = u - Jp·zp) may land one bf16 ulp apart when the two
# sum Jp·zp in another order
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# kernel shapes: (name, cameras, points, observations per point)
SHAPES = [("notre_dame", 550, 140_000, 4),
          ("nc1300", 1300, 140_000, 4),
          ("trafalgar", 5288, 1_250_000, 4),
          ("global_atomics", 12_000, 140_000, 4)]
# the pcg_fast_pt options of scripts/bench_probe.py:100-127,219-220
FAST_PT = BAOptions(max_iterations=10, loss="huber", loss_scale=2.0,
                    function_tolerance=0.0, point_indices_sorted=True,
                    matvec_bf16=True, cg_eta=0.1, pallas_matvec=True,
                    pallas_transposed=True)
# pcg_fast_pblocks (scripts/bench_probe.py:86-88): make_blocks through
# the ba_blocks kernel as well
FAST_PBLOCKS = dataclasses.replace(FAST_PT, pallas_blocks=True)
BLOCKS_SOURCE = "theiasfm_tpu_torch/csrc/ba_blocks.cu"


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
        # pass 2's camera index, built once per solve in bundle_adjust
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
                u, wp = fm.pass1(*js, *ids, vc, vg, Np)
                yc, yg = fm.pass2(*js, *ids, u_ref, zp, Nc, cam_index)
                yc2, yg2 = fm.pass2(*js, *ids, u_ref, zp, Nc, cam_index)
                torch.cuda.synchronize()
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
                        lambda: fm.pass1(*js, *ids, vc, vg, Np),
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
    every shape: max |kernel - plain| <= 1e-4 max |plain| per output
    (atomics reorder the f32 sums); median ms of the kernel (L2 flushed
    before each call, and back to back) and of the plain version."""
    results = {}
    P = 1
    for shape, Nc, Np, opp in SHAPES:
        t0 = time.perf_counter()
        js, ids = _bench_jacobians(Nc, Np, opp)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        M = js[0].shape[0]
        ref = fm.blocks_plain(*js, *ids, Nc, Np)
        got = fm.blocks(*js, *ids, Nc, Np)
        torch.cuda.synchronize()
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
            setup_s=setup_s, camera_path=fm.blocks_camera_path(Nc, P),
            max_abs_err=max(e for e, _ in errs),
            rel_err=max(e / max(sc, 1e-30) for e, sc in errs),
            tol_rel=1e-4,
            ms=timer.ms(lambda: fm.blocks(*js, *ids, Nc, Np)),
            ms_back_to_back=timer.ms(lambda: fm.blocks(*js, *ids, Nc, Np),
                                     cold=False),
            plain_ms=timer.ms(lambda: fm.blocks_plain(*js, *ids, Nc, Np)),
            bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        emit("blocks_kernel", **rec)
        results[shape] = rec
        del js, ids, ref, got
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
    device's busy and idle share (device-side events only, so an op and
    its kernel are not counted twice), device time by kernel, and host
    and device time by the profiler ranges whose names start with
    `prefix`. Returns (fn's result, the summary)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, phases = {}, {}
    for ev in prof.events():
        if ev.name.startswith(prefix):
            if ev.device_type == DeviceType.CPU:
                ph = phases.setdefault(ev.name, [0.0, 0.0, 0])
                ph[0] += ev.cpu_time_total
                ph[1] += ev.device_time_total
                ph[2] += 1
        elif ev.device_type == DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time_total
            k[1] += 1
    busy_us = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return out, dict(
        wall_s=wall,
        device_busy_s=busy_us / 1e6 if kernels else "not measured",
        device_idle_share=(1 - busy_us / 1e6 / wall) if kernels
        else "not measured",
        phases={k: {"host_ms": c / 1e3, "device_ms": d / 1e3, "calls": n}
                for k, (c, d, n) in sorted(phases.items())},
        top=[{"kernel": k[:80], "device_ms": us / 1e3, "calls": n}
             for k, (us, n) in top])


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
# (name, pairs B, padded rows N, D, valid rows per pair lo..hi)
MATCH_SHAPES = [("frontend", 28, 2048, 128, 1400, 1600),
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
    return counts["top2_match"], pair_counts["top2_match"]


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
    n_batched, n_pair = phase_frontend()

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
    for name, shape, line, launches in (
            ("top2_match", "frontend", 120, n_batched),
            ("top2_match[B=1]", "unbatched_8192", 30, n_pair)):
        rec = mres[shape]
        summary.append(dict(
            name=name, route="cuda", source=MATCH_SOURCE,
            replaces=f"{MATCHER}:{line}", launches=launches,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            shape=f"{shape}: B={rec['B']} M=N={rec['N']} D={rec['D']}"))
    emit("done", seconds=time.perf_counter() - timer_start)
    print(json.dumps({"kernels": summary}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
