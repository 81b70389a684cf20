#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (theiasfm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (nvcc, at first use), holds each kernel
against its plain PyTorch version on the card, runs the bundle adjuster's
main path (the Schur-PCG LM solve at the 1DSfM Notre-Dame scale: 550
cameras, 140k points, 560k observations, the `pcg_fast_pt` options of
scripts/bench_probe.py) and the bucketed entry point, and checks the
results. Every phase prints one JSON line; any failure raises, and the
script exits non-zero without printing a result. It imports neither JAX
nor the JAX package. Without a CUDA device it fails at once.

The last three lines are the `kernels` summary (one entry per replaced
TPU kernel: launches on its path, error against the plain version, its
time, the plain version's time and the bound), the card's name and power
limit from nvidia-smi, and {"ok": true, "device": {...}}.
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
from theiasfm_tpu_torch.sfm.ba import BAOptions, bundle_adjust
from theiasfm_tpu_torch.sfm.ba import bundle_adjustment as ba
from theiasfm_tpu_torch.sfm.ba import fused_matvec as fm
from theiasfm_tpu_torch.utils import dispatch_counts, reset_dispatch_counts

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and the f32
# rate outside the tensor cores (the kernels multiply in f32)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SOURCE = "theiasfm_tpu_torch/csrc/schur_matvec.cu"
PALLAS = "theiasfm_tpu/sfm/ba/pallas_matvec.py"
# (kernel, layout) -> the TPU kernel it replaces
REPLACES = {("schur_pass1", "t"): f"{PALLAS}:259",
            ("schur_pass2", "t"): f"{PALLAS}:333",
            ("schur_pass1", "row"): f"{PALLAS}:147",
            ("schur_pass2", "row"): f"{PALLAS}:203"}
# max |kernel - plain| <= TOL * max|plain|: atomics reorder the f32
# sums; under bf16 a rounded intermediate (d = u - Jp·zp) may land one
# bf16 ulp apart when the two sum Jp·zp in another order
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
    zeroing keeps the card busy while the host enqueues the call: the
    events then time the device's work alone. Without it the calls run
    back to back, and where the host takes longer to enqueue a call than
    the card to run it, the events time the host."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

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
    _kernels.library()
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
        cam_path = fm.pass2_camera_path(Nc, P)
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
                yc, yg = fm.pass2(*js, *ids, u_ref, zp, Nc)
                torch.cuda.synchronize()
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
                        lambda: fm.pass2(*js, *ids, u_ref, zp, Nc),
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
                    if name == "schur_pass2":
                        rec["camera_path"] = cam_path
                    emit("kernels", **rec)
                    results[(name, shape, rec["dtype"], layout)] = rec
        del jac32, ids, vc, zp, u_ref, wp_ref, yc_ref, yg_ref
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


def _profile(prob, opts):
    """Over one short solve (torch.profiler, CPU and CUDA activity): the
    device's busy and idle share (device-side events only, so an op and
    its kernel are not counted twice), device time by kernel, and host
    and device time by solver phase (the "ba.*" ranges of
    bundle_adjust)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, s = bundle_adjust(prob, opts)
        float(s.final_cost)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, phases = {}, {}
    for ev in prof.events():
        if ev.name.startswith("ba."):
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
    return dict(
        iterations=s.num_iterations, wall_s=wall,
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

    emit("ba_profile", config="pcg_fast_pt",
         **_profile(prob, dataclasses.replace(FAST_PT, max_iterations=3)))
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
    runs = phase_ba_main()
    phase_bucketed()

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
    emit("done", seconds=time.perf_counter() - timer_start)
    print(json.dumps({"kernels": summary}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
