"""Build and load the port's CUDA kernels at first use.

Every `csrc/*.cu` source is compiled by `nvcc` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), all sources in parallel, into `theiasfm_tpu_torch/_build/`.
Each library's file name carries a hash of its source and the compiler
flags, so an edited source is rebuilt and an unchanged one is reused.
The libraries are loaded with ctypes; pointers and the stream travel as
`c_void_p`.

Importing this module touches neither `nvcc` nor CUDA: only `library()`
does, and only the CUDA wrappers call it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_STRIDES = [_LL] * 6
_SIGNATURES = {"ba_blocks": {
    # jc, ji, jp, r, 8 strides, rows, pt_order, pt_start, cam_order,
    # cam_start, g_work, pt, cam, x, y, M, P, Np, Nc, stream
    "ba_blocks_f32": [_P] * 4 + [_LL] * 8 + [_I] + [_P] * 9 +
    [_LL, _I, _I, _I, _P],
}, "schur_matvec": {
    # jc, ji, jp, 6 strides, layout, obs_cam, pt_order, pt_start, vc, vg,
    # u, wp, M, P, Np, stream
    "schur_pass1_f32": [_P, _P, _P] + _STRIDES + [_I] + [_P] * 7 +
    [_LL, _I, _I, _P],
    "schur_pass1_bf16": [_P, _P, _P] + _STRIDES + [_I] + [_P] * 7 +
    [_LL, _I, _I, _P],
    # jc, ji, jp, 6 strides, obs_pt, u, zp, cam_order, cam_start, y_work,
    # g_work, yc, yg, M, P, Nc, part_blocks, stream
    "schur_pass2_f32": [_P, _P, _P] + _STRIDES + [_P] * 9 +
    [_LL, _I, _I, _I, _P],
    "schur_pass2_bf16": [_P, _P, _P] + _STRIDES + [_P] * 9 +
    [_LL, _I, _I, _I, _P],
}, "top2_match": {
    # d1, d2, n2, best, second, idx, B, M, N, D, stream
    "top2_match_f32": [_P] * 6 + [_I] * 4 + [_P],
}}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of theiasfm_tpu_torch are built at first use")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


@functools.cache
def build() -> dict:
    """Compile every stale source (in parallel) and return
    {source stem: {"path", "seconds", "ptxas"}} for all sources."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for src in sorted(SRC_DIR.glob("*.cu")):
        out = _target(src)
        if out.exists():
            jobs[src.stem] = (out, None, None)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[src.stem] = (out, tmp, proc)
    info = {}
    for stem, (out, tmp, proc) in jobs.items():
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {stem}.cu:\n{log}")
            os.replace(tmp, out)
        info[stem] = {"path": str(out),
                      "seconds": time.perf_counter() - t0,
                      "ptxas": log}
    return info


@functools.cache
def library(stem: str = "schur_matvec") -> ctypes.CDLL:
    """The loaded shared library of csrc/<stem>.cu, built if needed,
    with argtypes/restype set for every entry point."""
    lib = ctypes.CDLL(build()[stem]["path"])
    for name, argtypes in _SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib
