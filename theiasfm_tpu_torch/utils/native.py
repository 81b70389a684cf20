"""ctypes bindings to the native host-ops library (port of
theiasfm_tpu/utils/native.py).

The C++ sources are the repo's `native/host_ops.cc` (union-find
connected components, MFAS orderings, Kruskal MST) and
`native/theia_io.cc` (the Theia cereal-binary reader). `get_lib()`
compiles both with the host C++ compiler into one shared library under
`theiasfm_tpu_torch/_build/` at first use, never at import and never
into `native/`; the library's file name carries a hash of the sources
and the flags, so an edited source is rebuilt and an unchanged one is
reused. A failed build raises with the compiler's output: there is no
quiet fallback to the numpy routines.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
SOURCES = ("host_ops.cc", "theia_io.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(
            "no C++ compiler found ($CXX, g++ or c++ on PATH): the native "
            "host ops of theiasfm_tpu_torch are built at first use")
    return cxx


def _target(srcs) -> Path:
    h = hashlib.sha256()
    for src in srcs:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhost_ops_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/{host_ops,theia_io}.cc if the library is stale and
    return its path; raises RuntimeError with the compiler's output when
    the sources are missing or the build fails."""
    srcs = [NATIVE_DIR / s for s in SOURCES]
    missing = [str(s) for s in srcs if not s.exists()]
    if missing:
        raise RuntimeError(f"native sources not found: {missing}")
    out = _target(srcs)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp),
                           *map(str, srcs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native host ops failed:\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return out


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The loaded native library, built if needed, with every entry
    point's argtypes and restype set."""
    lib = ctypes.CDLL(str(build()))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.uf_connected_components.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.uf_connected_components.restype = None
    lib.mfas_order.argtypes = [i64p, i64p, f64p, ctypes.c_int64,
                               ctypes.c_int64, i64p]
    lib.mfas_order.restype = None
    lib.kruskal_mst.argtypes = [i64p, i64p, f64p, ctypes.c_int64,
                                ctypes.c_int64, i64p]
    lib.kruskal_mst.restype = ctypes.c_int64

    # theia cereal-binary reader (theia_io.cc)
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.theia_read.argtypes = [ctypes.c_char_p]
    lib.theia_read.restype = ctypes.c_void_p
    lib.theia_recon_free.argtypes = [ctypes.c_void_p]
    lib.theia_recon_free.restype = None
    for fn in ("theia_num_views", "theia_num_tracks", "theia_num_obs",
               "theia_names_size"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int64
    lib.theia_get_views.argtypes = [
        ctypes.c_void_p, u32p, u8p, i32p, f64p, f64p, i32p, u32p]
    lib.theia_get_names.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64p]
    lib.theia_get_priors.argtypes = [
        ctypes.c_void_p, i32p, i32p, u8p, f64p]
    lib.theia_get_tracks.argtypes = [
        ctypes.c_void_p, u32p, u8p, f64p, u8p]
    lib.theia_get_obs.argtypes = [ctypes.c_void_p, u32p, u32p, f64p]
    for fn in ("theia_get_views", "theia_get_names", "theia_get_priors",
               "theia_get_tracks", "theia_get_obs"):
        getattr(lib, fn).restype = None
    return lib


def connected_components_native(num_nodes: int, edges_a, edges_b
                                ) -> np.ndarray:
    a = np.ascontiguousarray(edges_a, np.int64)
    b = np.ascontiguousarray(edges_b, np.int64)
    out = np.empty(num_nodes, np.int64)
    get_lib().uf_connected_components(a, b, len(a), num_nodes, out)
    return out


def mfas_order_native(num_nodes: int, arcs_i, arcs_j, arc_w
                      ) -> np.ndarray:
    i = np.ascontiguousarray(arcs_i, np.int64)
    j = np.ascontiguousarray(arcs_j, np.int64)
    w = np.ascontiguousarray(arc_w, np.float64)
    out = np.empty(num_nodes, np.int64)
    get_lib().mfas_order(i, j, w, len(i), num_nodes, out)
    return out


def kruskal_mst_native(num_nodes: int, edges, weights) -> np.ndarray:
    e = np.ascontiguousarray(edges, np.int64)
    w = np.ascontiguousarray(weights, np.float64)
    out = np.empty(len(e), np.int64)
    n = get_lib().kruskal_mst(np.ascontiguousarray(e[:, 0]),
                              np.ascontiguousarray(e[:, 1]), w, len(e),
                              num_nodes, out)
    return out[:n]
