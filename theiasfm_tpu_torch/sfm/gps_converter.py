"""WGS-84 geodetic <-> ECEF coordinate conversion (a numpy copy of
theiasfm_tpu/sfm/gps_converter.py).

ref: src/theia/sfm/gps_converter.{h,cc} (GPSConverter::LLAToECEF /
ECEFToLLA, which uses Olson's closed-form method, IEEE Trans. Aerosp.
Electron. Syst. 1996). Batched numpy implementation: both directions
accept (..., 3) arrays; LLA is (latitude deg, longitude deg,
altitude m).
"""
from __future__ import annotations

import numpy as np

# WGS-84 constants (same model as the reference, gps_converter.cc:44-60)
_A = 6378137.0                # semi-major axis
_E2 = 6.6943799901377997e-3   # first eccentricity squared
_A1 = _A * _E2
_A2 = _A1 * _A1
_A3 = _A1 * _E2 / 2.0
_A4 = 2.5 * _A2
_A5 = _A1 + _A3
_A6 = 1.0 - _E2


def lla_to_ecef(lla):
    """(lat deg, lon deg, alt m) -> ECEF (x, y, z) meters."""
    lla = np.asarray(lla, dtype=np.float64)
    lat = np.deg2rad(lla[..., 0])
    lon = np.deg2rad(lla[..., 1])
    alt = lla[..., 2]
    s = np.sin(lat)
    n = _A / np.sqrt(1.0 - _E2 * s * s)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = (n * _A6 + alt) * s
    return np.stack([x, y, z], axis=-1)


def ecef_to_lla(ecef):
    """ECEF (x, y, z) meters -> (lat deg, lon deg, alt m), Olson's
    closed-form method (accurate to ~1e-9 m for terrestrial points)."""
    ecef = np.asarray(ecef, dtype=np.float64)
    x, y, z = ecef[..., 0], ecef[..., 1], ecef[..., 2]
    zp = np.abs(z)
    w2 = x * x + y * y
    w = np.sqrt(w2)
    r2 = w2 + z * z
    r = np.sqrt(r2)
    lon = np.arctan2(y, x)
    s2 = z * z / np.maximum(r2, 1e-30)
    c2 = w2 / np.maximum(r2, 1e-30)
    u = _A2 / r
    v = _A3 - _A4 / r
    # near-equator branch (c2 > 0.3) keeps asin well-conditioned,
    # polar branch uses acos
    s_eq = (zp / r) * (1.0 + c2 * (_A1 + u + s2 * v) / r)
    lat_eq = np.arcsin(np.clip(s_eq, -1.0, 1.0))
    c_eq = np.sqrt(np.maximum(1.0 - s_eq * s_eq, 0.0))
    c_po = (w / r) * (1.0 - s2 * (_A5 - u - c2 * v) / r)
    lat_po = np.arccos(np.clip(c_po, -1.0, 1.0))
    s_po = np.sqrt(np.maximum(1.0 - c_po * c_po, 0.0))
    eq = c2 > 0.3
    s = np.where(eq, s_eq, s_po)
    c = np.where(eq, c_eq, c_po)
    lat = np.where(eq, lat_eq, lat_po)
    ss = s * s
    g = 1.0 - _E2 * ss
    rg = _A / np.sqrt(g)
    rf = _A6 * rg
    u = w - rg * c
    v = zp - rf * s
    f = c * u + s * v
    m = c * v - s * u
    p = m / (rf / g + f)
    lat = lat + p
    alt = f + m * p / 2.0
    lat = np.where(z < 0.0, -lat, lat)
    return np.stack([np.rad2deg(lat), np.rad2deg(lon), alt], axis=-1)
