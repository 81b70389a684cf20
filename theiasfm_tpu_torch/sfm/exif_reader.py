"""EXIF-based calibration priors (port of
theiasfm_tpu/sfm/exif_reader.py; host code, numpy and PIL).

ref: src/theia/sfm/exif_reader.{h,cc} — reads EXIF focal length (mm),
make/model, and GPS; converts to a pixel focal length via a
camera-sensor-width database
(focal_px = focal_mm / sensor_width_mm * image_width_px,
exif_reader.cc:94-218). Here EXIF comes from PIL; the sensor database
is pluggable: pass a file of lines "make model sensor_width_mm"
(compatible with the common public databases) or rely on the built-in
subset + the EXIF FocalPlaneXResolution fallback the reference also
uses.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .reconstruction import CameraIntrinsicsPrior

# the sensor-width database this package ships
SENSOR_DATABASE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "camera_sensor_database.txt")

# Small built-in subset of common sensors (mm). Extend via
# load_sensor_database(path).
_BUILTIN_SENSORS = {
    "canon eos 5d": 35.8, "canon eos 5d mark ii": 36.0,
    "canon eos 5d mark iii": 36.0, "canon eos 6d": 35.8,
    "canon eos 7d": 22.3, "canon eos rebel t3i": 22.3,
    "canon eos 400d digital": 22.2, "canon eos 20d": 22.5,
    "canon eos 30d": 22.5, "canon eos 40d": 22.2,
    "canon eos 50d": 22.3, "canon eos 60d": 22.3,
    "canon powershot g9": 7.6, "canon powershot s95": 7.6,
    "nikon d90": 23.6, "nikon d3000": 23.6, "nikon d3100": 23.1,
    "nikon d5100": 23.6, "nikon d700": 36.0, "nikon d750": 35.9,
    "nikon d80": 23.6, "nikon d70": 23.7, "nikon d200": 23.6,
    "nikon d300": 23.6, "nikon d7000": 23.6,
    "sony alpha 7": 35.8, "sony ilce-7m2": 35.8,
    "sony dsc-rx100": 13.2,
    "apple iphone 6": 4.8, "apple iphone 7": 4.8,
    "apple iphone 8": 4.8, "apple iphone x": 4.8,
    "samsung galaxy s7": 5.76,
}


class ExifReader:
    """ref: ExifReader (exif_reader.h)."""

    def __init__(self, sensor_database_path: Optional[str] = None):
        self.sensors: Dict[str, float] = dict(_BUILTIN_SENSORS)
        # The full database ships with this package (its own copy at
        # theiasfm_tpu_torch/data/, the role of the reference's
        # compiled-in data/camera_sensor_database.txt,
        # src/theia/CMakeLists.txt:50) and loads by default; an
        # explicit path or THEIASFM_SENSOR_DB overrides/extends it.
        packaged = SENSOR_DATABASE
        if os.path.exists(packaged):
            self.load_sensor_database(packaged)
        sensor_database_path = (sensor_database_path or
                                os.environ.get("THEIASFM_SENSOR_DB"))
        if sensor_database_path and os.path.exists(sensor_database_path):
            self.load_sensor_database(sensor_database_path)

    def load_sensor_database(self, path: str):
        """Two accepted line formats:
          "Make;Make Model;width_mm"  — the reference DB schema
            (exif_reader.cc LoadSensorWidthDatabase; the model field
            embeds the make and is the lookup key)
          "<make+model words> width_mm" — whitespace fallback
        Lines starting with '#' are comments."""
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if ";" in line:
                    parts = [p.strip() for p in line.split(";")]
                    if len(parts) != 3:
                        continue
                    try:
                        self.sensors[parts[1].lower()] = float(parts[2])
                    except ValueError:
                        continue
                else:
                    parts = line.split()
                    if len(parts) < 2:
                        continue
                    try:
                        width = float(parts[-1])
                    except ValueError:
                        continue
                    self.sensors[" ".join(parts[:-1]).lower()] = width

    def extract_exif_metadata(self, image_path: str
                              ) -> CameraIntrinsicsPrior:
        """ref: ExifReader::ExtractEXIFMetadata."""
        from PIL import ExifTags, Image

        prior = CameraIntrinsicsPrior()
        with Image.open(image_path) as img:
            prior.image_width, prior.image_height = img.size
            exif = img.getexif()
            if not exif:
                return prior
            tags = {ExifTags.TAGS.get(k, k): v for k, v in exif.items()}
            ifd = exif.get_ifd(0x8769) if hasattr(exif, "get_ifd") else {}
            tags.update({ExifTags.TAGS.get(k, k): v
                         for k, v in (ifd or {}).items()})

        focal_mm = tags.get("FocalLength")
        make = str(tags.get("Make", "")).strip().lower()
        model = str(tags.get("Model", "")).strip().lower()
        make_model = f"{make} {model}".strip()

        # 1) FocalPlane*Resolution path FIRST, exactly the reference's
        # SetFocalLengthFromExif (exif_reader.cc:206-264): the CCD
        # dimensions come from the ORIGINAL capture frame
        # (PixelX/YDimension — the stored image may be resized), the
        # focal is computed against the STORED width/height, and x/y
        # estimates are averaged.
        focal_px = None
        fpx = tags.get("FocalPlaneXResolution")
        fpy = tags.get("FocalPlaneYResolution")
        unit = tags.get("FocalPlaneResolutionUnit", 2)
        exif_w = tags.get("ExifImageWidth", prior.image_width)
        exif_h = tags.get("ExifImageHeight", prior.image_height)
        per_mm = {2: 25.4, 3: 10.0, 4: 1.0, 5: 0.001}.get(
            int(unit or 2))
        if focal_mm and fpx and fpy and per_mm and \
                float(fpx) > 0 and float(fpy) > 0:
            try:
                ccd_w = float(exif_w) / (float(fpx) / per_mm)
                ccd_h = float(exif_h) / (float(fpy) / per_mm)
                fx = float(focal_mm) * prior.image_width / ccd_w
                fy = float(focal_mm) * prior.image_height / ccd_h
                f = 0.5 * (fx + fy)
                if np.isfinite(f) and f > 0:
                    focal_px = f
            except (ZeroDivisionError, TypeError):
                focal_px = None

        # 2) sensor-width database fallback, exactly the reference's
        # SetFocalLengthFromSensorDatabase (exif_reader.cc:266-294):
        # model-only key first (DB models embed the make), then
        # "make model"; focal = max_image_dimension * f_mm / width.
        if focal_px is None:
            sensor_width = (self.sensors.get(model) or
                            self.sensors.get(make_model))
            if sensor_width is None and "/" in model:
                # spec-sheet composite names ("elph 135 / ixus 145"):
                # real EXIF carries one of the component names — try
                # each component against the DB
                for part in model.split("/"):
                    part = part.strip()
                    sensor_width = (self.sensors.get(part) or
                                    self.sensors.get(
                                        f"{make} {part}".strip()))
                    if sensor_width:
                        break
            if focal_mm and sensor_width:
                try:
                    f = (max(prior.image_width, prior.image_height) *
                         float(focal_mm) / sensor_width)
                    if np.isfinite(f) and f > 0:
                        focal_px = f
                except (TypeError, ZeroDivisionError):
                    pass

        if focal_px is not None:
            prior.focal_length = focal_px
        prior.principal_point = (prior.image_width / 2.0,
                                 prior.image_height / 2.0)

        # GPS (ref: gps priors wired into CameraIntrinsicsPrior)
        gps = None
        try:
            from PIL import Image
            with Image.open(image_path) as img:
                gps_ifd = img.getexif().get_ifd(0x8825)
            if gps_ifd:
                gps = _parse_gps(gps_ifd)
        except Exception:
            gps = None
        if gps is not None:
            prior.position = gps
        return prior


def _parse_gps(gps_ifd):
    def to_deg(vals, ref, neg):
        d = float(vals[0]) + float(vals[1]) / 60 + float(vals[2]) / 3600
        return -d if ref in neg else d

    try:
        lat = to_deg(gps_ifd[2], gps_ifd.get(1, "N"), ("S",))
        lon = to_deg(gps_ifd[4], gps_ifd.get(3, "E"), ("W",))
        alt = float(gps_ifd.get(6, 0.0))
        return np.asarray([lat, lon, alt])
    except (KeyError, TypeError, IndexError):
        return None


def lla_to_ecef(lat_deg, lon_deg, alt_m):
    """WGS-84 LLA -> ECEF. ref: src/theia/sfm/gps_converter.{h,cc}."""
    a = 6378137.0
    e2 = 6.69437999014e-3
    lat = np.radians(lat_deg)
    lon = np.radians(lon_deg)
    N = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    x = (N + alt_m) * np.cos(lat) * np.cos(lon)
    y = (N + alt_m) * np.cos(lat) * np.sin(lon)
    z = (N * (1 - e2) + alt_m) * np.sin(lat)
    return np.asarray([x, y, z])


def ecef_to_lla(x, y, z):
    """ECEF -> WGS-84 LLA (closed-form Bowring iteration-free approx +
    one refinement). ref: gps_converter.cc."""
    a = 6378137.0
    e2 = 6.69437999014e-3
    b = a * np.sqrt(1 - e2)
    ep2 = (a * a - b * b) / (b * b)
    p = np.hypot(x, y)
    th = np.arctan2(a * z, b * p)
    lon = np.arctan2(y, x)
    lat = np.arctan2(z + ep2 * b * np.sin(th) ** 3,
                     p - e2 * a * np.cos(th) ** 3)
    N = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - N
    return np.degrees(lat), np.degrees(lon), alt
