"""Image loading / float image wrapper (port of
theiasfm_tpu/image/float_image.py; `from_file` also converts to a PIL
mode and tests the decoded dtype, the one decoder of the CLIs).

ref: src/theia/image/image.h:51-110 (FloatImage over OpenImageIO).
Host-side decode via PIL, imported inside the functions so that
importing the package never needs it; pixels live as numpy float
arrays in [0, 1], grayscale conversion with the same luminance weights.
"""
from __future__ import annotations

import numpy as np


class FloatImage:
    """Minimal host-side image: float32 [0,1], HxW (gray) or HxWx3."""

    def __init__(self, pixels: np.ndarray):
        self.pixels = np.asarray(pixels, np.float32)

    @classmethod
    def from_file(cls, path: str, mode: str | None = None) -> "FloatImage":
        """Decode `path`, converted to the PIL `mode` first when one is
        given ("RGB" for colour pixels whatever the file holds). 8-bit
        pixels scale to [0, 1]: the test is on the decoded dtype, as
        the JAX module's `arr.dtype == np.uint8` meant (it tests the
        float32 copy, so an 8-bit image of 0s and 1s stays unscaled
        there)."""
        from PIL import Image
        img = Image.open(path)
        if mode is not None:
            img = img.convert(mode)
        raw = np.asarray(img)
        arr = raw.astype(np.float32)
        if raw.dtype == np.uint8 or arr.max() > 1.5:
            arr = arr / 255.0
        return cls(arr)

    @property
    def width(self):
        return self.pixels.shape[1]

    @property
    def height(self):
        return self.pixels.shape[0]

    def grayscale(self) -> np.ndarray:
        p = self.pixels
        if p.ndim == 2:
            return p
        # ref uses OIIO's luminance conversion (Rec. 709)
        return (0.2126 * p[..., 0] + 0.7152 * p[..., 1] +
                0.0722 * p[..., 2]).astype(np.float32)


def load_gray(path: str) -> np.ndarray:
    return FloatImage.from_file(path).grayscale()


def image_size_from_file(path: str) -> tuple:
    """(width, height) without decoding pixel data (header read only)."""
    from PIL import Image
    with Image.open(path) as img:
        return img.size
