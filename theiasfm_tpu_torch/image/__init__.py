from .float_image import FloatImage, load_gray  # noqa: F401
from .sift import SiftOptions, extract_sift, extract_sift_batch  # noqa: F401
from .synth import render_synthetic_views  # noqa: F401
