from .float_image import FloatImage, load_gray  # noqa: F401
from .sift import SiftOptions, extract_sift, extract_sift_batch  # noqa: F401
from .akaze import AkazeOptions, extract_akaze  # noqa: F401
from .synth import render_synthetic_views  # noqa: F401


def create_descriptor_extractor(descriptor_type: str = "SIFT",
                                density: str = "NORMAL", device="cuda"):
    """Factory over descriptor type x feature density (ref:
    image/descriptor/create_descriptor_extractor.h,
    DescriptorExtractorType{SIFT, AKAZE} x FeatureDensity), as the JAX
    package's. The extractor runs on `device` (the card by default; it
    raises without one, when called).

    Returns a callable image(H, W) -> (keypoints, descriptors, valid).
    """
    budget = {"SPARSE": 512, "NORMAL": 1024, "DENSE": 2048}[density]
    if descriptor_type.upper() == "SIFT":
        opts = SiftOptions(max_features_per_octave=budget)
        return lambda img: extract_sift(img, opts, device=device)
    if descriptor_type.upper() == "AKAZE":
        opts = AkazeOptions(max_features_per_octave=budget)
        return lambda img: extract_akaze(img, opts, device=device)
    raise ValueError(f"unknown descriptor type {descriptor_type}")
