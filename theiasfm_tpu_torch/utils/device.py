"""Where the port's entry points put their tensors, and at what float32
precision the card computes them."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """The device to build tensors on; a CUDA device without a card
    raises (there is no silent CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return device


@contextlib.contextmanager
def full_f32():
    """Run float32 matrix products and convolutions in full float32.

    On the card cuDNN runs float32 convolutions in TF32 by default
    (`torch.backends.cudnn.allow_tf32`), and a caller may have turned
    TF32 on for matrix products too. TF32 keeps about three decimal
    digits, enough to flip SIFT's extrema and thresholds and the
    matcher's ratio test, so the front end turns both off while it runs
    and restores the caller's settings after. On the CPU both flags are
    ignored."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
