"""Convert Lowe SIFT key files between text and binary formats (port of
apps/convert_sift_key_file.py; host I/O only).

ref: applications/convert_sift_key_file.cc. The input is read as binary,
else as text; the output is binary when its name ends in .bin.

Usage:
  python -m theiasfm_tpu_torch.apps.convert_sift_key_file \\
      --input_sift_key_file view.key --output_sift_key_file view.bin
"""
from __future__ import annotations

import argparse
import sys

from ..io import (read_sift_binary, read_sift_text, write_sift_binary,
                  write_sift_text)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_sift_key_file", required=True)
    p.add_argument("--output_sift_key_file", required=True)
    args = p.parse_args(argv)

    src = args.input_sift_key_file
    dst = args.output_sift_key_file
    try:
        keypoints, descriptors = read_sift_binary(src)
    except Exception:
        keypoints, descriptors = read_sift_text(src)

    if dst.endswith(".bin"):
        write_sift_binary(dst, keypoints, descriptors)
    else:
        write_sift_text(dst, keypoints, descriptors)
    print(f"converted {len(keypoints)} keypoints: {src} -> {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
