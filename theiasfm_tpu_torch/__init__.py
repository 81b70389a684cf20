"""theiasfm_tpu_torch — the PyTorch/CUDA port of theiasfm_tpu.

The JAX package `theiasfm_tpu` is the reference; this package mirrors
its module paths (`math/rotation.py`, `camera/models.py`, `sfm/ba/...`,
`image/sift.py`, `matching/...`) so each module's counterpart is found at
the same place. It imports `torch` and numpy, never `jax` or
`theiasfm_tpu`.

Ported so far:

* the Schur-PCG bundle adjuster (`sfm/ba/`) and what it needs. Its two
  Schur-matvec observation sweeps run as hand-written CUDA kernels
  (`csrc/schur_matvec.cu`);
* the feature front end: synthetic views and image loading (`image/`),
  SIFT (`image/sift.py`, plain PyTorch), the brute-force and fused top-2
  matchers, the features-and-matches database and the feature matcher
  without geometric verification (`matching/`). The fused matcher's
  running top-2 runs as a hand-written CUDA kernel
  (`csrc/top2_match.cu`).

The kernels are built at first use by `_kernels.py`. Entry points run
on the device of the tensors they are given; the constructors and entry
points that build their own tensors (`bench_problem.make_problem`,
`convert.from_jax_arrays`, `image.extract_sift[_batch]`,
`matching.FeatureMatcher`) default to `device="cuda"` and raise when no
card is present.
"""

__version__ = "0.2.0"
