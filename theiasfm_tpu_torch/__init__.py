"""theiasfm_tpu_torch — the PyTorch/CUDA port of theiasfm_tpu.

The JAX package `theiasfm_tpu` is the reference; this package mirrors
its module paths (`math/rotation.py`, `camera/models.py`, `sfm/ba/...`)
so each module's counterpart is found at the same place. It imports
`torch` and numpy, never `jax` or `theiasfm_tpu`.

Ported so far: the Schur-PCG bundle adjuster (`sfm/ba/`) and what it
needs. Its two Schur-matvec observation sweeps run as hand-written CUDA
kernels (`csrc/schur_matvec.cu`, built at first use by `_kernels.py`).

Entry points run on the device of the tensors they are given; the
constructors (`bench_problem.make_problem`, `convert.from_jax_arrays`)
default to `device="cuda"` and raise when no card is present.
"""

__version__ = "0.1.0"
