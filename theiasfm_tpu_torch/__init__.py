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
  (`matching/`). The fused matcher's running top-2 runs as a
  hand-written CUDA kernel (`csrc/top2_match.cu`);
* geometric verification, which the feature matcher runs by default:
  the batched RANSAC engine (`solvers/`), the Aberth root finder
  (`math/polynomial.py`), the two-view minimal solvers (`sfm/pose/`:
  five-point, eight-point, homography), the two-view estimators
  (`sfm/estimators/`), triangulation, the visibility pyramid, guided
  matching (`matching/guided_matcher.py`) and the batched and
  single-pair verification (`sfm/pipeline/twoview.py`,
  `geometric_verification.py`), all in plain PyTorch;
* the rest of the bundle adjuster: the normal-equation blocks sweep as
  a hand-written CUDA kernel (`csrc/ba_blocks.cu`, `pallas_blocks`), the
  dense-Schur solver, the float64 polish, the reconstruction data model
  (`sfm/reconstruction.py`) with the reconstruction-level entry points
  (`sfm/ba/entry_points.py`), and the two-view refinements;
* from verified matches to a reconstruction, in plain PyTorch: the view
  graph and track builder, P3P (`sfm/pose/p3p.py`) and the calibrated
  absolute-pose estimator, localization, track estimation, the outlier
  filters and the incremental pipeline (`sfm/pipeline/`), Fisher-vector
  pair selection (`matching/fisher_vector.py`), the feature extractor
  and the ReconstructionBuilder, whose INCREMENTAL estimator runs;
* the global and hybrid pipelines (`sfm/global_pose/`,
  `sfm/pipeline/{global_pipeline,hybrid}.py`), the builder's GLOBAL and
  HYBRID estimators;
* the remaining pose solvers (`sfm/pose/`: seven-point, focal lengths
  from F, known rotation, DLT, EPnP, P4Pf, PnP with focal and radial
  distortion, UPnP/DLS, gDLS, the radial-distortion homography, the
  partial-rotation family), the uncalibrated and transform estimators
  (`sfm/estimators/`), EVSAC's weighted sampler (`solvers/evsac.py`) and
  `math/{gauss_jordan,probability}.py`; `solver_problems.py` makes
  seeded synthetic problems for them;
* AKAZE (`image/akaze.py`) and `image.create_descriptor_extractor`, the
  cascade hasher (`matching/cascade_hasher.py`, the feature matcher's
  `matcher="cascade_hashing"`), the L1 and box-QP solvers
  (`math/l1_solver.py`), `math/normalized_cut.py`, alignment and
  reconstruction transforms (`sfm/transformation.py`, `sfm/utils.py`),
  undistortion (`sfm/undistort.py`), the EXIF reader with its own copy
  of the sensor database (`sfm/exif_reader.py`, `data/`), GPS
  conversions (`sfm/gps_converter.py`) and `utils/{lru_cache,
  mutable_priority_queue}.py`, in plain PyTorch and numpy.

The kernels are built at first use by `_kernels.py`. Entry points run
on the device of the tensors they are given; the constructors and entry
points that build their own tensors (`bench_problem.make_problem`,
`convert.from_jax_arrays`, `image.extract_sift[_batch]`,
`matching.FeatureMatcher`, `Reconstruction.to_ba_problem`, the
`sfm.ba` entry points, the verification's and the incremental
pipeline's entry points in `sfm.pipeline`, the ReconstructionBuilder,
the Fisher-vector and feature extractors, `solver_problems.run_minimal`,
`image.extract_akaze`, `matching.CascadeHasher`, the L1/QP solvers given
arrays, `sfm.transformation.align_rotations`, the `sfm.undistort`
functions) default to `device="cuda"`
and raise when no card is present; the verification and the
localization also raise when their torch.Generator or sample indices
lie on another device.
"""

__version__ = "0.3.0"
