"""The port's partial-rotation (known axis) solvers against the JAX
package's, in float64 on the CPU, on the numpy-seeded problems of
theiasfm_tpu_torch/solver_problems.py.

The two-point pose solves a quadratic in closed form: solutions and
validity agree with JAX's to 1e-9. The three-point, four-point and
similarity solvers find the roots of a quadratic eigenproblem's
characteristic polynomial with 100 Aberth iterations, so they are held
by solution-set membership: the valid counts agree on 95% of problems;
every valid JAX solution has a valid port solution within 1e-4
relative on 95% of problems (three- and four-point) or 75% (the
similarity, whose degree-10 polynomial clusters roots); JAX recovers
the truth (within 1e-4) on 90% of problems and the port within 0.05
of JAX's share. In float32 the share of
problems the port solves on the CPU (within 1e-3) is held to no less than
JAX's float32 share less 0.1.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu_torch import solver_problems as sp

from torch_sfm_cases import one_torch_thread  # noqa: F401

jpr = importlib.import_module("theiasfm_tpu.sfm.pose.partial_rotation")
tpr = importlib.import_module("theiasfm_tpu_torch.sfm.pose.partial_rotation")

SOLVERS = {
    "two_point": ("two_point_pose_partial_rotation",
                  ("axis", "model_points", "image_rays")),
    "three_point": ("three_point_relative_pose_partial_rotation",
                    ("axis", "rays1", "rays2")),
    "four_point": ("four_point_relative_pose_partial_rotation",
                   ("axis", "dirs1", "origins1", "dirs2", "origins2")),
    "sim": ("sim_transform_partial_rotation",
            ("axis", "dirs1", "origins1", "dirs2", "origins2")),
}


def _flat(out, kind):
    """Solutions as (B, S, 12 or 13) [R, t(, s)] and validity (B, S)."""
    out = [np.asarray(o, np.float64) for o in out]
    R, t, valid = out[0], out[1], out[-1]
    parts = [R.reshape(R.shape[:-2] + (9,)), t]
    if kind == "sim":
        parts.append(out[2][..., None])
    return np.concatenate(parts, -1), valid > 0


def _truth(p, kind):
    B = len(p["R"])
    parts = [p["R"].reshape(B, 9), p["t"]]
    if kind == "sim":
        parts.append(p["s"][:, None])
    return np.concatenate(parts, -1)


def _run(kind, p, dtype):
    name, keys = SOLVERS[kind]
    jout = jax.vmap(getattr(jpr, name))(
        *(jnp.asarray(p[k], dtype) for k in keys))
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    tout = getattr(tpr, name)(*(torch.as_tensor(p[k], dtype=tdt)
                                for k in keys))
    return _flat(jout, kind), _flat(tout, kind)


def _recovered(sol, valid, truth, tol):
    err = np.abs(sol - truth[:, None]).max(-1)
    return np.any(valid & (err < tol), -1)


# share of problems on which every valid JAX solution has a valid port
# solution within 1e-4 relative (seeds 0-2, 48 problems each, read
# 0.98-1.0 three-point, 0.96-0.98 four-point, 0.81-0.88 similarity:
# its degree-10 polynomial clusters roots, which Aberth resolves to
# about the square root of the rounding)
CONTAINED_MIN = {"three_point": 0.95, "four_point": 0.95, "sim": 0.75}


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_matches_jax_float64(kind):
    p = sp.partial_rotation_problems(np.random.default_rng(0), 48, kind)
    (js, jv), (ts, tv) = _run(kind, p, jnp.float64)
    truth = _truth(p, kind)
    if kind == "two_point":
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_allclose(ts[tv], js[jv], rtol=0, atol=1e-9)
    else:
        assert np.mean(tv.sum(-1) == jv.sum(-1)) >= 0.95
        contained = [all(np.any(tv[b] & (
            np.abs(ts[b] - js[b, s]).max(-1) /
            max(1.0, np.abs(js[b, s]).max()) < 1e-4))
            for s in np.nonzero(jv[b])[0]) for b in range(len(jv))]
        assert np.mean(contained) >= CONTAINED_MIN[kind], np.mean(contained)
    jr = _recovered(js, jv, truth, 1e-4)
    tr = _recovered(ts, tv, truth, 1e-4)
    assert jr.mean() >= 0.9 and abs(tr.mean() - jr.mean()) <= 0.05, (
        tr.mean(), jr.mean())


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_float32_share_holds_to_jax(kind):
    p = sp.partial_rotation_problems(np.random.default_rng(1), 48, kind)
    (js, jv), (ts, tv) = _run(kind, p, jnp.float32)
    truth = _truth(p, kind)
    scale = np.maximum(1.0, np.abs(truth).max(-1, keepdims=True))
    jr = _recovered(js / scale[:, None], jv, truth / scale, 1e-3)
    tr = _recovered(ts / scale[:, None], tv, truth / scale, 1e-3)
    assert tr.mean() >= jr.mean() - 0.1, (tr.mean(), jr.mean())
