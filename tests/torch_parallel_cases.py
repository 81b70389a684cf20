"""Shared by the sharded-solver tests (tests/test_torch_parallel_*.py and
the sharded cases of the BA and global-pose tests): thread ranks on the
CPU, the JAX problems of tests/test_parallel.py handed to the port as
numpy arrays, and JAX's sharded runs on the 8-device CPU mesh that
tests/conftest.py sets up."""
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np

from theiasfm_tpu_torch.convert import from_jax_arrays, options_from_dict
from theiasfm_tpu_torch.parallel import run_ranks

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

# seconds for the gloo groups and for the wait on the ranks: a rank that
# fails or diverges fails its test instead of hanging the suite
TIMEOUT = 60.0


def run_threads(fn, n, *args):
    """fn(ranks, *args) on n thread ranks of this process (gloo groups
    over one HashStore); their results in rank order."""
    return run_ranks(fn, n, device="cpu", timeout=TIMEOUT, args=args)


def jax_problem(n_cams, n_pts, opp, dtype):
    from __graft_entry__ import _make_problem
    return _make_problem(n_cams=n_cams, n_pts=n_pts, obs_per_pt=opp,
                         dtype=dtype)


def to_port(jp):
    """A JAX BAProblem as the port's, on the CPU."""
    return from_jax_arrays({k: None if v is None else np.asarray(v)
                            for k, v in jp._asdict().items()}, device="cpu")


def port_opts(o):
    return options_from_dict(dataclasses.asdict(o))


def jax_mesh(n, axis_name="obs"):
    from theiasfm_tpu.parallel import make_mesh
    return make_mesh(jax.devices()[:n], axis_name=axis_name)


def jax_mesh_2d(rows, cols):
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:rows * cols]).reshape(rows, cols),
                ("dcn", "ici"))


def params(p):
    return [np.asarray(x) for x in (p.extrinsics, p.intrinsics, p.points)]


def assert_ranks_agree(results):
    """Every rank returned the same arrays, bit for bit."""
    first = results[0]
    for r, other in enumerate(results[1:], 1):
        for a, b in zip(first, other):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"rank {r} differs")

