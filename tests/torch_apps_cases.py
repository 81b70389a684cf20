"""Shared helpers of the CLI tests (tests/test_torch_apps_*.py): run a
CLI of the JAX package (apps/<name>.py, loaded from its file with
sys.argv patched) or of the port (theiasfm_tpu_torch.apps.<name>.main)
in process, capture what it prints, and compare two printouts number by
number."""
import contextlib
import importlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
# host float64 arithmetic in both packages; float32 device work
HOST_REL = 1e-9
DEVICE_REL = 1e-4


def jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_apps_{name}", REPO / "apps" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(name, argv, monkeypatch):
    """(return code, stdout) of apps/<name>.py's main() on argv."""
    mod = jax_cli(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, argv)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main()
    return rc, out.getvalue()


def port_cli(name):
    return importlib.import_module(f"theiasfm_tpu_torch.apps.{name}")


def run_port(name, argv):
    """(return code, stdout) of theiasfm_tpu_torch.apps.<name>.main."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_cli(name).main([str(a) for a in argv])
    return rc, out.getvalue()


def assert_same_printout(got, want, rel, last_digit=False, subs=()):
    """Two printouts with the same text between their numbers (runs of
    whitespace compared as one space: numpy pads arrays by the width of
    their numbers) and each pair of numbers within `rel` relative (to
    1 below magnitude 1, as tests/test_torch_io.assert_text_agrees). With
    `last_digit`, one unit in the last printed place more: two values
    within `rel` can round to neighbouring printed values. `subs` are
    (old, new) replacements made in both first (output paths)."""
    for old, new in subs:
        got, want = got.replace(old, new), want.replace(old, new)

    def text(s):
        return [" ".join(p.split()) for p in NUMBER.split(s)]
    assert text(got) == text(want), (got, want)
    for x, y in zip(NUMBER.findall(got), NUMBER.findall(want)):
        a, b = float(x), float(y)
        unit = 0.0
        if last_digit and "." in x and "e" not in x.lower():
            unit = 10.0 ** -len(x.split(".")[1])
        assert abs(a - b) <= rel * max(1.0, abs(a), abs(b)) + \
            unit * 1.000001, (x, y, got, want)


def render_views(n, size=(200, 150), focal=190.0, seed=0):
    """n renderings of image/synth.py's scene (the pattern of
    tests/test_torch_apps.py), and their cameras."""
    from theiasfm_tpu_torch.image import render_synthetic_views
    rng = np.random.default_rng(seed)
    return render_synthetic_views(rng.random((256, 256)), n, size,
                                  focal=focal)
