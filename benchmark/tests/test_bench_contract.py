"""A run's last lines: the result's keys, the compared numbers last, the
cell's end-to-end metrics with their units."""
from __future__ import annotations

import io
import json

from benchmark import run

SEED = 2**33 + 5


def test_last_line_contract(tiny_bench):
    w = "bal_final13682.per_camera_calib"
    res = run.run_cell(w, SEED, 0.1, False, device="cpu", bench=tiny_bench)
    out, err = io.StringIO(), io.StringIO()
    run.report(res, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line
    assert list(line)[-1] == "compared"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and 0 <= line["failed"] <= line["attempted"]
    want = {m["name"]: m["unit"] for m in tiny_bench.end_to_end(w)}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in line["device"]
    tail = err.getvalue().strip().splitlines()
    assert len(tail) == len(line["compared"])
    for (name, v), text in zip(line["compared"].items(), tail):
        assert text.startswith(f"{name} ") and " limit " in text


def test_forbidden_modules_compare_top_level_names(monkeypatch):
    import sys
    import types
    for name in ("theiasfm_tpu_torch.fake", "jax_like_name", "jaxfoo"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "theiasfm_tpu.sfm",
                        types.ModuleType("theiasfm_tpu.sfm"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.forbidden_modules() == ["jaxlib", "theiasfm_tpu.sfm"]
