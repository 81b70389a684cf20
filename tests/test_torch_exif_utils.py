"""The port's host utilities against the JAX package's, on the CPU:
sfm/exif_reader.py (with the port's own copy of the sensor database),
sfm/gps_converter.py, utils/lru_cache.py and
utils/mutable_priority_queue.py. All are host code (numpy, PIL imported
inside the EXIF reader); the results are equal, the GPS conversions to
1e-12 relative (the same numpy expressions; measured equal)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from theiasfm_tpu.sfm import exif_reader as jexif
from theiasfm_tpu.sfm import gps_converter as jgps
from theiasfm_tpu.utils.lru_cache import LRUCache as JLRU
from theiasfm_tpu.utils import MutablePriorityQueue as JMPQ
from theiasfm_tpu_torch.sfm import exif_reader as texif
from theiasfm_tpu_torch.sfm import gps_converter as tgps
from theiasfm_tpu_torch.utils import LRUCache, MutablePriorityQueue
from theiasfm_tpu_torch.utils.lru_cache import ImageCache

REPO = Path(__file__).resolve().parents[1]


def test_sensor_database_is_the_port_own_copy_and_equal():
    """The port reads its own file (the same bytes as JAX's) and holds
    the same entries."""
    path = Path(texif.SENSOR_DATABASE)
    assert path.is_file() and path.parent.parent.name == "theiasfm_tpu_torch"
    assert path.read_bytes() == (REPO / "theiasfm_tpu" / "data" /
                                 "camera_sensor_database.txt").read_bytes()
    ours, theirs = texif.ExifReader().sensors, jexif.ExifReader().sensors
    assert ours == theirs and len(ours) >= 3000
    assert abs(ours["canon powershot a80"] - 7.11) < 1e-6


def _exif_jpeg(path, make="Canon", model="Canon PowerShot A80",
               focal_mm=7.8, plane=None, gps=None):
    """A 400 x 300 JPEG with Make/Model and an Exif IFD FocalLength, as
    tests/test_exif.py builds one; `plane` adds FocalPlane X/Y
    resolution (pixels per inch), `gps` a GPS IFD."""
    from PIL import Image
    Image.new("RGB", (400, 300)).save(path)
    with Image.open(path) as im:
        ex = im.getexif()
        ex[271] = make
        ex[272] = model
        ifd = ex.get_ifd(0x8769)
        ifd[0x920A] = focal_mm
        if plane:
            ifd[0xA20E], ifd[0xA20F], ifd[0xA210] = plane, plane, 2
        if gps:
            g = ex.get_ifd(0x8825)
            g.update(gps)
        im.save(path, exif=ex)


@pytest.mark.parametrize("kind", ["database", "focal_plane", "unknown",
                                  "gps"])
def test_extract_exif_metadata_matches_jax(kind, tmp_path):
    path = str(tmp_path / "t.jpg")
    kw = dict(database={}, focal_plane=dict(plane=3000.0),
              unknown=dict(make="Acme", model="Nothing 1"),
              gps=dict(gps={1: "S", 2: (33.0, 52.0, 31.66), 3: "W",
                            4: (116.0, 18.0, 5.83), 6: 304.0}))[kind]
    _exif_jpeg(path, **kw)
    ours = texif.ExifReader().extract_exif_metadata(path)
    theirs = jexif.ExifReader().extract_exif_metadata(path)
    assert type(ours).__module__.startswith("theiasfm_tpu_torch")
    for f in ("image_width", "image_height", "focal_length",
              "principal_point"):
        assert getattr(ours, f) == getattr(theirs, f), f
    if kind == "database":
        assert abs(ours.focal_length - 400 * 7.8 / 7.11) < 1e-3
    if kind == "unknown":
        assert ours.focal_length is None
    if kind == "gps":
        np.testing.assert_array_equal(ours.position, theirs.position)
        assert ours.position[0] < 0 and ours.position[1] < 0
    else:
        assert ours.position is None and theirs.position is None


def test_gps_converter_matches_jax(rng):
    lla = np.stack([rng.uniform(-89.9, 89.9, 50), rng.uniform(-180, 180, 50),
                    rng.uniform(-100, 5000, 50)], -1)
    lla[0] = (0.0, 0.0, 0.0)
    lla[1] = (89.9, 45.0, 1000.0)         # near the pole: the acos branch
    ecef = tgps.lla_to_ecef(lla)
    np.testing.assert_allclose(ecef, jgps.lla_to_ecef(lla), rtol=1e-12)
    back = tgps.ecef_to_lla(ecef)
    np.testing.assert_allclose(back, jgps.ecef_to_lla(ecef), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(back[:, :2], lla[:, :2], atol=1e-9)
    np.testing.assert_allclose(back[:, 2], lla[:, 2], atol=1e-6)
    # the EXIF reader's own pair, scalar form (ref gps_converter_test.cc)
    for row in lla[:10]:
        xyz = texif.lla_to_ecef(*row)
        np.testing.assert_allclose(xyz, jexif.lla_to_ecef(*row), rtol=1e-12)
        np.testing.assert_allclose(texif.ecef_to_lla(*xyz), row, atol=1e-6)


def test_lru_cache_matches_jax():
    """The same hits, misses and evictions on the same key stream."""
    stream = [1, 2, 3, 1, 4, 5, 2, 1, 6, 3, 3, 7, 1]
    out = []
    for cls in (LRUCache, JLRU):
        fetched = []
        c = cls(lambda k: fetched.append(k) or k * 10, max_entries=3)
        vals = [c.fetch(k) for k in stream]
        c.insert(9, 90)
        out.append((vals, fetched, c.hits, c.misses, len(c),
                    [c.contains(k) for k in range(10)]))
    assert out[0] == out[1]
    assert out[0][0] == [k * 10 for k in stream]


def test_image_cache_reads_through_the_port(tmp_path):
    from PIL import Image
    Image.fromarray(np.full((6, 8), 255, np.uint8)).save(tmp_path / "a.png")
    cache = ImageCache(str(tmp_path), max_images=1)
    img = cache.fetch_image("a.png")
    assert type(img).__module__ == "theiasfm_tpu_torch.image.float_image"
    assert img.pixels.shape == (6, 8) and img.pixels.max() == 1.0
    assert cache.fetch_image("a.png") is img and cache._cache.hits == 1


def test_mutable_priority_queue_matches_jax():
    """tests/test_util_extras.py's sequence, then a longer random one,
    in both packages."""
    q = MutablePriorityQueue()
    q.insert("a", 5)
    q.insert("b", 3)
    q.insert("c", 9)
    assert len(q) == 3 and "b" in q and q.top() == ("b", 3)
    q.update("c", 1)
    assert q.pop() == ("c", 1)
    q.remove("a")
    assert q.pop() == ("b", 3) and len(q) == 0
    g = np.random.default_rng(0)
    ops = [(int(g.integers(3)), int(g.integers(20)), int(g.integers(100)))
           for _ in range(300)]
    logs = []
    for cls in (MutablePriorityQueue, JMPQ):
        q, log = cls(), []
        for op, k, v in ops:
            if op == 0 or k not in q:
                q.insert(k, v)
            elif op == 1:
                q.update(k, v)
            else:
                log.append(q.pop())
        while len(q):
            log.append(q.pop())
        logs.append(log)
    assert logs[0] == logs[1]


def test_host_utilities_import_without_pil():
    """importing the package (and the EXIF reader) needs no PIL: the
    card's machine lists none."""
    code = textwrap.dedent("""
        import sys
        for name in ("PIL", "jax", "jaxlib", "theiasfm_tpu"):
            sys.modules[name] = None
        import theiasfm_tpu_torch.sfm.exif_reader as e
        from theiasfm_tpu_torch.utils import LRUCache, MutablePriorityQueue
        import theiasfm_tpu_torch.image
        assert len(e.ExifReader().sensors) >= 3000
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
