"""Native C++ OBJ parser vs the pure-Python parser (same semantics)."""
import numpy as np
import pytest

from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.io.native import get_lib
from optixpathtracer.io.obj import _load_obj_python, load_obj, save_obj

needs_native = pytest.mark.skipif(get_lib() is None, reason="no C++ toolchain")


def _fixture_scene():
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.2, 0.1)), pos=(0, 0, 0), extent=(1, 2, 3))
    hs.add_box(make_material(color=(0.1, 0.9, 0.2), emission=(1, 2, 3)), pos=(5, 0, 0), extent=(1, 1, 1))
    return hs


@needs_native
def test_native_matches_python(tmp_path):
    path = str(tmp_path / "scene.obj")
    save_obj(path, _fixture_scene())

    nat = load_obj(path, prefer_native=True)
    py = _load_obj_python(path)
    assert len(nat.meshes) == len(py.meshes)
    assert sum(len(m.indices) for m in nat.meshes) == sum(len(m.indices) for m in py.meshes)
    for a, b in zip(
        sorted(nat.meshes, key=lambda m: tuple(m.material["color"])),
        sorted(py.meshes, key=lambda m: tuple(m.material["color"])),
    ):
        sa = set(map(tuple, np.round(a.vertices, 4)))
        sb = set(map(tuple, np.round(b.vertices, 4)))
        assert sa == sb
        np.testing.assert_allclose(a.material["color"], b.material["color"])


@needs_native
def test_native_negative_indices_and_quads(tmp_path):
    obj = "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf -4 -3 -2 -1\n"
    (tmp_path / "q.obj").write_text(obj)
    hs = load_obj(str(tmp_path / "q.obj"), prefer_native=True)
    assert len(hs.meshes) == 1
    assert len(hs.meshes[0].indices) == 2
    sa = set(map(tuple, hs.meshes[0].vertices))
    assert (0.0, 0.0, 0.0) in sa and (1.0, 1.0, 0.0) in sa


@needs_native
def test_native_speed_on_larger_file(tmp_path):
    import time

    # ~60k-tri synthetic obj
    rng = np.random.default_rng(0)
    n = 20000
    v = rng.random((3 * n, 3)).astype(np.float32)
    lines = ["o big\n"]
    lines += [f"v {a} {b} {c}\n" for a, b, c in v]
    lines += [f"f {3*i+1} {3*i+2} {3*i+3}\n" for i in range(n)]
    p = tmp_path / "big.obj"
    p.write_text("".join(lines))

    t0 = time.perf_counter()
    nat = load_obj(str(p), prefer_native=True)
    t_nat = time.perf_counter() - t0
    assert sum(len(m.indices) for m in nat.meshes) == n
    # native should be clearly faster than the python fallback
    t0 = time.perf_counter()
    _load_obj_python(str(p))
    t_py = time.perf_counter() - t0
    assert t_nat < t_py, (t_nat, t_py)
