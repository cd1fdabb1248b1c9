import numpy as np

from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.io.obj import load_obj, save_obj


def test_obj_roundtrip(tmp_path):
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.2, 0.1)), pos=(0, 0, 0), extent=(1, 2, 3))
    hs.add_box(make_material(color=(0.1, 0.9, 0.2), emission=(1, 2, 3)), pos=(5, 0, 0), extent=(1, 1, 1))
    path = str(tmp_path / "scene.obj")
    save_obj(path, hs)

    back = load_obj(path)
    assert len(back.meshes) == 2
    # triangle count preserved
    assert sum(len(m.indices) for m in back.meshes) == 24
    # vertex positions survive (per-mesh set equality)
    for a, b in zip(hs.meshes, back.meshes):
        sa = set(map(tuple, np.round(a.vertices, 4)))
        sb = set(map(tuple, np.round(b.vertices, 4)))
        assert sa == sb
        np.testing.assert_allclose(b.material["color"], a.material["color"], atol=1e-5)
        np.testing.assert_allclose(b.material["emission"], a.material["emission"], atol=1e-5)


def test_obj_material_split(tmp_path):
    # one object with two usemtl runs must split into two meshes
    obj = """
mtllib m.mtl
o thing
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
usemtl red
f 1 2 3
usemtl blue
f 2 4 3
"""
    mtl = """
newmtl red
Kd 1 0 0
newmtl blue
Kd 0 0 1
"""
    (tmp_path / "s.obj").write_text(obj)
    (tmp_path / "m.mtl").write_text(mtl)
    hs = load_obj(str(tmp_path / "s.obj"))
    assert len(hs.meshes) == 2
    colors = sorted(tuple(m.material["color"]) for m in hs.meshes)
    assert colors == [(0.0, 0.0, 1.0), (1.0, 0.0, 0.0)]


def test_obj_negative_indices_and_quads(tmp_path):
    obj = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f -4 -3 -2 -1
"""
    (tmp_path / "q.obj").write_text(obj)
    hs = load_obj(str(tmp_path / "q.obj"))
    assert len(hs.meshes) == 1
    assert len(hs.meshes[0].indices) == 2  # quad fan-triangulated


def test_obj_vertex_dedupe(tmp_path):
    obj = """
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
f 1 2 3
f 2 4 3
"""
    (tmp_path / "d.obj").write_text(obj)
    hs = load_obj(str(tmp_path / "d.obj"))
    # 4 unique verts, not 6 (addVertex dedupe semantics)
    assert len(hs.meshes[0].vertices) == 4
