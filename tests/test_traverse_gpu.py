"""The GPU traversal (ops/traverse_gpu.py + native/cuda/traverse.cu).

The CUDA kernel has no interpret mode. On the CPU these tests check what
surrounds it: the packed node and triangle records, the numpy reference
walk over those records (the kernel's algorithm, line by line) against the
brute-force oracle and the lockstep backend, the wrapper's shapes (with the
kernel launch replaced by the reference), the library's build key, and the
refusal to run without a CUDA device. Tests marked `gpu` run the kernel
itself against the oracle and skip without a GPU.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.math import Vec3
from optixpathtracer.core.scene import HostScene, Mesh
from optixpathtracer.ops import traverse_gpu as G
from optixpathtracer.ops.traverse import brute_force_closest_hit, closest_hit


def _soup(rng, t, extent=2.0, size=0.3):
    ctr = rng.uniform(-extent, extent, (t, 3)).astype(np.float32)
    v = [ctr + rng.normal(0, size, (t, 3)).astype(np.float32) for _ in range(3)]
    hs = HostScene()
    hs.add_mesh(Mesh(vertices=np.concatenate(v),
                     indices=np.arange(3 * t, dtype=np.int32).reshape(3, t).T.copy(),
                     material=make_material()))
    return hs


def _rays(rng, n, extent=4.0):
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _v(a):
    return Vec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _reference_launch(kind, packed, rays):
    """Stand-in for the kernel launch: the numpy reference via a callback."""
    n = rays[0].shape[0]

    def cb(nodes, tris, ox, oy, oz, dx, dy, dz, lo, hi):
        return G.traverse_packed_np(nodes, tris, np.stack([ox, oy, oz], -1),
                                    np.stack([dx, dy, dz], -1), lo, hi,
                                    any_hit=kind == "any")

    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    return jax.pure_callback(cb, (f32, i32, f32, f32), packed.nodes, packed.tris, *rays)


def test_packed_nodes_round_trip(rng):
    cs = compile_scene(_soup(rng, 300), leaf_size=4)
    b, nodes = cs.bvh, np.asarray(cs.packed.nodes)
    assert nodes.shape == (b.num_internal, 4, 4) and nodes.dtype == np.float32
    np.testing.assert_array_equal(nodes[:, 0], np.stack(
        [b.left_min.x, b.left_max.x, b.left_min.y, b.left_max.y], -1))
    np.testing.assert_array_equal(nodes[:, 1], np.stack(
        [b.right_min.x, b.right_max.x, b.right_min.y, b.right_max.y], -1))
    np.testing.assert_array_equal(nodes[:, 2], np.stack(
        [b.left_min.z, b.left_max.z, b.right_min.z, b.right_max.z], -1))
    children = nodes[:, 3, :2].copy().view(np.int32)
    np.testing.assert_array_equal(children[:, 0], np.asarray(b.child_left))
    np.testing.assert_array_equal(children[:, 1], np.asarray(b.child_right))


@pytest.mark.parametrize("leaf_size", [4, 8])
def test_leaf_encoding(rng, leaf_size):
    """Leaf l holds the sorted triangles l*K .. l*K+K-1 as (v0, e1, e2), and
    every leaf and every non-root internal node is referenced exactly once
    (negative refs -(leaf + 1))."""
    cs = compile_scene(_soup(rng, 203), leaf_size=leaf_size)
    tris = np.asarray(cs.packed.tris)
    k = leaf_size
    n_pad = cs.scene.num_triangles
    assert tris.shape == (n_pad // k, k, 3, 4)
    flat = tris.reshape(-1, 3, 4)
    sc = cs.scene
    v = [np.stack([np.asarray(a.x), np.asarray(a.y), np.asarray(a.z)], -1)
         for a in (sc.v0, sc.v1, sc.v2)]
    np.testing.assert_array_equal(flat[:, 0, :3], v[0])
    np.testing.assert_array_equal(flat[:, 1, :3], v[1] - v[0])
    np.testing.assert_array_equal(flat[:, 2, :3], v[2] - v[0])
    assert (flat[:, :, 3] == 0).all()
    refs = np.asarray(cs.packed.nodes)[:, 3, :2].copy().view(np.int32).ravel()
    leaves = np.sort(-(refs[refs < 0] + 1))
    np.testing.assert_array_equal(leaves, np.arange(n_pad // k))
    np.testing.assert_array_equal(np.sort(refs[refs >= 0]),
                                  np.arange(1, cs.bvh.num_internal))


@pytest.mark.parametrize("seed,n_tris,leaf_size", [(0, 120, 4), (1, 400, 8), (2, 9, 8)])
def test_reference_walk_matches_brute_force(seed, n_tris, leaf_size):
    rng = np.random.default_rng(seed)
    cs = compile_scene(_soup(rng, n_tris), leaf_size=leaf_size)
    o, d = _rays(rng, 200)
    t, tri, u, v = G.traverse_packed_np(cs.packed.nodes, cs.packed.tris, o, d, 1e-3, 1e16)
    ref = brute_force_closest_hit(cs.scene, _v(o), _v(d), 1e-3, 1e16,
                                  num_valid=cs.num_triangles)
    rtri, rt = np.asarray(ref.tri), np.asarray(ref.t)
    np.testing.assert_array_equal(tri >= 0, rtri >= 0)
    hit = rtri >= 0
    np.testing.assert_allclose(t[hit], rt[hit], rtol=1e-5)
    other = tri[hit] != rtri[hit]
    assert (np.abs(t[hit] - rt[hit])[other] <= 1e-6 * rt[hit][other]).all()
    assert (t[~hit] == 1e16).all() and (tri[~hit] == -1).all()  # miss record


def test_reference_walk_equals_lockstep_and_any_hit(rng):
    """Same tests in the same order as the lockstep loop: identical hit ids,
    and t to an ulp (XLA may contract multiply-adds that numpy rounds
    twice). The any-hit walk agrees with closest hit inside [t_min, t_max]."""
    cs = compile_scene(_soup(rng, 250), leaf_size=8)
    o, d = _rays(rng, 150)
    t, tri, u, v = G.traverse_packed_np(cs.packed.nodes, cs.packed.tris, o, d, 1e-3, 1e16)
    ls = closest_hit(cs.bvh, cs.scene, _v(o), _v(d), 1e-3, 1e16)
    np.testing.assert_array_equal(tri, np.asarray(ls.tri))
    np.testing.assert_allclose(t, np.asarray(ls.t), rtol=3e-7)
    np.testing.assert_allclose(u, np.asarray(ls.u), atol=1e-5)
    t_max = rng.uniform(0.5, 5.0, 150).astype(np.float32)
    _, atri, _, _ = G.traverse_packed_np(cs.packed.nodes, cs.packed.tris, o, d,
                                         1e-2, t_max, any_hit=True)
    _, ctri, _, _ = G.traverse_packed_np(cs.packed.nodes, cs.packed.tris, o, d,
                                         1e-2, t_max)
    np.testing.assert_array_equal(atri >= 0, ctri >= 0)


def test_wrapper_broadcasts_t_interval(rng, monkeypatch):
    monkeypatch.setattr(G, "_launch", _reference_launch)
    cs = compile_scene(_soup(rng, 60), leaf_size=4)
    o, d = _rays(rng, 37)
    rec = jax.jit(lambda p, ov, dv: G.closest_hit(p, ov, dv, 1e-3, 1e16))(
        cs.packed, _v(o), _v(d))
    t, tri, u, v = G.traverse_packed_np(cs.packed.nodes, cs.packed.tris, o, d, 1e-3, 1e16)
    assert rec.tri.shape == (37,) and rec.tri.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(rec.tri), tri)
    np.testing.assert_array_equal(np.asarray(rec.t), t)


def test_wrapper_restores_ray_shape(rng, monkeypatch):
    """Rays of any shape go to the kernel flat and come back in their shape."""
    monkeypatch.setattr(G, "_launch", _reference_launch)
    cs = compile_scene(_soup(rng, 60), leaf_size=4)
    o, d = _rays(rng, 24)
    o2 = Vec3(*(jnp.asarray(o[:, i]).reshape(4, 6) for i in range(3)))
    d2 = Vec3(*(jnp.asarray(d[:, i]).reshape(4, 6) for i in range(3)))
    t_max = jnp.asarray(rng.uniform(1, 5, (4, 6)).astype(np.float32))
    rec = G.closest_hit(cs.packed, o2, d2, 1e-3, t_max)
    assert rec.t.shape == rec.tri.shape == rec.u.shape == rec.v.shape == (4, 6)
    flat = G.closest_hit(cs.packed, _v(o), _v(d), 1e-3, t_max.reshape(-1))
    np.testing.assert_array_equal(np.asarray(rec.tri).ravel(), np.asarray(flat.tri))


def test_wrapper_any_hit_is_boolean(rng, monkeypatch):
    monkeypatch.setattr(G, "_launch", _reference_launch)
    cs = compile_scene(_soup(rng, 60), leaf_size=4)
    o, d = _rays(rng, 50)
    occ = G.any_hit(cs.packed, _v(o), _v(d), 1e-2, 3.0)
    assert occ.dtype == jnp.bool_ and occ.shape == (50,)
    _, ctri, _, _ = G.traverse_packed_np(cs.packed.nodes, cs.packed.tris, o, d, 1e-2, 3.0)
    np.testing.assert_array_equal(np.asarray(occ), ctri >= 0)


def test_wrapper_empty_ray_batch(rng, monkeypatch):
    monkeypatch.setattr(G, "_launch", _reference_launch)
    cs = compile_scene(_soup(rng, 20), leaf_size=4)
    e = np.zeros((0, 3), np.float32)
    rec = G.closest_hit(cs.packed, _v(e), _v(e))
    assert rec.tri.shape == (0,)


def test_no_cuda_device_is_an_error():
    """On a platform other than the GPU the kernel refuses to run: there
    is no fallback to another traversal."""
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="CUDA device"):
        G.register()


def test_library_is_keyed_by_source(tmp_path, monkeypatch):
    src = tmp_path / "traverse.cu"
    src.write_text("// a\n")
    monkeypatch.setattr(G, "SOURCE", str(src))
    monkeypatch.setattr(G, "BUILD_DIR", str(tmp_path / "build"))
    first = G.library_path()
    assert first == G.library_path()
    assert first.startswith(str(tmp_path / "build"))
    src.write_text("// b\n")
    assert G.library_path() != first


@pytest.mark.gpu
def test_kernel_matches_oracle(gpu, rng):
    cs = compile_scene(_soup(rng, 2000, extent=6.0), leaf_size=8)
    o, d = _rays(rng, 4096, extent=8.0)
    rec = G.closest_hit(cs.packed, _v(o), _v(d), 1e-3, 1e16)
    ref = brute_force_closest_hit(cs.scene, _v(o), _v(d), 1e-3, 1e16,
                                  num_valid=cs.num_triangles)
    tri, rtri = np.asarray(rec.tri), np.asarray(ref.tri)
    t, rt = np.asarray(rec.t), np.asarray(ref.t)
    hit = rtri >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    np.testing.assert_allclose(t[hit], rt[hit], rtol=1e-5)
    other = tri[hit] != rtri[hit]
    assert (np.abs(t[hit] - rt[hit])[other] <= 1e-6 * rt[hit][other]).all()


@pytest.mark.gpu
def test_kernel_any_hit_matches_oracle(gpu, rng):
    cs = compile_scene(_soup(rng, 2000, extent=6.0), leaf_size=8)
    o, d = _rays(rng, 4096, extent=8.0)
    t_max = jnp.asarray(rng.uniform(0.5, 10.0, 4096).astype(np.float32))
    occ = G.any_hit(cs.packed, _v(o), _v(d), 1e-2, t_max)
    ref = brute_force_closest_hit(cs.scene, _v(o), _v(d), 1e-2, t_max,
                                  num_valid=cs.num_triangles)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref.tri) >= 0)
