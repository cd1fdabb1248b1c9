"""BFS traversal backend vs brute-force oracle (exactness when overflow==0)."""
import numpy as np
import pytest
import jax.numpy as jnp

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.math import Vec3, normalize
from optixpathtracer.core.scene import HostScene, Mesh
from optixpathtracer.ops.traverse import BIG_T, brute_force_closest_hit
from optixpathtracer.ops.traverse_bfs import any_hit_bfs, closest_hit_bfs


def _soup(rng, n_tris=300, scale=2.0):
    c = (rng.random((n_tris, 3)) * scale - scale / 2).astype(np.float32)
    e1 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.15
    e2 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.15
    verts = np.concatenate([c, c + e1, c + e2]).astype(np.float32)
    idx = np.stack(
        [np.arange(n_tris), np.arange(n_tris) + n_tris, np.arange(n_tris) + 2 * n_tris],
        axis=1,
    ).astype(np.int32)
    hs = HostScene()
    hs.add_mesh(Mesh(vertices=verts, indices=idx, material=make_material()))
    return hs


def _rays(rng, n):
    o = (rng.random((n, 3)) * 6 - 3).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return (
        Vec3(jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]), jnp.asarray(o[:, 2])),
        normalize(Vec3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2]))),
    )


def test_bfs_matches_brute_force(rng):
    cs = compile_scene(_soup(rng), leaf_size=4, wide_width=8)
    o, d = _rays(rng, 512)
    res = closest_hit_bfs(cs.wide, o, d, 1e-3, 1e16, cap_factor=8)
    assert float(res.overflow) == 0.0
    want = brute_force_closest_hit(cs.scene, o, d, 1e-3, 1e16)
    got_t = np.asarray(res.record.t)
    want_t = np.asarray(want.t)
    hits = np.asarray(res.record.hit)
    np.testing.assert_array_equal(hits, want_t < BIG_T)
    np.testing.assert_allclose(got_t[hits], want_t[hits], rtol=1e-4, atol=1e-5)
    # barycentrics agree where the same triangle won
    same = hits & (np.asarray(res.record.tri) >= 0)
    np.testing.assert_allclose(
        np.asarray(res.record.u)[same] + np.asarray(res.record.v)[same],
        np.asarray(want.u)[same] + np.asarray(want.v)[same],
        atol=1e-3,
    )


@pytest.mark.slow
def test_bfs_wide_widths(rng):
    hs = _soup(rng, 150)
    o, d = _rays(rng, 256)
    base = None
    for w in (4, 8, 16):
        cs = compile_scene(hs, leaf_size=4, wide_width=w)
        res = closest_hit_bfs(cs.wide, o, d, cap_factor=8)
        assert float(res.overflow) == 0.0, w
        t = np.asarray(res.record.t)
        if base is None:
            base = t
        else:
            np.testing.assert_allclose(t, base, rtol=1e-4, atol=1e-5)


def test_bfs_any_hit(rng):
    cs = compile_scene(_soup(rng), leaf_size=4)
    o, d = _rays(rng, 512)
    occ, ovf = any_hit_bfs(cs.wide, o, d, 1e-3, 1e16, cap_factor=8)
    assert float(ovf) == 0.0
    want = brute_force_closest_hit(cs.scene, o, d, 1e-3, 1e16)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(want.t) < BIG_T)


def test_bfs_tmax(rng):
    cs = compile_scene(_soup(rng), leaf_size=4)
    o, d = _rays(rng, 256)
    full = closest_hit_bfs(cs.wide, o, d, 1e-3, 1e16, cap_factor=8).record
    t_full = np.asarray(full.t)
    lim = np.where(t_full < BIG_T, t_full * 0.5, 1e16).astype(np.float32)
    cut = closest_hit_bfs(cs.wide, o, d, 1e-3, jnp.asarray(lim), cap_factor=8).record
    assert not np.any(np.asarray(cut.hit) & (t_full < BIG_T))


def test_bfs_single_box():
    hs = HostScene()
    hs.add_box(make_material(), pos=(0, 0, 0), extent=(1, 1, 1))
    cs = compile_scene(hs)
    o = Vec3.of([3.0, 10.0], [0.0, 10.0], [0.0, 10.0])
    d = Vec3.of([-1.0, 1.0], [0.0, 0.0], [0.0, 0.0])
    res = closest_hit_bfs(cs.wide, o, d)
    assert bool(np.asarray(res.record.hit)[0])
    np.testing.assert_allclose(float(np.asarray(res.record.t)[0]), 2.0, rtol=1e-5)
    assert not bool(np.asarray(res.record.hit)[1])
