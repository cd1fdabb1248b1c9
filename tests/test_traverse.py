import numpy as np
import jax.numpy as jnp

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.math import Vec3, normalize
from optixpathtracer.core.scene import HostScene, Mesh
from optixpathtracer.core.materials import make_material
from optixpathtracer.ops.traverse import (
    BIG_T,
    any_hit,
    brute_force_closest_hit,
    closest_hit,
)


def _random_soup_scene(rng, n_tris=200, scale=2.0):
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


def _random_rays(rng, n):
    o = (rng.random((n, 3)) * 6 - 3).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    ov = Vec3(jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]), jnp.asarray(o[:, 2]))
    dv = normalize(Vec3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2])))
    return ov, dv


def test_closest_hit_matches_brute_force(rng):
    cs = compile_scene(_random_soup_scene(rng), leaf_size=4)
    o, d = _random_rays(rng, 256)
    got = closest_hit(cs.bvh, cs.scene, o, d, 1e-3, 1e16)
    want = brute_force_closest_hit(cs.scene, o, d, 1e-3, 1e16)
    got_t = np.asarray(got.t)
    want_t = np.asarray(want.t)
    hits = np.asarray(got.hit)
    np.testing.assert_array_equal(hits, want_t < BIG_T)
    np.testing.assert_allclose(got_t[hits], want_t[hits], rtol=1e-4, atol=1e-5)


def test_closest_hit_various_leaf_sizes(rng):
    hs = _random_soup_scene(rng, n_tris=77)
    o, d = _random_rays(rng, 128)
    base = None
    for k in (1, 4, 8):
        cs = compile_scene(hs, leaf_size=k)
        t = np.asarray(closest_hit(cs.bvh, cs.scene, o, d).t)
        if base is None:
            base = t
        else:
            np.testing.assert_allclose(t, base, rtol=1e-4, atol=1e-5)


def test_any_hit_consistent_with_closest(rng):
    cs = compile_scene(_random_soup_scene(rng), leaf_size=4)
    o, d = _random_rays(rng, 256)
    occ = np.asarray(any_hit(cs.bvh, cs.scene, o, d, 1e-3, 1e16))
    ch = np.asarray(closest_hit(cs.bvh, cs.scene, o, d, 1e-3, 1e16).hit)
    np.testing.assert_array_equal(occ, ch)


def test_tmax_respected(rng):
    cs = compile_scene(_random_soup_scene(rng), leaf_size=4)
    o, d = _random_rays(rng, 256)
    full = closest_hit(cs.bvh, cs.scene, o, d, 1e-3, 1e16)
    t_full = np.asarray(full.t)
    # shrink tmax below each hit: those rays must now miss
    lim = np.where(t_full < BIG_T, t_full * 0.5, 1e16).astype(np.float32)
    cut = closest_hit(cs.bvh, cs.scene, o, d, 1e-3, jnp.asarray(lim))
    assert not np.any(np.asarray(cut.hit) & (t_full < BIG_T))


def test_miss_returns_big_t():
    hs = HostScene()
    hs.add_box(make_material(), pos=(0, 0, 0), extent=(1, 1, 1))
    cs = compile_scene(hs)
    o = Vec3.of([10.0], [10.0], [10.0])
    d = Vec3.of([1.0], [0.0], [0.0])
    rec = closest_hit(cs.bvh, cs.scene, o, d)
    assert not bool(np.asarray(rec.hit)[0])
    # misses keep t == t_max (the sentinel is the tri == -1 flag)
    assert float(np.asarray(rec.t)[0]) >= 1e15
