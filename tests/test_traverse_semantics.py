"""Traversal semantics every exact backend must keep, checked against the
brute-force oracle on the CPU backends (lockstep, dense). The GPU kernel has
the same contract; tests/test_traverse_gpu.py holds it to its numpy
reference here and to the oracle on a GPU.

Exactness means equal hit ids, except that a ray may report another
triangle at the same t (a tie: coplanar or edge-sharing triangles), where
the order of the tests decides which one wins.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.math import Vec3
from optixpathtracer.core.scene import HostScene, Mesh
from optixpathtracer.ops.dispatch import trace_closest, trace_occluded
from optixpathtracer.ops.traverse import brute_force_closest_hit

BACKENDS = ("lockstep", "dense")


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


def _oracle(cs, o, d, t_min, t_max):
    return brute_force_closest_hit(cs.scene, _v(o), _v(d), t_min, t_max,
                                   num_valid=cs.num_triangles)


def _assert_exact(rec, ref):
    tri, rtri = np.asarray(rec.tri), np.asarray(ref.tri)
    assert ((tri >= 0) == (rtri >= 0)).all()
    hit = rtri >= 0
    t, rt = np.asarray(rec.t)[hit], np.asarray(ref.t)[hit]
    np.testing.assert_allclose(t, rt, rtol=1e-5)
    other = tri[hit] != rtri[hit]
    assert (np.abs(t - rt)[other] <= 1e-6 * np.abs(rt[other])).all(), "untied"


@pytest.mark.parametrize("backend", BACKENDS)
def test_per_ray_t_intervals_and_dead_rays(rng, backend):
    cs = compile_scene(_soup(rng, 200))
    o, d = _rays(rng, 300)
    # a third of the rays dead (t_max == 0), varied finite t_max elsewhere
    t_max = np.where(rng.random(300) < 0.33, 0.0, rng.uniform(1, 8, 300)).astype(np.float32)
    t_min = rng.uniform(1e-3, 0.5, 300).astype(np.float32)
    rec = trace_closest(cs, _v(o), _v(d), jnp.asarray(t_min), jnp.asarray(t_max),
                        traversal=backend)
    _assert_exact(rec, _oracle(cs, o, d, t_min, t_max))
    tri, t = np.asarray(rec.tri), np.asarray(rec.t)
    assert (tri[t_max == 0.0] == -1).all()
    hit = tri >= 0
    assert (t[hit] > t_min[hit]).all() and (t[hit] < t_max[hit]).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_ray_counts_off_any_block_size(rng, backend):
    """N that is no multiple of any block or warp: results keep shape (N,)."""
    cs = compile_scene(_soup(rng, 100))
    for n in (1, 177):
        o, d = _rays(rng, n)
        rec = trace_closest(cs, _v(o), _v(d), 1e-3, 1e16, traversal=backend)
        assert rec.tri.shape == rec.t.shape == rec.u.shape == (n,)
        _assert_exact(rec, _oracle(cs, o, d, 1e-3, 1e16))


@pytest.mark.parametrize("backend", BACKENDS)
def test_any_hit_is_closest_hit_within_t_max(rng, backend):
    cs = compile_scene(_soup(rng, 150))
    o, d = _rays(rng, 256)
    t_max = rng.uniform(0.5, 6.0, 256).astype(np.float32)
    occ = np.asarray(trace_occluded(cs, _v(o), _v(d), 1e-2, jnp.asarray(t_max),
                                    traversal=backend))
    ref = np.asarray(_oracle(cs, o, d, 1e-2, t_max).tri) >= 0
    assert occ.dtype == bool and occ.shape == (256,)
    np.testing.assert_array_equal(occ, ref)
    assert 0 < occ.sum() < 256  # the interval actually decides some rays


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_leaf_scene(rng, backend):
    """Fewer triangles than one leaf: one internal node whose two children
    are the same leaf (the right box empty)."""
    cs = compile_scene(_soup(rng, 5), leaf_size=8)
    assert cs.bvh.num_internal == 1
    assert int(cs.bvh.child_left[0]) == int(cs.bvh.child_right[0]) == -1
    o, d = _rays(rng, 64)
    rec = trace_closest(cs, _v(o), _v(d), 1e-3, 1e16, traversal=backend)
    _assert_exact(rec, _oracle(cs, o, d, 1e-3, 1e16))


@pytest.mark.parametrize("backend", BACKENDS)
def test_rotated_sliver_geometry(rng, backend):
    """Nothing axis-aligned: a rotated city on a sliver-triangle heightfield,
    with grazing rays nearly parallel to the terrain (the slab test's worst
    case on thin boxes)."""
    from bench import build_hostile_scene

    cs = compile_scene(build_hostile_scene(n_boxes=60, terrain_grid=(32, 16)))
    half = 256
    o1 = rng.uniform(-40, 40, (half, 3)).astype(np.float32)
    o1[:, 1] = rng.uniform(0.5, 6.0, half)
    o2 = rng.uniform(-40, 40, (half, 3)).astype(np.float32)
    o2[:, 1] = rng.uniform(-1.0, 3.0, half)
    d = rng.normal(0, 1, (2 * half, 3)).astype(np.float32)
    d[half:, 1] *= 0.05
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.concatenate([o1, o2])
    rec = trace_closest(cs, _v(o), _v(d), 1e-3, 1e16, traversal=backend)
    ref = _oracle(cs, o, d, 1e-3, 1e16)
    _assert_exact(rec, ref)
    assert (np.asarray(ref.tri) >= 0).sum() > half // 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_all_miss(rng, backend):
    cs = compile_scene(_soup(rng, 50, extent=1.0))
    o = np.full((32, 3), 10.0, np.float32)
    d = np.abs(rng.normal(0, 1, (32, 3))).astype(np.float32) + 0.1  # away
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rec = trace_closest(cs, _v(o), _v(d), 1e-3, 1e16, traversal=backend)
    assert (np.asarray(rec.tri) == -1).all()
    occ = trace_occluded(cs, _v(o), _v(d), 1e-2, 1e16, traversal=backend)
    assert not np.asarray(occ).any()


@pytest.mark.parametrize("backend", BACKENDS)
def test_t_min_excludes_the_origin_surface(backend):
    """Rays leaving a surface point (the next bounce's origin) must not hit
    the surface they start on: t_min cuts the t ~ 0 self-intersection."""
    hs = HostScene()
    hs.add_box(make_material(), pos=(0, 0, 0), extent=(2, 0.1, 2))  # slab
    hs.add_box(make_material(), pos=(0, 3, 0), extent=(1, 0.1, 1))  # roof
    cs = compile_scene(hs)
    gx, gz = np.meshgrid(np.linspace(-0.8, 0.8, 8), np.linspace(-0.8, 0.8, 8))
    o = np.stack([gx.ravel(), np.full(64, 0.1), gz.ravel()], -1).astype(np.float32)
    d = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (64, 1))
    rec = trace_closest(cs, _v(o), _v(d), 1e-3, 1e16, traversal=backend)
    t = np.asarray(rec.t)
    np.testing.assert_allclose(t, 2.8, rtol=1e-5)  # the roof's underside
    _assert_exact(rec, _oracle(cs, o, d, 1e-3, 1e16))
    # with no t_min the start surface is hit at t = 0 (or just above)
    rec0 = trace_closest(cs, _v(o), _v(d), -1e-3, 1e16, traversal=backend)
    assert (np.asarray(rec0.t) < 1e-3).all()
