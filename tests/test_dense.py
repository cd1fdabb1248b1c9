"""Dense no-BVH backend: exact vs brute-force oracle + engine integration."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.math import Vec3, normalize
from optixpathtracer.core.scene import HostScene, Mesh
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.lights.probe import build_probe
from optixpathtracer.ops.dense import closest_hit_dense
from optixpathtracer.ops.traverse import BIG_T, brute_force_closest_hit


def _soup(rng, n_tris=700):  # > BLOCK so the scan loops
    c = (rng.random((n_tris, 3)) * 4 - 2).astype(np.float32)
    e1 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.2
    e2 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.2
    verts = np.concatenate([c, c + e1, c + e2]).astype(np.float32)
    idx = np.stack([np.arange(n_tris), np.arange(n_tris) + n_tris,
                    np.arange(n_tris) + 2 * n_tris], axis=1).astype(np.int32)
    hs = HostScene()
    hs.add_mesh(Mesh(vertices=verts, indices=idx, material=make_material()))
    return hs


def test_dense_matches_brute_force(rng):
    cs = compile_scene(_soup(rng), leaf_size=4)
    o = (rng.random((256, 3)) * 6 - 3).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    ov = Vec3(jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]), jnp.asarray(o[:, 2]))
    dv = normalize(Vec3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2])))
    got = closest_hit_dense(cs.wide, ov, dv, 1e-3, 1e16)
    want = brute_force_closest_hit(cs.scene, ov, dv, 1e-3, 1e16)
    hits = np.asarray(got.hit)
    np.testing.assert_array_equal(hits, np.asarray(want.t) < BIG_T)
    np.testing.assert_allclose(
        np.asarray(got.t)[hits], np.asarray(want.t)[hits], rtol=1e-4, atol=1e-5
    )


@pytest.mark.slow
def test_dense_render_matches_lockstep_enclosed():
    """Enclosed cornell-style scene — the case where BFS worklists overflow."""
    from optixpathtracer.io.obj import load_obj

    hs = load_obj("scenes/cornell_box.obj")
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 0.2, np.float32))
    cfg = RenderConfig(width=40, height=40, samples_per_launch=2, max_depth=2,
                       emission_all_bounces=True)
    cam = Camera(eye=(0, 1.0, 3.6), lookat=(0, 1.0, 0), up=(0, 1, 0), fov_y=40,
                 aspect_ratio=1.0)
    a = Renderer(cs, probe, cfg, cam)
    a.render()
    b = Renderer(cs, probe, dataclasses.replace(cfg, traversal="dense"), cam)
    b.render()
    np.testing.assert_allclose(b.accum_image(), a.accum_image(), rtol=2e-3, atol=2e-4)
