"""Distributed fused foveation == single-device fused foveation, exactly.

The lane round-robin only changes WHICH device traces a lane; per-lane RNG
counters and the zone fold order are unchanged, so on the 8-CPU virtual
mesh the sharded renderer must reproduce the single-device fused render
bit-for-bit (lockstep traversal is per-ray exact) and trace the same
number of rays. Static load balance: every device holds n_pad/8 lanes of
an identical zone mix by construction.
"""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.engine.foveated import FoveatedRenderer, FoveationConfig
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.lights.probe import build_probe
from optixpathtracer.parallel.foveated import DistributedFoveatedRenderer


def _setup():
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    cs = compile_scene(hs)
    probe = build_probe(np.full((16, 32, 3), 0.5, np.float32))
    cfg = RenderConfig(width=96, height=72, max_depth=2, antialias=False)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=96 / 72)
    fov = FoveationConfig(inner_radius=12, outer_radius=30)
    return cs, probe, cfg, cam, fov


@pytest.mark.slow
def test_distributed_fused_matches_single_device():
    cs, probe, cfg, cam, fov = _setup()
    mesh = Mesh(np.asarray(jax.devices()), axis_names=("lanes",))
    assert mesh.devices.size == 8, "conftest must provide the 8-CPU mesh"

    single = FoveatedRenderer(cs, probe, cfg, cam, fov, fused=True)
    dist = DistributedFoveatedRenderer(cs, probe, cfg, cam, fov, mesh=mesh)
    for r in (single, dist):
        r.set_gaze(40, 30)
    for _ in range(3):
        single.render()
        dist.render()
    np.testing.assert_allclose(dist.accum_image(), single.accum_image(),
                               rtol=1e-6, atol=1e-6)
    assert dist.last_rays == single.last_rays, (dist.last_rays, single.last_rays)


@pytest.mark.slow
def test_distributed_fused_gaze_move():
    cs, probe, cfg, cam, fov = _setup()
    mesh = Mesh(np.asarray(jax.devices()), axis_names=("lanes",))
    dist = DistributedFoveatedRenderer(cs, probe, cfg, cam, fov, mesh=mesh)
    dist.set_gaze(20, 20)
    dist.render()
    dist.set_gaze(70, 50)
    dist.render()
    img = dist.accum_image()
    assert np.isfinite(img).all()
    assert img.max() > 0.0


def test_distributed_fused_matches_single_device_fast():
    """Small fast-tier variant of the exact-match invariant (ADVICE r3)."""
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 0.5, np.float32))
    cfg = RenderConfig(width=48, height=32, max_depth=1, antialias=False)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=48 / 32)
    fov = FoveationConfig(inner_radius=8, outer_radius=16)
    mesh = Mesh(np.asarray(jax.devices()), axis_names=("lanes",))
    single = FoveatedRenderer(cs, probe, cfg, cam, fov, fused=True)
    dist = DistributedFoveatedRenderer(cs, probe, cfg, cam, fov, mesh=mesh)
    for r in (single, dist):
        r.set_gaze(24, 16)
        r.render()
    np.testing.assert_allclose(dist.accum_image(), single.accum_image(),
                               rtol=1e-6, atol=1e-6)
    assert dist.last_rays == single.last_rays
