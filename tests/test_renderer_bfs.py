"""The two traversal backends must produce identical renders."""
import dataclasses

import numpy as np
import pytest

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.lights.probe import build_probe


@pytest.mark.slow
def test_bfs_render_matches_lockstep():
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    hs.add_box(make_material(color=(0.2, 0.5, 0.9), metallic=1.0, roughness=0.3),
               pos=(1.2, 0.4, 0.6), extent=(0.4, 0.4, 0.4))
    cs = compile_scene(hs)
    probe = build_probe(np.full((16, 32, 3), 0.5, np.float32))
    cfg = RenderConfig(width=64, height=48, samples_per_launch=2, max_depth=3)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=64 / 48)

    r_lock = Renderer(cs, probe, cfg, cam)
    r_lock.render()
    r_bfs = Renderer(
        cs, probe, dataclasses.replace(cfg, traversal="bfs", bfs_cap_factor=8), cam
    )
    r_bfs.render()

    # same RNG streams + exact traversal -> images match to float tolerance
    np.testing.assert_allclose(
        r_bfs.accum_image(), r_lock.accum_image(), rtol=2e-3, atol=2e-4
    )


def test_bfs_render_matches_lockstep_fast():
    """Small fast-tier variant of the same invariant (ADVICE r3)."""
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 0.5, np.float32))
    cfg = RenderConfig(width=32, height=24, samples_per_launch=1, max_depth=2)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=32 / 24)
    r_lock = Renderer(cs, probe, cfg, cam)
    r_lock.render()
    r_bfs = Renderer(
        cs, probe, dataclasses.replace(cfg, traversal="bfs", bfs_cap_factor=8), cam
    )
    r_bfs.render()
    np.testing.assert_allclose(
        r_bfs.accum_image(), r_lock.accum_image(), rtol=2e-3, atol=2e-4
    )
