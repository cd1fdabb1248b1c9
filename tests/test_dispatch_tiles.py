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
def test_chunked_dispatch_matches_single():
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    cs = compile_scene(hs)
    probe = build_probe(np.full((16, 32, 3), 0.5, np.float32))
    cfg = RenderConfig(width=64, height=48, samples_per_launch=2, max_depth=2)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=64 / 48)

    r1 = Renderer(cs, probe, cfg, cam)
    r1.render()
    r4 = Renderer(cs, probe, dataclasses.replace(cfg, dispatch_tiles=4), cam)
    r4.render()
    np.testing.assert_allclose(r4.accum_image(), r1.accum_image(), rtol=1e-6)
    # ray counts sum across chunks
    np.testing.assert_allclose(
        float(r4._last.rays_traced), float(r1._last.rays_traced)
    )
    aov1 = r1.aovs()
    aov4 = r4.aovs()
    np.testing.assert_allclose(aov4["normal"], aov1["normal"], rtol=1e-6)


def test_chunked_dispatch_matches_single_fast():
    """Small fast-tier variant of the same invariant (ADVICE r3)."""
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 0.5, np.float32))
    cfg = RenderConfig(width=32, height=16, samples_per_launch=1, max_depth=1)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=32 / 16)
    r1 = Renderer(cs, probe, cfg, cam)
    r1.render()
    r2 = Renderer(cs, probe, dataclasses.replace(cfg, dispatch_tiles=2), cam)
    r2.render()
    np.testing.assert_allclose(r2.accum_image(), r1.accum_image(), rtol=1e-6)
    np.testing.assert_allclose(
        float(r2._last.rays_traced), float(r1._last.rays_traced)
    )
