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
def test_batched_spp_matches_sample_loop():
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    cs = compile_scene(hs)
    probe = build_probe(np.full((16, 32, 3), 0.5, np.float32))
    cfg = RenderConfig(width=48, height=36, samples_per_launch=4, max_depth=2)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=48 / 36)

    r_loop = Renderer(cs, probe, cfg, cam)
    r_loop.render()
    r_batch = Renderer(cs, probe, dataclasses.replace(cfg, batch_spp=True), cam)
    r_batch.render()

    # identical RNG streams per (pixel, sample): images match to float assoc
    # error; the backplate composite uses mean-of-samples instead of
    # last-sample (sub-pixel jitter level difference on background pixels)
    np.testing.assert_allclose(
        r_batch.accum_image(), r_loop.accum_image(), rtol=5e-3, atol=5e-4
    )
    np.testing.assert_allclose(
        float(r_batch._last.rays_traced), float(r_loop._last.rays_traced)
    )


def test_batched_spp_matches_sample_loop_fast():
    """Small fast-tier variant of the same invariant (ADVICE r3)."""
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 0.5, np.float32))
    cfg = RenderConfig(width=24, height=16, samples_per_launch=2, max_depth=1)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=24 / 16)
    r_loop = Renderer(cs, probe, cfg, cam)
    r_loop.render()
    r_batch = Renderer(cs, probe, dataclasses.replace(cfg, batch_spp=True), cam)
    r_batch.render()
    np.testing.assert_allclose(
        r_batch.accum_image(), r_loop.accum_image(), rtol=5e-3, atol=5e-4
    )
    np.testing.assert_allclose(
        float(r_batch._last.rays_traced), float(r_loop._last.rays_traced)
    )
