import dataclasses

import numpy as np
import pytest

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import (
    MATERIAL_FLAG_SHADOW_CATCHER,
    make_material,
)
from optixpathtracer.core.scene import HostScene
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.lights.probe import build_probe, make_test_probe


def _cs(catcher=False):
    hs = HostScene()
    floor = make_material(color=(0.8, 0.8, 0.8),
                          flags=MATERIAL_FLAG_SHADOW_CATCHER if catcher else 0)
    hs.add_box(floor, pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    return compile_scene(hs)


def _render(cs, probe, fused, spp=4, batch=False):
    cfg = RenderConfig(width=48, height=36, samples_per_launch=spp, max_depth=3,
                       fused_shadows=fused, batch_spp=batch)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=48 / 36)
    r = Renderer(cs, probe, cfg, cam)
    r.render()
    return r


@pytest.mark.slow
def test_fused_matches_unfused():
    cs = _cs()
    probe = make_test_probe(32, 16)
    a = _render(cs, probe, fused=False)
    b = _render(cs, probe, fused=True)
    np.testing.assert_allclose(b.accum_image(), a.accum_image(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        float(b._last.rays_traced), float(a._last.rays_traced)
    )


def test_fused_matches_unfused_shadow_catcher():
    cs = _cs(catcher=True)
    probe = make_test_probe(32, 16)
    a = _render(cs, probe, fused=False)
    b = _render(cs, probe, fused=True)
    np.testing.assert_allclose(b.accum_image(), a.accum_image(), rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_fused_plus_batched():
    cs = _cs()
    probe = build_probe(np.full((16, 32, 3), 0.5, np.float32))
    a = _render(cs, probe, fused=False, batch=False)
    b = _render(cs, probe, fused=True, batch=True)
    np.testing.assert_allclose(b.accum_image(), a.accum_image(), rtol=5e-3, atol=5e-4)
