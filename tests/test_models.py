"""Smoke + behavior tests for the five model presets."""
import numpy as np
import pytest

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.lights.probe import build_probe
from optixpathtracer import models


def _scene_cam():
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    cs = compile_scene(hs)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=4 / 3)
    return cs, cam


def test_hello_raytracing_preset():
    cs, cam = _scene_cam()
    r = models.make_hello_renderer(cs, cam, width=64, height=48)
    img = r.render()
    assert img.shape == (48, 64, 3)
    assert img.max() > 0.05  # something lit
    rgba = r.render_rgba8()
    assert rgba.dtype == np.uint8 and rgba.shape == (48, 64, 4)
    # shadow ray darkens some lit region: image has contrast
    assert img.std() > 0.02


@pytest.mark.parametrize("tiles,want", [(50, 12), (5, 6), (None, 1), (0, 1)])
def test_whitted_dispatch_tiles_clamped(tiles, want):
    """More chunks than pixels used to loop forever looking for a divisor:
    the chunk count is clamped to the pixel count and rounded up to one that
    divides it."""
    from optixpathtracer.engine.whitted import WhittedConfig
    from optixpathtracer.models.whitted import WhittedRenderer, default_scene

    ss, cs, lights = default_scene()
    cfg = WhittedConfig(width=4, height=3, max_depth=1)
    r = WhittedRenderer(ss, cs, lights, cfg, Camera(), dispatch_tiles=tiles)
    assert r.dispatch_tiles == want
    assert sum(len(px) for px in r._px) == 12


@pytest.mark.slow
def test_whitted_preset_renders_reflections():
    r = models.make_whitted_renderer(width=96, height=72, max_depth=2)
    img = r.render()
    assert img.shape == (72, 96, 3)
    assert np.isfinite(img).all()
    # sky visible + floor lit
    assert img.max() > 0.3
    # a second accumulation frame changes nothing drastically
    img2 = r.render()
    assert abs(img2.mean() - img.mean()) < 0.2


@pytest.mark.slow
def test_disney_pt_preset():
    cs, cam = _scene_cam()
    probe = build_probe(np.full((16, 32, 3), 0.5, np.float32))
    r = models.make_disney_pt_renderer(cs, probe, cam, width=48, height=36, spp=2, max_depth=2)
    frame = r.render()
    assert frame.shape == (36, 48, 4)
    assert r.config.samples_per_launch == 2


@pytest.mark.slow
def test_spectral_preset():
    cs, cam = _scene_cam()
    probe = build_probe(np.full((16, 32, 3), 0.5, np.float32))
    r = models.make_spectral_renderer(cs, probe, cam, width=32, height=24, spp=2, max_depth=1)
    img = r.render()
    assert img.shape == (24, 32, 3)
    assert np.isfinite(img).all()


@pytest.mark.slow
def test_foveated_preset():
    from optixpathtracer.engine.foveated import FoveationConfig

    cs, cam = _scene_cam()
    probe = build_probe(np.full((16, 32, 3), 0.5, np.float32))
    r = models.make_foveated_renderer(
        cs, probe, cam, width=96, height=72, max_depth=1,
        foveation=FoveationConfig(inner_radius=12, outer_radius=30),
    )
    frame = r.render()
    assert frame.shape == (72, 96, 4)
    assert r.stats()["frames"] == 1
    # auto-fused rule: one launch at interactive sizes, 3-launch at 4K
    # (measured +16% / neutral respectively, PERF_NOTES.md)
    assert r.fused is True
    r4k = models.make_foveated_renderer(cs, probe, cam)  # default 3840x2160
    assert r4k.fused is False
