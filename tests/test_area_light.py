"""Parallelogram-light NEE: converges to the same image as brute-force
emitter sampling, with far less noise (the point of NEE)."""
import numpy as np
import pytest

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.lights.lights import QuadLight
from optixpathtracer.lights.probe import build_probe


def _scene():
    hs = HostScene()
    hs.add_box(make_material(color=(0.7, 0.7, 0.7)), pos=(0, -0.1, 0), extent=(4, 0.1, 4))
    hs.add_box(make_material(color=(0.6, 0.2, 0.2)), pos=(0, 0.4, 0), extent=(0.4, 0.4, 0.4))
    # emissive panel floating above (also geometry so BSDF paths can hit it)
    hs.add_box(make_material(color=(0.8, 0.8, 0.8), emission=(12.0, 12.0, 12.0)),
               pos=(0.0, 2.5, 0.0), extent=(0.6, 0.02, 0.6))
    return compile_scene(hs)


def _render(area_light, frames, spp=4):
    cs = _scene()
    probe = build_probe(np.full((8, 16, 3), 1e-5, np.float32))
    cfg = RenderConfig(width=48, height=36, samples_per_launch=spp, max_depth=3,
                       emission_all_bounces=True)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.5, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=48 / 36)
    light = QuadLight.make(
        corner=(-0.6, 2.48, -0.6), v1=(1.2, 0, 0), v2=(0, 0, 1.2),
        emission=(12.0, 12.0, 12.0),
    ) if area_light else None
    r = Renderer(cs, probe, cfg, cam, area_light=light)
    for _ in range(frames):
        r.render()
    return r.accum_image()


@pytest.mark.slow
def test_quad_nee_unbiased_vs_brute_force():
    nee = _render(True, frames=6)
    bf = _render(False, frames=30)
    # same lighting integral: overall means agree within MC noise
    assert abs(nee.mean() - bf.mean()) / bf.mean() < 0.12, (nee.mean(), bf.mean())


def test_quad_nee_reduces_noise():
    a = _render(True, frames=2)
    bf = _render(False, frames=2)

    def roughness(img):
        # pixel-to-pixel variation on the flat floor region (bottom third)
        floor = img[24:, 4:44]
        return np.abs(np.diff(floor, axis=1)).mean()

    assert roughness(a) < roughness(bf) * 0.6, (roughness(a), roughness(bf))
