"""Full MIS (NEE + BSDF-sampled env) vs the reference's NEE-only estimator.

White-furnace-style physics check: a diffuse plane under a uniform
environment of radiance L reflects L * albedo. The NEE-only estimator with
balance-heuristic weights (reference behavior — the miss-shader env add is
commented out upstream) UNDERESTIMATES because the BSDF half of the
partition of unity never contributes. env_via_bsdf restores it.
"""
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


def _setup(env_via_bsdf, fused=False, frames=6):
    hs = HostScene()
    # big diffuse floor only: every floor point sees the full sky hemisphere
    hs.add_box(make_material(color=(0.6, 0.6, 0.6)), pos=(0, -0.1, 0), extent=(60, 0.1, 60))
    cs = compile_scene(hs)
    L = 1.0
    probe = build_probe(np.full((16, 32, 3), L, np.float32))
    cfg = RenderConfig(width=40, height=30, samples_per_launch=8, max_depth=4,
                       env_via_bsdf=env_via_bsdf, fused_shadows=fused)
    cam = Camera(eye=(0, 3, 8), lookat=(0, 0, -6), up=(0, 1, 0), fov_y=35,
                 aspect_ratio=40 / 30)
    r = Renderer(cs, probe, cfg, cam)
    for _ in range(frames):
        r.render()
    acc = r.accum_image()
    # center rows look at the floor
    return acc[12:24, 8:32].mean()


@pytest.mark.slow
def test_env_via_bsdf_recovers_furnace_energy():
    on = _setup(True)
    off = _setup(False)
    # diffuse 0.6 + the default Disney specular lobe (specular=0.5, rough 1.0)
    # puts the directional albedo somewhat above 0.6; it must never exceed 1
    assert 0.6 < on < 0.95, on
    # the reference's NEE-only estimator loses the BSDF half of the MIS
    # partition and is measurably darker
    assert off < on - 0.05, (off, on)


@pytest.mark.slow
def test_env_via_bsdf_works_fused():
    on = _setup(True, fused=True, frames=4)
    on_ref = _setup(True, fused=False, frames=4)
    np.testing.assert_allclose(on, on_ref, rtol=1e-4)
