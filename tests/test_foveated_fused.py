"""Fused single-launch foveation == the reference's three sequential
launches.

The fused mode concatenates all three zones' expanded sample lanes into one
wavefront with explicit per-lane RNG counters (subframe * zone_spp + s —
exactly the streams the 3-launch mode derives), so the two modes compute
identical estimators; with antialias off every per-lane quantity matches and
the images must agree to float precision. With AA, per-pixel compositing
order differs only at mixed-coverage edge pixels (per-lane backplate
compositing vs the batch fold's spp-mean), so interiors still match tightly.
"""
import numpy as np
import pytest

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.engine.foveated import FoveatedRenderer, FoveationConfig
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.lights.probe import build_probe


def _setup(antialias: bool):
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    cs = compile_scene(hs)
    probe = build_probe(np.full((16, 32, 3), 0.5, np.float32))
    cfg = RenderConfig(
        width=96, height=72, max_depth=2, antialias=antialias, batch_spp=True
    )
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=96 / 72)
    fov = FoveationConfig(inner_radius=12, outer_radius=30)
    return cs, probe, cfg, cam, fov


def _render_pair(antialias: bool, frames: int):
    cs, probe, cfg, cam, fov = _setup(antialias)
    imgs, rays = [], []
    for fused in (False, True):
        fr = FoveatedRenderer(cs, probe, cfg, cam, fov, fused=fused)
        fr.set_gaze(48, 36)
        for _ in range(frames):
            fr.render()
        imgs.append(fr.accum_image())
        rays.append(fr.last_rays)
    return imgs, rays


@pytest.mark.slow
def test_fused_matches_three_launches_exactly_no_aa():
    (ia, ib), (ra, rb) = _render_pair(antialias=False, frames=3)
    np.testing.assert_allclose(ib, ia, rtol=1e-5, atol=1e-5)
    # identical lanes traced -> identical exact ray counts
    assert ra == rb, (ra, rb)


@pytest.mark.slow
def test_fused_matches_three_launches_with_aa():
    (ia, ib), (ra, rb) = _render_pair(antialias=True, frames=2)
    assert ra == rb, (ra, rb)
    diff = np.abs(ia - ib).max(-1)
    # same RNG streams: everywhere but mixed-coverage AA edge pixels the
    # per-lane and batch-fold composites are algebraically identical
    assert (diff < 1e-4).mean() > 0.97, (diff < 1e-4).mean()
    assert diff.max() < 0.5, diff.max()


def test_fused_matches_three_launches_fast():
    """Small fast-tier variant: exact no-AA bit-identity at 48x32 (ADVICE r3)."""
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 0.5, np.float32))
    cfg = RenderConfig(width=48, height=32, max_depth=1, antialias=False,
                       batch_spp=True)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=48 / 32)
    fov = FoveationConfig(inner_radius=8, outer_radius=16)
    imgs, rays = [], []
    for fused in (False, True):
        fr = FoveatedRenderer(cs, probe, cfg, cam, fov, fused=fused)
        fr.set_gaze(24, 16)
        fr.render()
        imgs.append(fr.accum_image())
        rays.append(fr.last_rays)
    np.testing.assert_allclose(imgs[1], imgs[0], rtol=1e-5, atol=1e-5)
    assert rays[0] == rays[1], rays
