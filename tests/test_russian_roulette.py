"""Russian-roulette path termination (RenderConfig.russian_roulette).

The classic unbiased deep-path killer neither the reference nor earlier
rounds had (reference bounce loop always runs to max depth,
HelloPathtracing_original/deviceProgram.cu:412-443): after rr_start_depth,
paths survive with p = clamp(luminance(throughput), rr_min_prob, 1) and the
surviving throughput is scaled 1/p — same estimator mean, far fewer deep
rays.
"""
import dataclasses

import numpy as np

from golden_scenes import _cam, _open_scene, _sky_probe
from optixpathtracer.builder import compile_scene
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig

W, H = 48, 32


def _closed_room():
    """A closed box room with an emissive ceiling panel: every camera path
    bounces until max_depth — the population roulette is FOR."""
    hs = HostScene()
    wall = make_material(color=(0.65, 0.6, 0.55), roughness=0.8)
    hs.add_box(wall, pos=(0, -0.25, 0), extent=(4, 0.25, 4))     # floor
    hs.add_box(wall, pos=(0, 4.25, 0), extent=(4, 0.25, 4))      # ceiling
    hs.add_box(wall, pos=(-4.25, 2, 0), extent=(0.25, 4, 4))
    hs.add_box(wall, pos=(4.25, 2, 0), extent=(0.25, 4, 4))
    hs.add_box(wall, pos=(0, 2, -4.25), extent=(4, 4, 0.25))
    hs.add_box(wall, pos=(0, 2, 4.25), extent=(4, 4, 0.25))
    hs.add_box(make_material(color=(0.1, 0.1, 0.1),
                             emission=(8.0, 7.5, 7.0)),
               pos=(0, 3.95, 0), extent=(1.2, 0.05, 1.2))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2), roughness=0.5),
               pos=(-1, 0.6, -0.5), extent=(0.6, 0.6, 0.6))
    return hs


def _render(cfg, launches=2, closed=False):
    hs = _closed_room() if closed else _open_scene()
    cs = compile_scene(hs)
    probe = _sky_probe()
    cam = (_cam((2.5, 2.0, 3.2), (-0.5, 1.0, -0.5)) if closed
           else _cam((3, 2, 4), (0, 0.4, 0)))
    cam.aspect_ratio = W / H
    if closed:
        cfg = dataclasses.replace(cfg, emission_all_bounces=True)
    r = Renderer(cs, probe, cfg, cam)
    for _ in range(launches):
        r.render(download=False)
    rays = float(r._last.rays_traced)
    return r.accum_image(), rays


def test_rr_unbiased_and_cheaper():
    base = RenderConfig(width=W, height=H, samples_per_launch=8, max_depth=6,
                        clamp_radiance=1e30)
    img_off, rays_off = _render(base, closed=True)
    img_on, rays_on = _render(
        dataclasses.replace(base, russian_roulette=True), closed=True)

    # same estimator mean (paths are shared until rr_start_depth, so the
    # difference is far less noisy than two independent renders)
    m_off, m_on = float(img_off.mean()), float(img_on.mean())
    assert abs(m_on - m_off) < 0.06 * m_off, (m_on, m_off)
    assert np.isfinite(img_on).all()

    # roulette must actually kill deep rays: in the closed room every path
    # otherwise survives to depth 6 with throughput ~0.6^depth
    assert rays_on < 0.8 * rays_off, (rays_on, rays_off)


def test_rr_off_bit_identical_to_default():
    """russian_roulette=False must not perturb the estimator (no RNG draws,
    no reordering)."""
    base = RenderConfig(width=W, height=H, samples_per_launch=4, max_depth=4,
                        clamp_radiance=1e30)
    img_a, _ = _render(base, launches=1)
    img_b, _ = _render(dataclasses.replace(base, russian_roulette=False),
                       launches=1)
    np.testing.assert_array_equal(img_a, img_b)


def test_rr_start_depth_gates_shallow_paths():
    """With max_depth < rr_start_depth the roulette never fires: the traced
    ray count must be identical to the roulette-off render (the RR draw
    shifts RNG streams, so images differ by noise, but no path may be
    killed)."""
    base = RenderConfig(width=W, height=H, samples_per_launch=2, max_depth=1,
                        clamp_radiance=1e30)
    img_off, rays_off = _render(base, launches=1)
    img_on, rays_on = _render(
        dataclasses.replace(base, russian_roulette=True, rr_start_depth=2),
        launches=1)
    assert rays_on == rays_off
    assert np.isfinite(img_on).all()
