import numpy as np
import pytest

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.engine.foveated import FoveatedRenderer, FoveationConfig
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.lights.probe import build_probe


def _scene():
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    return compile_scene(hs)


def _probe():
    return build_probe(np.full((16, 32, 3), 0.5, np.float32))


def _small_fov():
    # scaled-down radii for a 96x72 test frame
    return FoveationConfig(inner_radius=12, outer_radius=30)


@pytest.mark.slow
def test_foveated_covers_frame_and_matches_uniform_roughly():
    from optixpathtracer.core.math import Vec3
    import jax.numpy as jnp

    cs = _scene()
    probe = _probe()
    cfg = RenderConfig(width=96, height=72, max_depth=2)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=96 / 72)

    fr = FoveatedRenderer(cs, probe, cfg, cam, _small_fov())
    fr.set_gaze(48, 36)
    # sentinel framebuffer: every pixel must be WRITTEN by some zone
    n = cfg.width * cfg.height
    fr.accum = Vec3.full((n,), -7.0)
    fr.render()
    written = fr.accum_image() > -6.9
    assert written.all(-1).mean() > 0.995, written.mean()

    # accumulate a few frames (periphery is 1 spp progressive by design)
    fr.accum = Vec3.zeros((n,))
    fr.subframe_index = 0
    for _ in range(6):
        fr.render()
    fov_img = fr.accum_image()

    uni = Renderer(cs, probe,
                   RenderConfig(width=96, height=72, max_depth=2, samples_per_launch=8),
                   cam)
    uni.render()
    uni.render()
    uni_img = uni.accum_image()

    # fovea region (full res, 8 spp): patch means agree
    cy, cx = 36, 48
    f_patch = fov_img[cy - 8 : cy + 8, cx - 8 : cx + 8]
    u_patch = uni_img[cy - 8 : cy + 8, cx - 8 : cx + 8]
    assert abs(f_patch.mean() - u_patch.mean()) / u_patch.mean() < 0.1
    # whole-frame means agree loosely (periphery lower res + fewer samples)
    assert abs(fov_img.mean() - uni_img.mean()) / uni_img.mean() < 0.15


def test_foveated_ray_budget_smaller_than_uniform():
    cs = _scene()
    probe = _probe()
    cfg = RenderConfig(width=96, height=72, max_depth=2)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=96 / 72)
    fr = FoveatedRenderer(cs, probe, cfg, cam, _small_fov())
    fr.render()
    uni = Renderer(cs, probe,
                   RenderConfig(width=96, height=72, max_depth=2, samples_per_launch=8),
                   cam)
    uni.render()
    uni_rays = float(uni._last.rays_traced)
    assert fr.last_rays < uni_rays * 0.45, (fr.last_rays, uni_rays)


@pytest.mark.slow
def test_gaze_moves_fovea():
    cs = _scene()
    cfg = RenderConfig(width=96, height=72, max_depth=1)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=96 / 72)
    fr = FoveatedRenderer(cs, _probe(), cfg, cam, _small_fov())
    fr.set_gaze(20, 20)
    fr.render()
    img = fr.accum_image()
    assert np.all(np.isfinite(img))
    assert fr.stats()["frames"] == 1
