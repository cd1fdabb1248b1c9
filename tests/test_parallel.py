"""Multi-device tests on the virtual 8-CPU mesh (SURVEY.md §4 item 4)."""
import numpy as np
import pytest
import jax

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.lights.probe import build_probe
from optixpathtracer.parallel.tiles import DistributedRenderer, TileLayout, make_mesh


def _scene():
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    return compile_scene(hs)


def _probe():
    return build_probe(np.full((16, 32, 3), 0.5, np.float32))


def _cfg(w=64, h=48):
    return RenderConfig(width=w, height=h, samples_per_launch=2, max_depth=2)


def _cam(cfg):
    return Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                  aspect_ratio=cfg.width / cfg.height)


def test_tile_layout_interleaves_and_inverts():
    lay = TileLayout.build(8, 16, 4)
    # each device owns 4 rows, round-robin
    rows_per_dev = lay.pixel_y.reshape(4, -1)
    assert set(rows_per_dev[0][:: 8 * 0 + 8]) == {0, 4, 8, 12}
    # inverse really inverts
    n = 8 * 16
    perm = lay.pixel_y.astype(np.int64) * 8 + lay.pixel_x
    np.testing.assert_array_equal(perm[lay.inverse], np.arange(n))


@pytest.mark.slow
def test_distributed_matches_single_device():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    cs = _scene()
    probe = _probe()
    cfg = _cfg()
    cam = _cam(cfg)

    single = Renderer(cs, probe, cfg, cam)
    single.render()
    single.render()

    dist = DistributedRenderer(cs, probe, cfg, cam, mesh=make_mesh())
    dist.render()
    dist.render()

    np.testing.assert_allclose(
        dist.accum_image(), single.accum_image(), rtol=2e-4, atol=2e-5
    )
    assert dist.last_rays > 0


@pytest.mark.slow
def test_distributed_ray_count_psum():
    cs = _scene()
    cfg = _cfg(64, 64)
    dist = DistributedRenderer(cs, _probe(), cfg, _cam(cfg), mesh=make_mesh())
    dist.render()
    # at least one radiance ray per pixel per sample
    assert dist.last_rays >= 64 * 64 * cfg.samples_per_launch
