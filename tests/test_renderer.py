"""Integration tests for the progressive wavefront renderer (tiny frames)."""
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


def _box_scene(catcher_floor=False, emissive=False):
    hs = HostScene()
    floor_mat = make_material(color=(0.8, 0.8, 0.8))
    if catcher_floor:
        floor_mat = make_material(color=(0.8, 0.8, 0.8), flags=MATERIAL_FLAG_SHADOW_CATCHER)
    hs.add_box(floor_mat, pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    box = make_material(color=(0.7, 0.3, 0.2))
    if emissive:
        box = make_material(color=(0.7, 0.3, 0.2), emission=(5.0, 4.0, 3.0))
    hs.add_box(box, pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    return compile_scene(hs)


def _uniform_probe(level=1.0, w=32, h=16):
    img = np.full((h, w, 3), level, np.float32)
    return build_probe(img)


def _renderer(cs, probe, **cfg):
    config = RenderConfig(
        width=cfg.pop("width", 64),
        height=cfg.pop("height", 48),
        samples_per_launch=cfg.pop("spp", 2),
        max_depth=cfg.pop("max_depth", 3),
        **cfg,
    )
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=config.width / config.height)
    return Renderer(cs, probe, config, cam)


@pytest.mark.slow
def test_render_finite_and_deterministic():
    r1 = _renderer(_box_scene(), _uniform_probe())
    r2 = _renderer(_box_scene(), _uniform_probe())
    f1 = r1.render()
    f2 = r2.render()
    np.testing.assert_array_equal(f1, f2)
    acc = r1.accum_image()
    assert np.all(np.isfinite(acc))
    assert np.all(acc >= 0.0)
    assert acc.max() > 0.01  # something is lit


@pytest.mark.slow
def test_progressive_accumulation_reduces_noise():
    r = _renderer(_box_scene(), _uniform_probe(), spp=1)
    r.render()
    early = r.accum_image()
    for _ in range(15):
        r.render()
    late = r.accum_image()
    # compare noise via local variance on the lit floor region
    def roughness(img):
        d = np.abs(np.diff(img, axis=1)).mean()
        return d

    assert roughness(late) < roughness(early) * 0.8
    assert r.subframe_index == 16


def test_background_is_backplate():
    probe = _uniform_probe(0.25)
    r = _renderer(_box_scene(), probe, spp=2)
    r.render()
    acc = r.accum_image()
    # top rows look at the sky -> exactly backplate level
    top = acc[:4]
    np.testing.assert_allclose(top, 0.25, atol=1e-3)


def test_emission_visible_on_primary():
    r = _renderer(_box_scene(emissive=True), _uniform_probe(1e-4), spp=2)
    r.render()
    acc = r.accum_image()
    # emissive box should be the brightest thing, roughly its emission color
    h, w = acc.shape[:2]
    center = acc[h // 2 - 4 : h // 2 + 4, w // 2 - 4 : w // 2 + 4]
    assert center.mean(axis=(0, 1))[0] > 2.0  # red channel of (5,4,3)


@pytest.mark.slow
def test_shadowing_darkens_under_light():
    """A/B: identical scene with and without a floating slab under an
    overhead disc light; the floor patch beneath the slab must darken."""
    probe = make_test_probe(64, 32, axis=(0.0, 1.0, 0.0), power=10.0)

    def floor_scene(with_slab):
        hs = HostScene()
        hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(8, 0.1, 8))
        if with_slab:
            hs.add_box(make_material(color=(0.5, 0.5, 0.5)), pos=(0, 2.5, 0), extent=(1.5, 0.05, 1.5))
        return compile_scene(hs)

    def center_floor_lum(cs):
        cfg = RenderConfig(width=64, height=48, samples_per_launch=8, max_depth=2)
        cam = Camera(eye=(5, 1.5, 5), lookat=(0, 0, 0), up=(0, 1, 0), fov_y=35,
                     aspect_ratio=64 / 48)
        r = Renderer(cs, probe, cfg, cam)
        r.render()
        r.render()
        acc = r.accum_image()
        h, w = acc.shape[:2]
        return acc[h // 2 - 3 : h // 2 + 3, w // 2 - 4 : w // 2 + 4].mean()

    open_lum = center_floor_lum(floor_scene(False))
    shadowed_lum = center_floor_lum(floor_scene(True))
    assert shadowed_lum < open_lum * 0.7, (shadowed_lum, open_lum)


def test_camera_move_resets_accumulation():
    r = _renderer(_box_scene(), _uniform_probe())
    r.render()
    r.render()
    assert r.subframe_index == 2
    r.set_camera(Camera(eye=(4, 2, 4), lookat=(0, 0, 0), up=(0, 1, 0), fov_y=45))
    assert r.subframe_index == 0


def test_aovs_present():
    r = _renderer(_box_scene(), _uniform_probe())
    r.render()
    aov = r.aovs()
    assert set(aov) == {"normal", "albedo", "alpha", "depth"}
    # depth: positive at hits, zero on background, (H, W) scalar plane
    assert aov["depth"].ndim == 2
    assert aov["depth"].max() > 0.0
    # hit pixels have unit-ish normals, background zeros
    nlen = np.linalg.norm(aov["normal"], axis=-1)
    assert nlen.max() < 1.01
    assert (nlen > 0.99).any()
    assert aov["alpha"].max() <= 1.0 + 1e-5


def test_checkpoint_roundtrip(tmp_path):
    r = _renderer(_box_scene(), _uniform_probe())
    r.render()
    r.render()
    path = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(path)

    r2 = _renderer(_box_scene(), _uniform_probe())
    r2.load_checkpoint(path)
    assert r2.subframe_index == 2
    np.testing.assert_allclose(r2.accum_image(), r.accum_image(), rtol=1e-6)
    # continuing both produces identical frames (exact resume)
    f1 = r.render()
    f2 = r2.render()
    np.testing.assert_array_equal(f1, f2)


def test_stats_structure():
    r = _renderer(_box_scene(), _uniform_probe())
    r.render()
    s = r.stats()
    assert s["frames"] == 1 and s["fps"] > 0 and s["total_spp"] == 2


@pytest.mark.slow
def test_sort_rays_bit_identical():
    """Ray-stream coherence sorting (cfg.sort_rays) must not change a single
    bit of the output: it permutes the wavefront before each bounce's
    traversal and restores caller order afterwards, and every per-ray op is
    order-independent."""
    cs = _box_scene()
    probe = _uniform_probe()
    base = dict(width=48, height=32, spp=2, max_depth=3, traversal="lockstep")
    f_plain = _renderer(cs, probe, **base).render()
    f_sorted = _renderer(cs, probe, sort_rays=True, **base).render()
    np.testing.assert_array_equal(f_plain, f_sorted)


@pytest.mark.slow
def test_sort_rays_bit_identical_fused():
    cs = _box_scene()
    probe = _uniform_probe()
    base = dict(width=48, height=32, spp=1, max_depth=2, traversal="lockstep",
                fused_shadows=True)
    f_plain = _renderer(cs, probe, **base).render()
    f_sorted = _renderer(cs, probe, sort_rays=True, **base).render()
    np.testing.assert_array_equal(f_plain, f_sorted)
