"""Demand-loaded textures as a first-class ENGINE path: Renderer(demand=mgr)
shades from the sparse pool, every launch's page-usage bitmap is serviced
between launches, and the SETTLE loop retries a launch (same subframe/RNG)
until its working set is resident — so the progressive mean contains no
fallback-shaded samples and equals the resident-TexturePool render EXACTLY
(both are wrap bilinear; only the storage differs). The reference's
DemandLoader launchPrepare/processRequests cycle (lib/DemandLoading
DemandLoaderImpl — dead code upstream) as a live render loop.
"""
import jax
import numpy as np
import pytest

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.math import Vec3
from optixpathtracer.core.scene import HostScene, Mesh
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.io.demand import DemandTextureManager, TILE
from optixpathtracer.lights.probe import build_probe


def _textured_scene(tex_size=3 * TILE):
    rng = np.random.default_rng(23)
    tex = rng.uniform(0, 1, (tex_size, tex_size, 3)).astype(np.float32)
    hs = HostScene()
    tid = hs.add_texture(tex)
    quad = Mesh(
        vertices=np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=np.array([[0, 1, 0]] * 4, np.float32),
        texcoords=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        material=make_material(color=(1, 1, 1), texture_id=tid),
    )
    hs.add_mesh(quad)
    hs.add_box(make_material(color=(0.8, 0.4, 0.2), roughness=0.4),
               pos=(0, 0.4, 0), extent=(0.4, 0.4, 0.4))
    return hs


def _cfg(**kw):
    return RenderConfig(width=40, height=32, samples_per_launch=2, max_depth=2,
                        **kw)


def _setup(hs, demand=None, cfg=None):
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 1.0, np.float32))
    cam = Camera(eye=(0, 4, 3), lookat=(0, 0, 0), up=(0, 1, 0), fov_y=60,
                 aspect_ratio=40 / 32)
    return Renderer(cs, probe, cfg or _cfg(), cam, demand=demand)


@pytest.mark.slow
def test_demand_settle_makes_frame0_exact():
    """The settle loop retries frame 0 until pages are resident, so even the
    FIRST progressive frame matches the resident-TexturePool render exactly
    (identical RNG streams, identical texels)."""
    hs = _textured_scene()
    mgr = DemandTextureManager.from_host_scene(hs, capacity=64)
    r_demand = _setup(hs, demand=mgr)
    r_resident = _setup(hs)
    r_demand.render()
    r_resident.render()
    assert mgr.pages_loaded > 0
    np.testing.assert_allclose(
        r_demand.accum_image(), r_resident.accum_image(), atol=1e-5
    )
    # steady state: the next frame loads nothing new
    before = mgr.pages_loaded
    r_demand.render()
    r_resident.render()
    assert mgr.pages_loaded == before
    np.testing.assert_allclose(
        r_demand.accum_image(), r_resident.accum_image(), atol=1e-5
    )


def test_demand_no_settle_shows_fallback_then_converges():
    """demand_settle=False reproduces the reference's render-with-what's-
    resident behavior: frame 0 visibly shades fallback colors; once pages
    are in, later launches shade exact texels."""
    hs = _textured_scene()
    mgr = DemandTextureManager.from_host_scene(hs, capacity=64)
    r = _setup(hs, demand=mgr)
    r.demand_settle = False
    r.render()
    ref = _setup(hs)
    ref.render()
    assert float(np.abs(r.accum_image() - ref.accum_image()).max()) > 1e-3
    # pages were serviced; a fresh accumulation now matches exactly
    r.accum = Vec3.zeros((40 * 32,))
    r.subframe_index = 0
    r.render()
    np.testing.assert_allclose(r.accum_image(), ref.accum_image(), atol=1e-5)


def test_demand_checkpoint_resume_unbiased():
    """Checkpoint resume with an EMPTY pool must not tint the converged
    accumulation: the settle loop re-pages before folding the resumed
    launch in (the review's worst-case scenario)."""
    hs = _textured_scene()
    mgr = DemandTextureManager.from_host_scene(hs, capacity=64)
    r = _setup(hs, demand=mgr)
    r.render()
    r.render()
    ck = "/tmp/demand_ck_test"
    r.save_checkpoint(ck)

    ref = _setup(hs)
    ref.render()
    ref.render()
    ref.render()

    mgr2 = DemandTextureManager.from_host_scene(hs, capacity=64)  # empty pool
    r2 = _setup(hs, demand=mgr2)
    r2.load_checkpoint(ck)
    assert r2.subframe_index == 2
    r2.render()  # must settle pages BEFORE accumulating subframe 2
    np.testing.assert_allclose(r2.accum_image(), ref.accum_image(), atol=1e-5)


@pytest.mark.slow
def test_demand_render_multi_tile_dispatch_ors_usage():
    """dispatch_tiles > 1: per-chunk usage bitmaps OR together (not concat)
    and settle still produces the exact frame."""
    hs = _textured_scene()
    mgr = DemandTextureManager.from_host_scene(hs, capacity=64)
    r = _setup(hs, demand=mgr, cfg=_cfg(dispatch_tiles=2))
    r.render()
    assert r._last.tex_usage.shape == (mgr.num_pages,)
    assert mgr.pages_loaded > 0
    r_ref = _setup(hs)
    r_ref.render()
    np.testing.assert_allclose(r.accum_image(), r_ref.accum_image(), atol=1e-5)


@pytest.mark.slow
def test_demand_render_distributed_matches_single_device():
    """Demand textures over the device mesh: per-shard usage bitmaps
    OR-reduce across 'tiles' (one psum/frame), the single host pager
    services the union, and the settled sharded render equals the
    resident-TexturePool render exactly."""
    from optixpathtracer.parallel.tiles import DistributedRenderer, make_mesh

    hs = _textured_scene()
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 1.0, np.float32))
    cfg = _cfg()
    cam = Camera(eye=(0, 4, 3), lookat=(0, 0, 0), up=(0, 1, 0), fov_y=60,
                 aspect_ratio=40 / 32)

    mgr_d = DemandTextureManager.from_host_scene(hs, capacity=64)
    dist = DistributedRenderer(cs, probe, cfg, cam, mesh=make_mesh(),
                               demand=mgr_d)
    dist.render()
    assert mgr_d.pages_loaded > 0

    # union working set == the single wavefront's (same pixels/streams)
    mgr_s = DemandTextureManager.from_host_scene(hs, capacity=64)
    single = _setup(hs, demand=mgr_s)
    single.render()
    assert mgr_d.pages_loaded == mgr_s.pages_loaded

    r_ref = _setup(hs)
    r_ref.render()
    np.testing.assert_allclose(dist.accum_image(), r_ref.accum_image(),
                               atol=1e-5)


@pytest.mark.slow
def test_demand_settle_bounded_when_pool_too_small():
    """A working set larger than the pool can never settle: the renderer
    accepts a best-effort launch instead of retrying forever."""
    hs = _textured_scene(tex_size=6 * TILE)  # 36 base pages visible-ish
    mgr = DemandTextureManager.from_host_scene(hs, capacity=4)
    r = _setup(hs, demand=mgr)
    r.render()  # must terminate (bounded), pages were still serviced
    assert mgr.pages_loaded > 0
    assert r.subframe_index == 1


@pytest.mark.slow
def test_demand_engine_mip_lod_uses_coarse_pages():
    """With a multi-level pool the engine derives a per-hit mip LOD from the
    path-length footprint x triangle texel density: a ground plane receding
    to the horizon must touch level>0 pages, and the settled render stays
    close to the resident (base-level) render."""
    rng = np.random.default_rng(37)
    # big plane, dense texture -> far pixels have footprints >> 1 texel
    tex = rng.uniform(0.2, 0.8, (4 * TILE, 4 * TILE, 3)).astype(np.float32)
    hs = HostScene()
    tid = hs.add_texture(tex)
    s = 120.0
    hs.add_mesh(Mesh(
        vertices=np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]],
                          np.float32),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=np.array([[0, 1, 0]] * 4, np.float32),
        texcoords=np.array([[0, 0], [40, 0], [40, 40], [0, 40]], np.float32),
        material=make_material(color=(1, 1, 1), texture_id=tid),
    ))
    mgr = DemandTextureManager.from_host_scene(hs, capacity=256, levels=4)
    cfg = RenderConfig(width=64, height=40, samples_per_launch=1, max_depth=1)
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 1.0, np.float32))
    cam = Camera(eye=(0, 1.5, 8), lookat=(0, 0.5, 0), up=(0, 1, 0), fov_y=50,
                 aspect_ratio=64 / 40)
    r = Renderer(cs, probe, cfg, cam, demand=mgr)
    r.render()
    usage = np.asarray(r._last.tex_usage)
    lvls = set(np.asarray(mgr._page_lvl)[np.nonzero(usage)[0]].tolist())
    assert any(l > 0 for l in lvls), f"no coarse mip pages touched: {lvls}"
    img = r.accum_image()
    assert np.isfinite(img).all()
    # mip filtering changes high-frequency content, not overall brightness
    r_ref = Renderer(cs, probe, cfg, cam)
    r_ref.render()
    a, b = img.mean(), r_ref.accum_image().mean()
    assert abs(a - b) / max(b, 1e-6) < 0.1, (a, b)
