"""Demand-loaded sparse textures (io/demand.py) — the array-native equivalent of the
reference's disabled DemandLoading/ImageSource libraries.

Contract under test (DemandLoader.h:30-60 semantics):
* non-resident sample -> fallback color + page request bit
* after process_requests, the same sample is resident and EXACTLY equals
  full-image wrap bilinear (gutter texels make tile-local bilinear exact)
* LRU eviction under a tiny pool keeps serving (re-request after evict)
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optixpathtracer.io.demand import (
    STORE,
    TILE,
    ArraySource,
    CheckerBoardSource,
    DemandTextureManager,
    MandelbrotSource,
    sample_demand,
)


def ref_bilinear(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Full-image wrap bilinear, float32 math (mirrors TexturePool)."""
    h, w = img.shape[:2]
    uu = (u.astype(np.float32) % np.float32(1.0)) * np.float32(w) - np.float32(0.5)
    vv = (v.astype(np.float32) % np.float32(1.0)) * np.float32(h) - np.float32(0.5)
    x0 = np.floor(uu)
    y0 = np.floor(vv)
    fx = (uu - x0)[:, None]
    fy = (vv - y0)[:, None]

    def at(x, y):
        return img[np.mod(y.astype(np.int64), h), np.mod(x.astype(np.int64), w)]

    c00 = at(x0, y0)
    c10 = at(x0 + 1, y0)
    c01 = at(x0, y0 + 1)
    c11 = at(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


@pytest.fixture(scope="module")
def mgr_and_img():
    rng = np.random.default_rng(7)
    # deliberately NOT a multiple of TILE on either axis
    img = rng.uniform(0, 1, (130, 200, 3)).astype(np.float32)
    return DemandTextureManager([ArraySource(img)], capacity=64), img


def _uvs(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, n).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32))


def test_miss_then_resident_exact(mgr_and_img):
    mgr, img = mgr_and_img
    u, v = _uvs()
    tid = jnp.zeros(u.shape, jnp.int32)
    sample = jax.jit(sample_demand)

    color, resident, req = sample(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v))
    assert not bool(np.asarray(resident).any())
    # miss color == the texture's fallback (mean probe)
    fb = np.asarray(mgr.pool.fallback[0])
    np.testing.assert_allclose(np.asarray(color.x), fb[0], rtol=1e-6)
    n_req = int(np.asarray(req).sum())
    assert n_req > 0
    loaded = mgr.process_requests(req)
    assert loaded == n_req

    color2, resident2, req2 = sample(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v))
    assert bool(np.asarray(resident2).all())
    # usage bitmap still reports the touched (now-resident) pages, but
    # servicing it loads nothing new
    assert int(np.asarray(req2).sum()) == n_req
    assert mgr.process_requests(req2) == 0
    ref = ref_bilinear(img, u, v)
    got = np.stack([np.asarray(color2.x), np.asarray(color2.y), np.asarray(color2.z)], -1)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_wrap_seams_exact(mgr_and_img):
    mgr, img = mgr_and_img
    # u/v straddling the wrap seam and tile boundaries
    eps = np.float32(1e-4)
    u = np.array([0.0 + eps, 1.0 - eps, 0.5, TILE / 200 + eps, TILE / 200 - eps],
                 np.float32)
    v = np.array([1.0 - eps, 0.0 + eps, TILE / 130, 0.7, 0.3], np.float32)
    tid = jnp.zeros(u.shape, jnp.int32)
    _, _, req = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v))
    mgr.process_requests(req)
    color, resident, _ = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v))
    assert bool(np.asarray(resident).all())
    ref = ref_bilinear(img, u, v)
    got = np.stack([np.asarray(color.x), np.asarray(color.y), np.asarray(color.z)], -1)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_negative_texid_white_no_request(mgr_and_img):
    mgr, _ = mgr_and_img
    u, v = _uvs(64)
    tid = jnp.full(u.shape, -1, jnp.int32)
    color, resident, req = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v))
    assert not bool(np.asarray(resident).any())
    assert int(np.asarray(req).sum()) == 0
    np.testing.assert_allclose(np.asarray(color.x), 1.0)


def test_lru_eviction_keeps_serving():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (4 * TILE, 4 * TILE, 3)).astype(np.float32)  # 16 pages
    mgr = DemandTextureManager([ArraySource(img)], capacity=4)
    u, v = _uvs(512, seed=1)
    tid = jnp.zeros(u.shape, jnp.int32)
    total_pages = mgr.num_pages
    assert total_pages == 16
    for _ in range(8):
        _, _, req = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v))
        if not mgr.process_requests(req):
            break
    # pool can never hold all 16 pages: eviction must have happened and the
    # table never exceeds capacity
    assert mgr.pages_evicted > 0
    assert (np.asarray(mgr.pool.page_table) >= 0).sum() <= 4
    # resident pages still sample exactly
    color, resident, _ = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v))
    res = np.asarray(resident)
    assert res.any()
    ref = ref_bilinear(img, u, v)
    got = np.stack([np.asarray(color.x), np.asarray(color.y), np.asarray(color.z)], -1)
    np.testing.assert_allclose(got[res], ref[res], atol=1e-5)


def test_multi_texture_page_spaces():
    rng = np.random.default_rng(5)
    img_a = rng.uniform(0, 1, (TILE, TILE, 3)).astype(np.float32)
    img_b = rng.uniform(0, 1, (2 * TILE, TILE, 3)).astype(np.float32)
    mgr = DemandTextureManager([ArraySource(img_a), ArraySource(img_b)], capacity=8)
    assert mgr.num_pages == 3
    u, v = _uvs(256, seed=9)
    tid = jnp.asarray((np.arange(256) % 2).astype(np.int32))
    _, _, req = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v))
    mgr.process_requests(req)
    color, resident, _ = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v))
    assert bool(np.asarray(resident).all())
    got = np.stack([np.asarray(color.x), np.asarray(color.y), np.asarray(color.z)], -1)
    t = np.asarray(tid)
    np.testing.assert_allclose(got[t == 0], ref_bilinear(img_a, u[t == 0], v[t == 0]), atol=1e-5)
    np.testing.assert_allclose(got[t == 1], ref_bilinear(img_b, u[t == 1], v[t == 1]), atol=1e-5)


def test_procedural_sources():
    cb = CheckerBoardSource(width=256, height=256, squares_per_side=8)
    blk = cb.read_texel_block(np.arange(-1, STORE - 1), np.arange(-1, STORE - 1))
    assert blk.shape == (STORE, STORE, 3)
    # square size 32: texels 0..31 one color, 32 flips
    row = cb.read_texel_block(np.array([0, 31, 32]), np.array([0]))
    assert np.allclose(row[0, 0], row[0, 1]) and not np.allclose(row[0, 0], row[0, 2])
    mb = MandelbrotSource(width=128, height=128, max_iter=16)
    blk2 = mb.read_texel_block(np.arange(0, 64), np.arange(0, 64))
    assert blk2.shape == (64, 64, 3) and np.isfinite(blk2).all()
    # interior of the set escapes never -> t == 1 at (re, im) ~ (-0.2, 0)
    x = int((-0.2 + 2.2) / 3.2 * 128)
    y = int((0.0 + 1.6) / 3.2 * 128)
    t = mb.read_texel_block(np.array([x]), np.array([y]))[0, 0, 0]
    assert t == 1.0


def test_feedback_loop_converges_with_capacity():
    """Render-loop shape: repeated sample -> request -> load passes converge
    to full residency when capacity suffices (the reference's launch-prepare/
    launch-process cycle, DemandLoaderImpl)."""
    cb = CheckerBoardSource(width=8 * TILE, height=8 * TILE, squares_per_side=8)
    mgr = DemandTextureManager([cb], capacity=70)
    u, v = _uvs(8192, seed=11)
    tid = jnp.zeros(u.shape, jnp.int32)
    passes = 0
    while True:
        _, resident, req = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v))
        if bool(np.asarray(resident).all()):
            break
        assert mgr.process_requests(req) > 0
        passes += 1
        assert passes <= 3, "feedback loop failed to converge"
    assert passes == 1  # one service pass is enough at this capacity


def test_lru_hot_pages_survive_eviction():
    """TRUE LRU: resident pages touched every launch must outlive idle ones.
    capacity 3, working set {A hot, B idle}, then two new pages arrive —
    the idle page is evicted first, the hot page stays resident."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (2 * TILE, 2 * TILE, 3)).astype(np.float32)  # 4 pages
    mgr = DemandTextureManager([ArraySource(img)], capacity=3)
    tid = jnp.zeros((8,), jnp.int32)

    def uv_for_page(px, py):  # sample well inside page (px, py)
        u = (px * TILE + TILE / 2) / img.shape[1]
        v = (py * TILE + TILE / 2) / img.shape[0]
        return jnp.full((8,), u, jnp.float32), jnp.full((8,), v, jnp.float32)

    # load A=(0,0) and B=(1,0)
    for px in (0, 1):
        u, v = uv_for_page(px, 0)
        _, _, req = sample_demand(mgr.pool, tid, u, v)
        mgr.process_requests(req)
    page_a, page_b = 0, 1
    assert mgr._page_table[page_a] >= 0 and mgr._page_table[page_b] >= 0
    # touch A (resident) for a few launches; B stays idle
    for _ in range(3):
        u, v = uv_for_page(0, 0)
        _, resident, req = sample_demand(mgr.pool, tid, u, v)
        assert bool(np.asarray(resident).all())
        mgr.process_requests(req)  # refreshes A's tick, loads nothing
    # now fault in two NEW pages (fills slot 3, then must evict someone)
    for px in (0, 1):
        u, v = uv_for_page(px, 1)
        _, _, req = sample_demand(mgr.pool, tid, u, v)
        mgr.process_requests(req)
    assert mgr._page_table[page_a] >= 0, "hot page was evicted (not LRU)"
    assert mgr._page_table[page_b] < 0, "idle page should have been evicted"


def _box_mip(img, level):
    k = 1 << level
    h, w = img.shape[:2]
    return img.reshape(h // k, k, w // k, k, 3).mean((1, 3)).astype(np.float32)


def test_mip_levels_exact_and_clamped():
    """Mip pyramid: level l sampling equals wrap-bilinear over the exact
    2^l box-filtered image (POT dims); out-of-range lod clamps to the
    coarsest level (the reference's mip-aware DemandLoading contract)."""
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 1, (256, 256, 3)).astype(np.float32)
    mgr = DemandTextureManager([ArraySource(img)], capacity=64, levels=3)
    assert int(np.asarray(mgr.pool.levels)[0]) == 3
    u, v = _uvs(2048, seed=13)
    tid = jnp.zeros(u.shape, jnp.int32)

    for level in (0, 1, 2):
        lod = jnp.full(u.shape, float(level), jnp.float32)
        _, _, req = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v), lod)
        mgr.process_requests(req)
        color, resident, _ = sample_demand(
            mgr.pool, tid, jnp.asarray(u), jnp.asarray(v), lod
        )
        assert bool(np.asarray(resident).all()), f"level {level} not resident"
        ref = ref_bilinear(_box_mip(img, level), u, v)
        got = np.stack([np.asarray(color.x), np.asarray(color.y),
                        np.asarray(color.z)], -1)
        np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=f"level {level}")

    # lod beyond the chain clamps to the coarsest level
    hi = jnp.full(u.shape, 9.0, jnp.float32)
    c_hi, res_hi, req_hi = sample_demand(
        mgr.pool, tid, jnp.asarray(u), jnp.asarray(v), hi
    )
    assert bool(np.asarray(res_hi).all())  # coarsest already resident
    ref2 = ref_bilinear(_box_mip(img, 2), u, v)
    got2 = np.stack([np.asarray(c_hi.x), np.asarray(c_hi.y), np.asarray(c_hi.z)], -1)
    np.testing.assert_allclose(got2, ref2, atol=1e-5)


def test_mip_coarse_levels_fit_tiny_pools():
    """The point of mips: a coarse level's whole page set fits a pool that
    the base level overflows — distant/minified lookups stay resident."""
    cb = CheckerBoardSource(width=16 * TILE, height=16 * TILE, squares_per_side=16)
    mgr = DemandTextureManager([cb], capacity=6, levels=5)
    # base level: 16x16 = 256 pages >> capacity; level 4: 1 page
    u, v = _uvs(4096, seed=17)
    tid = jnp.zeros(u.shape, jnp.int32)
    lod = jnp.full(u.shape, 4.0, jnp.float32)
    _, _, req = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v), lod)
    assert int(np.asarray(req).sum()) <= 6
    mgr.process_requests(req)
    _, resident, _ = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v), lod)
    assert bool(np.asarray(resident).all())
    # procedural mip is the exact box filter of the base function
    lvl_dim = (16 * TILE) >> 4
    base = cb.read_texel_block(np.arange(16 * TILE), np.arange(16 * TILE))
    ref_img = base.reshape(lvl_dim, 16, lvl_dim, 16, 3).mean((1, 3)).astype(np.float32)
    color, _, _ = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v), lod)
    got = np.stack([np.asarray(color.x), np.asarray(color.y), np.asarray(color.z)], -1)
    np.testing.assert_allclose(got, ref_bilinear(ref_img, u, v), atol=1e-5)


def test_trilinear_blends_bracketing_levels():
    """trilinear=True: integer lod equals nearest-level sampling; fractional
    lod equals the manual (1-f)*level0 + f*level1 blend."""
    rng = np.random.default_rng(19)
    img = rng.uniform(0, 1, (256, 256, 3)).astype(np.float32)
    mgr = DemandTextureManager([ArraySource(img)], capacity=96, levels=3)
    u, v = _uvs(1024, seed=21)
    tid = jnp.zeros(u.shape, jnp.int32)
    # make levels 0..2 resident
    for level in (0.0, 1.0, 2.0):
        lod = jnp.full(u.shape, level, jnp.float32)
        _, _, req = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v), lod)
        mgr.process_requests(req)

    def rgb(c):
        return np.stack([np.asarray(c.x), np.asarray(c.y), np.asarray(c.z)], -1)

    for level in (0.0, 1.0, 2.0):  # integer lod: tri == nearest
        lod = jnp.full(u.shape, level, jnp.float32)
        a, ra, _ = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v),
                                 lod, trilinear=True)
        b, rb, _ = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v), lod)
        assert bool(np.asarray(ra).all()) and bool(np.asarray(rb).all())
        np.testing.assert_allclose(rgb(a), rgb(b), atol=1e-6)

    lod = jnp.full(u.shape, 0.75, jnp.float32)
    c, res, usage = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v),
                                  lod, trilinear=True)
    assert bool(np.asarray(res).all())
    r0 = ref_bilinear(_box_mip(img, 0), u, v)
    r1 = ref_bilinear(_box_mip(img, 1), u, v)
    np.testing.assert_allclose(rgb(c), 0.25 * r0 + 0.75 * r1, atol=1e-5)
    # both levels' pages are reported used (level-0 base grid spans >1 page)
    lvls = np.asarray(mgr._page_lvl)[np.nonzero(np.asarray(usage))[0]]
    assert set(lvls.tolist()) == {0, 1}


def test_trilinear_partial_residency_uses_resident_level():
    """When only ONE bracketing mip level is resident, trilinear sampling
    uses that level alone (the reference shades from the finest RESIDENT
    level) instead of dropping to the flat fallback color."""
    rng = np.random.default_rng(29)
    img = rng.uniform(0, 1, (256, 256, 3)).astype(np.float32)
    mgr = DemandTextureManager([ArraySource(img)], capacity=96, levels=3)
    u, v = _uvs(512, seed=31)
    tid = jnp.zeros(u.shape, jnp.int32)
    # make ONLY level 1 resident
    lod1 = jnp.full(u.shape, 1.0, jnp.float32)
    _, _, req = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v), lod1)
    mgr.process_requests(req)

    lod = jnp.full(u.shape, 0.5, jnp.float32)  # brackets levels 0 (absent) & 1
    c, res, usage = sample_demand(mgr.pool, tid, jnp.asarray(u), jnp.asarray(v),
                                  lod, trilinear=True)
    assert bool(np.asarray(res).all())  # level 1 is resident -> lane resident
    got = np.stack([np.asarray(c.x), np.asarray(c.y), np.asarray(c.z)], -1)
    np.testing.assert_allclose(got, ref_bilinear(_box_mip(img, 1), u, v),
                               atol=1e-5)
    # the absent level-0 pages are still REPORTED so the pager streams them in
    lvls = np.asarray(mgr._page_lvl)[np.nonzero(np.asarray(usage))[0]]
    assert 0 in set(lvls.tolist())
