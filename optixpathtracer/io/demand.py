"""Demand-loaded sparse textures — the array-native equivalent of the reference's
vendored (but build-disabled) DemandLoading + ImageSource libraries
(lib/DemandLoading/include/DemandLoading/DemandLoader.h:30-60,
lib/ImageSource/). The reference design: device code samples
sparse CUDA textures; non-resident accesses record page ids in a request
buffer; after the launch the host maps requested pages, reads their tiles
from an ImageSource, and uploads them; the next launch finds them resident.

Re-expression (no sparse textures, no device-side page faults):

* The tile pool is a device array `(capacity, (TILE+2)^2)` per channel —
  resident texture tiles WITH a 1-texel gutter ring (the same trick the
  reference uses so bilinear filtering never needs a neighbor tile:
  Textures/SparseTexture gutters). A page table `(num_pages,)` maps page id
  -> pool slot or -1.
* `sample_demand` is a pure jitted function: page-table lookup + one wide
  gather from the pool for resident pages, per-texture fallback color for
  misses, AND a `(num_pages,)` page-usage bitmap built with one scatter —
  the analog of the reference's page-request buffer (usage is reported
  for resident pages too, which is what drives the LRU).
* `DemandTextureManager` (host) plays DemandLoaderImpl: it services request
  bitmaps between launches — reads tiles from an ImageSource, assigns slots
  with LRU eviction, and re-uploads only the touched pool rows and the page
  table (small transfers; the texel pool itself never moves host<->device
  wholesale).

Procedural sources mirror the reference's ImageSource set (CheckerBoardImage,
lib/ImageSource/src/CheckerBoardImage.cpp; MandelbrotImage)
plus an array-backed source for file textures.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Protocol, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math import Vec3

Array = jax.Array

TILE = 62  # payload texels per tile side; stored side is TILE+2 (gutter)
STORE = TILE + 2


class ImageSource(Protocol):
    """Tile-addressable image — the reference's imageSource::ImageSource."""

    width: int
    height: int

    def read_texel_block(self, x0: np.ndarray, y0: np.ndarray) -> np.ndarray:
        """Return texels at integer grids (len(y0), len(x0), 3) float32.
        Coordinates may be out of range; sources must wrap them."""
        ...


def _wrap(i: np.ndarray, n: int) -> np.ndarray:
    return np.mod(i, n)


@dataclasses.dataclass
class ArraySource:
    """Whole-image-in-memory source (file textures decoded by io/image)."""

    data: np.ndarray  # (H, W, 3) float32

    def __post_init__(self):
        self.data = np.asarray(self.data, np.float32)
        self.height, self.width = self.data.shape[:2]

    def read_texel_block(self, x0, y0):
        return self.data[_wrap(y0, self.height)[:, None], _wrap(x0, self.width)[None, :]]


@dataclasses.dataclass
class CheckerBoardSource:
    """Procedural checkerboard (ImageSource/src/CheckerBoardImage.cpp:30-70):
    squares of `squares_per_side` across the image, alternating colors."""

    width: int = 4096
    height: int = 4096
    squares_per_side: int = 32
    color_a: tuple = (1.0, 1.0, 1.0)
    color_b: tuple = (0.1, 0.1, 0.4)

    def read_texel_block(self, x0, y0):
        sx = self.width // self.squares_per_side
        sy = self.height // self.squares_per_side
        cx = _wrap(x0, self.width) // sx
        cy = _wrap(y0, self.height) // sy
        par = (cx[None, :] + cy[:, None]) % 2
        a = np.asarray(self.color_a, np.float32)
        b = np.asarray(self.color_b, np.float32)
        return np.where(par[..., None] == 0, a, b).astype(np.float32)


@dataclasses.dataclass
class MandelbrotSource:
    """Procedural Mandelbrot set (ImageSource/src/MandelbrotImage.cpp),
    escape-time shaded over [-2.2, 1] x [-1.6, 1.6]."""

    width: int = 4096
    height: int = 4096
    max_iter: int = 64

    def read_texel_block(self, x0, y0):
        xs = _wrap(x0, self.width) / self.width * 3.2 - 2.2
        ys = _wrap(y0, self.height) / self.height * 3.2 - 1.6
        c = xs[None, :] + 1j * ys[:, None]
        z = np.zeros_like(c)
        count = np.zeros(c.shape, np.int32)
        alive = np.ones(c.shape, bool)
        for _ in range(self.max_iter):
            z = np.where(alive, z * z + c, z)
            alive &= np.abs(z) <= 2.0
            count += alive
        t = count.astype(np.float32) / self.max_iter
        return np.stack([t, t * t, np.sqrt(t)], axis=-1).astype(np.float32)


class DemandTexturePool(NamedTuple):
    """Device-resident sparse texture state (a pytree — pass through jit).

    Tables are indexed [texture, mip_level] — the reference's DemandLoading
    page ids likewise encode (level, x, y) (TextureRequestHandler). A
    texture with fewer levels than the table width repeats its coarsest
    row, so any in-range level index is safe."""

    tile_r: Array  # (capacity, STORE*STORE) f32 resident tiles + gutter
    tile_g: Array
    tile_b: Array
    page_table: Array  # (num_pages,) i32 page -> slot, or -1 (non-resident)
    page_offset: Array  # (T, L) i32 first page id of texture t, level l
    pages_x: Array  # (T, L) i32 page-grid width per level
    width: Array  # (T, L) i32 level texel dims
    height: Array  # (T, L) i32
    levels: Array  # (T,) i32 actual mip levels of each texture
    fallback: Array  # (T, 3) f32 per-texture average color for misses

    @property
    def num_pages(self) -> int:
        return self.page_table.shape[0]


def sample_demand(
    pool: DemandTexturePool, tex_id: Array, u: Array, v: Array,
    lod: Array | None = None, trilinear: bool = False,
) -> tuple[Vec3, Array, Array]:
    """Bilinear sample with wrap addressing from the sparse tile pool.

    `lod` (optional, float per lane) selects the mip level, clamped to the
    texture's chain; None/0 samples the base level. Levels are box-filtered
    pyramids (built by the manager), so coarse lookups touch far fewer
    pages — the reference's mip-aware sparse textures (DemandLoading
    TextureRequestHandler). `trilinear=True` blends the two bracketing
    levels (hardware-sparse-texture filtering); default is nearest level.

    Returns (color, resident_mask, usage_bitmap). Non-resident lookups
    return the texture's fallback color. The usage bitmap records EVERY
    valid page touch — resident and non-resident alike — mirroring the
    reference's optixPagingMapOrRequest contract (PagingSystemKernels.cu),
    whose usage reports are what drive its LRU: the host pager loads the
    non-resident bits and refreshes the eviction ticks of the resident
    ones. tex_id < 0 samples nothing (white, no usage).
    """
    tid = jnp.maximum(tex_id, 0)
    valid = tex_id >= 0

    if lod is None or not trilinear:
        if lod is None:
            lvl = jnp.zeros_like(tid)
        else:
            lvl = jnp.clip(
                jnp.round(lod).astype(jnp.int32), 0, pool.levels[tid] - 1
            )
        out, resident, page = _sample_level(pool, tid, u, v, lvl)
        usage = jnp.zeros((pool.num_pages,), jnp.bool_).at[
            jnp.where(valid, page, 0)
        ].max(valid, mode="drop")
    else:
        # trilinear: blend the two bracketing levels (the reference's
        # hardware sparse textures filter trilinearly). Both levels' pages
        # are reported as used, but when only ONE bracket is resident the
        # lane samples that level alone instead of dropping to the flat
        # fallback color — the reference likewise shades from the finest
        # RESIDENT level while finer tiles stream in.
        lodc = jnp.clip(lod, 0.0, (pool.levels[tid] - 1).astype(jnp.float32))
        l0 = jnp.floor(lodc).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, pool.levels[tid] - 1)
        f = lodc - l0.astype(jnp.float32)
        out0, res0, page0 = _sample_level(pool, tid, u, v, l0)
        out1, res1, page1 = _sample_level(pool, tid, u, v, l1)
        both = res0 & res1
        w1 = jnp.where(both, f, jnp.where(res1, 1.0, 0.0))
        w0 = 1.0 - w1
        # zero the non-resident side so garbage texels never leak in
        w0 = jnp.where(res0, w0, 0.0)
        w1 = jnp.where(res1, w1, 0.0)
        out = out0 * w0 + out1 * w1
        resident = res0 | res1
        usage = (
            jnp.zeros((pool.num_pages,), jnp.bool_)
            .at[jnp.where(valid, page0, 0)].max(valid, mode="drop")
            .at[jnp.where(valid, page1, 0)].max(valid, mode="drop")
        )

    fb = pool.fallback[tid]
    color = Vec3(
        jnp.where(valid, jnp.where(resident, out.x, fb[..., 0]), 1.0),
        jnp.where(valid, jnp.where(resident, out.y, fb[..., 1]), 1.0),
        jnp.where(valid, jnp.where(resident, out.z, fb[..., 2]), 1.0),
    )
    return color, resident & valid, usage


def _sample_level(
    pool: DemandTexturePool, tid: Array, u: Array, v: Array, lvl: Array
) -> tuple[Vec3, Array, Array]:
    """Wrap-bilinear at one mip level: (color, resident, page) per lane."""
    w = pool.width[tid, lvl]
    h = pool.height[tid, lvl]
    uu = (u % 1.0) * w.astype(jnp.float32) - 0.5
    vv = (v % 1.0) * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(uu)
    y0 = jnp.floor(vv)
    fx = uu - x0
    fy = vv - y0
    # tile holding the BASE texel; its gutter covers x0+1/y0+1 (and x0-1
    # wraps into the previous tile's payload, never needed: x0 >= -1 only
    # at the wrap seam, where mod folds it to the last tile's payload)
    xi = jnp.mod(x0.astype(jnp.int32), w)
    yi = jnp.mod(y0.astype(jnp.int32), h)
    tx = xi // TILE
    ty = yi // TILE
    page = pool.page_offset[tid, lvl] + ty * pool.pages_x[tid, lvl] + tx
    slot = pool.page_table[page]
    resident = slot >= 0

    # texel coords inside the stored tile (+1 for the gutter ring)
    lx = xi - tx * TILE + 1
    ly = yi - ty * TILE + 1
    s = jnp.maximum(slot, 0)

    def fetch(dx, dy):
        idx = (ly + dy) * STORE + (lx + dx)
        return Vec3(
            pool.tile_r[s, idx], pool.tile_g[s, idx], pool.tile_b[s, idx]
        )

    c00 = fetch(0, 0)
    c10 = fetch(1, 0)
    c01 = fetch(0, 1)
    c11 = fetch(1, 1)
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy, resident, page


class DemandTextureManager:
    """Host-side pager (DemandLoaderImpl + PagingSystem roles): owns the
    sources, assigns pool slots with LRU eviction, services request bitmaps
    between launches."""

    def __init__(
        self,
        sources: Sequence[ImageSource],
        capacity: int = 256,
        levels: int = 1,
    ):
        """levels > 1 builds box-filtered mip pyramids per texture (level l
        dims = max(1, dim >> l), chain clamped once a level fits one tile).
        levels=1 is the original base-level-only behavior."""
        self.sources = list(sources)
        self.capacity = int(capacity)
        max_l = max(1, int(levels))
        # per-(texture, level) page-space layout
        n_tex = len(self.sources)
        offs = np.zeros((n_tex, max_l), np.int32)
        px = np.zeros((n_tex, max_l), np.int32)
        w = np.zeros((n_tex, max_l), np.int32)
        h = np.zeros((n_tex, max_l), np.int32)
        n_levels = np.zeros(n_tex, np.int32)
        fb = []
        meta = []  # page -> (tex, level, local_offset) rows, built per chunk
        total = 0
        for t, s in enumerate(self.sources):
            nl = 1
            while (
                nl < max_l
                and max(s.width >> nl, s.height >> nl) >= 1
                and max(s.width >> (nl - 1), s.height >> (nl - 1)) > TILE
            ):
                nl += 1
            n_levels[t] = nl
            for l in range(max_l):
                le = min(l, nl - 1)
                lw = max(1, s.width >> le)
                lh = max(1, s.height >> le)
                gx = -(-lw // TILE)
                gy = -(-lh // TILE)
                if l < nl:
                    offs[t, l] = total
                    meta.append((t, l, total, gx, gy))
                    total += gx * gy
                else:  # clamp: repeat the coarsest real level's row
                    offs[t, l] = offs[t, nl - 1]
                    gx = px[t, nl - 1]
                px[t, l] = gx if l < nl else px[t, nl - 1]
                w[t, l] = lw
                h[t, l] = lh
            # fallback = mean of a sparse probe grid (cheap, deterministic)
            xs = np.linspace(0, s.width - 1, 16).astype(np.int64)
            ys = np.linspace(0, s.height - 1, 16).astype(np.int64)
            fb.append(s.read_texel_block(xs, ys).reshape(-1, 3).mean(0))
        self.num_pages = total
        self._page_tex = np.zeros(total, np.int32)  # page -> texture id
        self._page_lvl = np.zeros(total, np.int32)  # page -> mip level
        self._page_local = np.zeros(total, np.int64)  # page - level offset
        for t, l, o, gx, gy in meta:
            self._page_tex[o:o + gx * gy] = t
            self._page_lvl[o:o + gx * gy] = l
            self._page_local[o:o + gx * gy] = np.arange(gx * gy)
        self._page_table = np.full(total, -1, np.int32)
        self._slot_page = np.full(self.capacity, -1, np.int64)
        self._clock = 0
        self._slot_used = np.zeros(self.capacity, np.int64)  # last-touch tick
        st = STORE * STORE
        self.pool = DemandTexturePool(
            tile_r=jnp.zeros((self.capacity, st), jnp.float32),
            tile_g=jnp.zeros((self.capacity, st), jnp.float32),
            tile_b=jnp.zeros((self.capacity, st), jnp.float32),
            page_table=jnp.asarray(self._page_table),
            page_offset=jnp.asarray(offs),
            pages_x=jnp.asarray(px),
            width=jnp.asarray(w),
            height=jnp.asarray(h),
            levels=jnp.asarray(n_levels),
            fallback=jnp.asarray(np.stack(fb).astype(np.float32)),
        )
        self._px = px
        self.pages_loaded = 0
        self.pages_evicted = 0

    def _read_level_block(
        self, t: int, level: int, xs: np.ndarray, ys: np.ndarray
    ) -> np.ndarray:
        """Level-l texels at integer grids — an exact 2^l x 2^l box filter
        over the source's base level (wrap addressing), so mips are
        well-defined for ANY ImageSource, procedural included."""
        src = self.sources[t]
        if level == 0:
            return src.read_texel_block(xs, ys)
        k = 1 << level
        xf = (xs[:, None] * k + np.arange(k)[None, :]).reshape(-1)
        yf = (ys[:, None] * k + np.arange(k)[None, :]).reshape(-1)
        block = src.read_texel_block(xf, yf)  # (len(ys)*k, len(xs)*k, 3)
        return block.reshape(len(ys), k, len(xs), k, 3).mean((1, 3))

    def _read_tile(self, page: int) -> tuple[np.ndarray, ...]:
        t = int(self._page_tex[page])
        level = int(self._page_lvl[page])
        ty, tx = divmod(int(self._page_local[page]), int(self._px[t, level]))
        # payload [tx*TILE, tx*TILE+TILE) plus 1-texel wrapped gutter
        xs = np.arange(tx * TILE - 1, tx * TILE + TILE + 1, dtype=np.int64)
        ys = np.arange(ty * TILE - 1, ty * TILE + TILE + 1, dtype=np.int64)
        block = self._read_level_block(t, level, xs, ys)  # (STORE, STORE, 3)
        flat = block.reshape(-1, 3)
        return flat[:, 0], flat[:, 1], flat[:, 2]

    def process_requests(self, requests) -> int:
        """Service one launch's usage bitmap: refresh the eviction tick of
        every touched RESIDENT page (true LRU), load the non-resident ones.
        Returns pages loaded."""
        req = np.asarray(requests)
        pages = np.nonzero(req)[0]
        if len(pages) == 0:
            return 0
        self._clock += 1
        is_resident = self._page_table[pages] >= 0
        self._slot_used[self._page_table[pages[is_resident]]] = self._clock
        pages = pages[~is_resident]
        if len(pages) == 0:
            return 0
        n_load = min(len(pages), self.capacity)
        pages = pages[:n_load]
        # free slots first, then LRU
        order = np.argsort(self._slot_used, kind="stable")
        slots = order[:n_load]
        rows_r, rows_g, rows_b = [], [], []
        for page, slot in zip(pages, slots):
            old = self._slot_page[slot]
            if old >= 0:
                self._page_table[old] = -1
                self.pages_evicted += 1
            r, g, b = self._read_tile(int(page))
            rows_r.append(r)
            rows_g.append(g)
            rows_b.append(b)
            self._slot_page[slot] = page
            self._slot_used[slot] = self._clock
            self._page_table[page] = slot
            self.pages_loaded += 1
        sl = jnp.asarray(slots.astype(np.int32))
        self.pool = self.pool._replace(
            tile_r=self.pool.tile_r.at[sl].set(jnp.asarray(np.stack(rows_r))),
            tile_g=self.pool.tile_g.at[sl].set(jnp.asarray(np.stack(rows_g))),
            tile_b=self.pool.tile_b.at[sl].set(jnp.asarray(np.stack(rows_b))),
            page_table=jnp.asarray(self._page_table),
        )
        return int(n_load)

    def resident_fraction(self) -> float:
        return float((self._page_table >= 0).mean())

    @classmethod
    def from_host_scene(
        cls, hs, capacity: int = 256, levels: int = 1
    ) -> "DemandTextureManager":
        """Wrap a HostScene's registered textures (in texture-id order) so
        material.texture_id indexes this manager directly — pass the result
        as Renderer(demand=...) to shade from the sparse pool instead of the
        resident TexturePool."""
        return cls([ArraySource(t) for t in hs.textures],
                   capacity=capacity, levels=levels)
