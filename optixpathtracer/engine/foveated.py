"""Foveated multi-resolution rendering — the reference's VMV'23 contribution.

Reference semantics (HelloPathtracing_sv4_vmv23): three launches per frame
(SimplePathtracer.cpp:135-215) —
  periphery: 1/4-res grid, 1 spp, annulus r > outer_radius, progressive accum;
  ring:      1/2-res grid over [inner, outer+2], 2 spp, redrawn every frame;
  fovea:     full-res disc r <= inner+1, 8 spp, redrawn every frame;
with default radii inner=157, outer=515 (:20-21). Device side
(deviceProgram.cu:389-588): launch index remap idx = idx*factor + offset
(:419), annulus cull (:421-425), fillSize x fillSize block splat with frame
clamp (:526-552), per-zone accumulate honoring `redraw` (:545-553), exposure
2^2 + Reinhard on the final write (:554-571). Gaze = cursor (main.cpp:310-314).

Mapping: each zone is a fixed-shape wavefront over its subsampled
launch grid (static shapes; the gaze only moves a dynamic offset), the
annulus cull is the wavefront's active_mask, and the block splat is one
batched scatter into the flat framebuffer. Three jitted zone programs per
frame — exactly mirroring the reference's three optixLaunches.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..builder import CompiledScene
from ..core.camera import Camera
from ..core.math import Vec3, where
from ..lights.probe import Probe
from ..ops import tonemap
from .wavefront import CameraParams, RenderConfig, trace_wavefront

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class FoveationZone:
    """One ring of the foveation pattern (static launch geometry)."""

    name: str
    factor: int  # pixel subsampling stride (and splat block size)
    spp: int
    r_inner: float
    r_outer: float
    redraw: bool  # True: overwrite each frame; False: progressive accumulate
    grid_w: int  # launch grid dims (pixels covered = grid * factor)
    grid_h: int
    centered: bool  # offset = gaze - extent/2 (ring/fovea) vs (0,0) (periphery)


@dataclasses.dataclass(frozen=True)
class FoveationConfig:
    """The sv4 3-zone preset, parameterized (radii/spp/factors as data)."""

    inner_radius: int = 157
    outer_radius: int = 515
    periphery_factor: int = 4
    ring_factor: int = 2
    periphery_spp: int = 1
    ring_spp: int = 2
    fovea_spp: int = 8
    progressive: bool = False  # accumulate EVERY zone progressively instead
    #   of redrawing ring/fovea each frame (the reference redraws them,
    #   sv4 SimplePathtracer.cpp:159-212, because the gaze moves; under a
    #   static gaze progressive fovea accumulation converges the fovea to
    #   full quality — the time-to-fovea-RMSE bench row uses this)

    def zones(self, width: int, height: int) -> tuple[FoveationZone, ...]:
        ro = self.outer_radius
        ri = self.inner_radius
        redraw = not self.progressive
        ring_half = ro + 2
        fovea_half = ri + 1
        return (
            FoveationZone(
                "periphery", self.periphery_factor, self.periphery_spp,
                float(ro), 1e18, False,
                width // self.periphery_factor, height // self.periphery_factor,
                centered=False,
            ),
            FoveationZone(
                "ring", self.ring_factor, self.ring_spp,
                float(ri), float(ro + 2), redraw,
                ring_half, ring_half, centered=True,
            ),
            FoveationZone(
                "fovea", 1, self.fovea_spp,
                0.0, float(ri + 1), redraw,
                2 * fovea_half, 2 * fovea_half, centered=True,
            ),
        )


def _zone_cfg(base: RenderConfig, zone: FoveationZone) -> RenderConfig:
    return dataclasses.replace(base, samples_per_launch=zone.spp)


@functools.lru_cache(maxsize=None)
def _zone_lanes(zone: FoveationZone) -> tuple[np.ndarray, np.ndarray, bool]:
    """Static (lx, ly, statically_culled) lane enumeration of a zone grid.

    Two static launch-geometry optimizations over the naive row-major full
    grid (both invisible to the estimator — RNG is seeded per pixel,
    wavefront.py, and the splat scatters by pixel coords):

    1. 16x8 TILE ORDER (the uniform renderer's dispatch shape,
       Renderer.resize): a 16x8 tile of the subsampled grid is a compact
       2D bundle where a scanline block spans 128*factor pixels
       horizontally.
    2. STATIC ANNULUS CULL for gaze-centered zones: with the grid centered
       on the gaze, px - gaze = lx*factor - half is gaze-INDEPENDENT, so
       the reference's annulus test (sv4 deviceProgram.cu:421-425) is
       static and the dead lanes can be dropped from the launch outright
       (the ring grid is ~29% dead, the fovea square's corners ~21%).
       Half-open bounds keep
       a one-lane slack ring so the dynamic re-test stays authoritative.

    Returns statically_culled=True when the annulus was applied (the
    dynamic active mask then only adds the in-frame test)."""
    gw, gh = zone.grid_w, zone.grid_h
    n = gw * gh
    ys, xs = np.divmod(np.arange(n, dtype=np.int32), gw)
    if not os.environ.get("FOV_SCANLINE"):  # A/B hook for experiments
        tiles_x = -(-gw // 16)
        tile_id = (ys // 8) * tiles_x + (xs // 16)
        within = (ys % 8) * 16 + (xs % 16)
        perm = np.argsort(tile_id * 128 + within, kind="stable")
        xs, ys = xs[perm], ys[perm]
    culled = False
    if zone.centered and not os.environ.get("FOV_NO_STATIC_CULL"):
        # float32 arithmetic EXACTLY as the dynamic test performs it, so
        # boundary lanes make the same in/out decision either way
        half = gw * zone.factor // 2
        dx = (xs * zone.factor - half).astype(np.float32)
        dy = (ys * zone.factor - half).astype(np.float32)
        r = np.sqrt(dx * dx + dy * dy, dtype=np.float32)
        keep = (r >= np.float32(zone.r_inner)) & (r <= np.float32(zone.r_outer))
        if keep.sum() and not keep.all():
            xs, ys, culled = xs[keep], ys[keep], True
    return xs, ys, culled


def _zone_pixels(cfg: RenderConfig, zone: FoveationZone, gaze: Array):
    """Zone launch grid -> (px, py, active) with the annulus cull applied.

    Static shapes; the gaze only moves a dynamic offset (the reference's
    idx*factor + offset remap, sv4 deviceProgram.cu:419)."""
    gw = zone.grid_w
    lx_np, ly_np, statically_culled = _zone_lanes(zone)
    lx = jnp.asarray(lx_np)
    ly = jnp.asarray(ly_np)

    if zone.centered:
        half = jnp.int32(gw * zone.factor // 2)
        off = gaze - half
    else:
        off = jnp.zeros((2,), jnp.int32)

    px = lx * zone.factor + off[0]
    py = ly * zone.factor + off[1]

    in_frame = (px >= 0) & (px < cfg.width) & (py >= 0) & (py < cfg.height)
    if statically_culled:
        active = in_frame  # annulus already applied statically
    else:
        # annulus cull (deviceProgram.cu:421-425)
        dx = px.astype(jnp.float32) - gaze[0].astype(jnp.float32)
        dy = py.astype(jnp.float32) - gaze[1].astype(jnp.float32)
        rng = jnp.sqrt(dx * dx + dy * dy)
        active = (rng >= zone.r_inner) & (rng <= zone.r_outer) & in_frame
    return px, py, active


@partial(jax.jit, static_argnames=("cfg", "zone"))
def _zone_step(
    cs: CompiledScene,
    probe: Probe,
    cfg: RenderConfig,
    zone: FoveationZone,
    cam: CameraParams,
    gaze: Array,  # (2,) int32 gaze center in pixels
    accum: Vec3,  # flat (W*H,) framebuffer state
    subframe: Array,
):
    """Render one zone and splat it into the flat accum buffer."""
    px, py, active = _zone_pixels(cfg, zone, gaze)

    zcfg = _zone_cfg(cfg, zone)
    out = trace_wavefront(
        cs, probe, zcfg, cam,
        jnp.clip(px, 0, cfg.width - 1), jnp.clip(py, 0, cfg.height - 1),
        subframe, active_mask=active,
    )
    return _splat_zone(
        cfg, zone, px, py, active, accum, out.color, subframe
    ), out.rays_traced


def _splat_zone(
    cfg: RenderConfig,
    zone: FoveationZone,
    px: Array,
    py: Array,
    active: Array,
    accum: Vec3,
    color_sum: Vec3,  # per-pixel radiance SUM over the zone's spp samples
    subframe: Array,
) -> Vec3:
    """Average, progressively blend (non-redraw zones), and block-splat one
    zone's colors into the flat accum buffer (sv4 deviceProgram.cu:526-552)."""
    spp = jnp.float32(zone.spp)
    new_color = (color_sum * (1.0 / spp))
    if not zone.redraw:
        # progressive accumulate against the previous value at the splat anchor
        anchor = jnp.clip(py, 0, cfg.height - 1) * cfg.width + jnp.clip(px, 0, cfg.width - 1)
        prev = accum.take(anchor)
        a = 1.0 / (subframe.astype(jnp.float32) + 1.0)
        clamped = Vec3(
            jnp.clip(new_color.x, 0.0, cfg.clamp_radiance),
            jnp.clip(new_color.y, 0.0, cfg.clamp_radiance),
            jnp.clip(new_color.z, 0.0, cfg.clamp_radiance),
        )
        blended = prev + (clamped - prev) * a
        new_color = where(subframe > 0, blended, new_color)

    # fillSize x fillSize block splat with frame clamp (:526-552)
    f = zone.factor
    fi = jnp.arange(f, dtype=jnp.int32)
    sx = px[:, None, None] + fi[None, :, None]  # (N, f, 1)
    sy = py[:, None, None] + fi[None, None, :]  # (N, 1, f)
    sx = jnp.clip(sx, 0, cfg.width - 1)
    sy = jnp.clip(sy, 0, cfg.height - 1)
    n_pix = cfg.width * cfg.height
    tgt = (sy * cfg.width + sx).reshape(-1)  # (N*f*f,)
    keep = jnp.broadcast_to(active[:, None, None], (active.shape[0], f, f)).reshape(-1)
    # inactive lanes scatter into a dummy slot one past the end — a masked
    # "write current value" would race with real writes to the same pixel
    tgt = jnp.where(keep, tgt, n_pix)

    def splat(channel: Array, vals: Array) -> Array:
        v = jnp.broadcast_to(vals[:, None, None], (vals.shape[0], f, f)).reshape(-1)
        padded = jnp.concatenate([channel, jnp.zeros((1,), channel.dtype)])
        return padded.at[tgt].set(v, mode="promise_in_bounds")[:n_pix]

    return Vec3(
        splat(accum.x, new_color.x),
        splat(accum.y, new_color.y),
        splat(accum.z, new_color.z),
    )


def _expand_zone_lanes(
    cfg: RenderConfig, zones: tuple[FoveationZone, ...], gaze: Array, sf: Array
):
    """Expand every zone's pixel grid to per-sample LANES and concatenate.

    Returns (px, py, active, lane_counters, grids): one entry per lane, plus
    the per-zone (px, py, active) grids for the fold. Lane RNG counters are
    subframe * zone_spp + sample — the exact streams of the 3-launch mode —
    so any consumer (single-device fused launch, lane-sharded multi-device)
    is bit-identical to the sequential zone launches."""
    pxs, pys, acts, lanes, grids = [], [], [], [], []
    for zone in zones:
        px, py, active = _zone_pixels(cfg, zone, gaze)
        grids.append((px, py, active))
        n = px.shape[0]
        pxs.append(jnp.tile(px, zone.spp))
        pys.append(jnp.tile(py, zone.spp))
        acts.append(jnp.tile(active, zone.spp))
        s = jnp.repeat(jnp.arange(zone.spp, dtype=jnp.uint32), n)
        lanes.append(sf * jnp.uint32(zone.spp) + s)
    return (
        jnp.clip(jnp.concatenate(pxs), 0, cfg.width - 1),
        jnp.clip(jnp.concatenate(pys), 0, cfg.height - 1),
        jnp.concatenate(acts),
        jnp.concatenate(lanes),
        grids,
    )


def _fold_and_splat(
    cfg: RenderConfig,
    zones: tuple[FoveationZone, ...],
    grids: list,
    color: Vec3,  # per-lane colors in _expand_zone_lanes concat order
    accum: Vec3,
    subframe: Array,
) -> Vec3:
    """Reduce each zone's lanes to per-pixel sums and splat in zone order
    (later zones overwrite earlier ones at the 2px ring overlaps, matching
    the reference's three sequential optixLaunches)."""
    offset = 0
    for zone, (px, py, active) in zip(zones, grids):
        n = px.shape[0]
        m = n * zone.spp

        def fold(a, offset=offset, m=m, n=n, spp=zone.spp):
            return a[offset:offset + m].reshape(spp, n).sum(0)

        color_sum = Vec3(fold(color.x), fold(color.y), fold(color.z))
        offset += m
        accum = _splat_zone(cfg, zone, px, py, active, accum, color_sum, subframe)
    return accum


@partial(jax.jit, static_argnames=("cfg", "zones"))
def _fused_step(
    cs: CompiledScene,
    probe: Probe,
    cfg: RenderConfig,
    zones: tuple[FoveationZone, ...],
    cam: CameraParams,
    gaze: Array,
    accum: Vec3,
    subframe: Array,
):
    """All zones in ONE wavefront launch (SURVEY §2.2: 'fuse the 3 zones as
    masked wavefronts in one jit').

    Each zone's pixel grid is expanded to its own spp and the expansions are
    concatenated into a single launch with per-lane RNG counters
    (subframe * zone_spp + sample — the exact streams of the 3-launch mode),
    so one set of traversal sweeps replaces three: the per-dispatch floor,
    the per-sweep cull/sort fixed costs, and the dead-lane drain are paid
    once instead of per zone. Per-lane outputs are folded back to per-pixel
    sums zone by zone and splatted in zone order (later zones overwrite
    earlier ones at the 2px ring overlaps, matching the reference's three
    sequential optixLaunches)."""
    sf = subframe.astype(jnp.uint32)
    px, py, act, lanes, grids = _expand_zone_lanes(cfg, zones, gaze, sf)
    fcfg = dataclasses.replace(cfg, samples_per_launch=1, batch_spp=False)
    out = trace_wavefront(
        cs, probe, fcfg, cam, px, py, subframe,
        active_mask=act, sample_lanes=lanes,
    )
    accum = _fold_and_splat(cfg, zones, grids, out.color, accum, subframe)
    return accum, out.rays_traced


class FoveatedRenderer:
    """Three-zone gaze-contingent progressive renderer (sv4 engine)."""

    def __init__(
        self,
        compiled_scene: CompiledScene,
        probe: Probe,
        config: RenderConfig,
        camera: Camera,
        foveation: FoveationConfig | None = None,
        fused: bool = False,
    ):
        self.cs = compiled_scene
        self.probe = probe
        self.config = config
        self.camera = camera
        self.fov = foveation or FoveationConfig()
        # fused=True traces all zones in ONE wavefront launch (same RNG
        # streams and estimator as the 3-launch mode; one set of sweeps)
        self.fused = fused
        self.zones = self.fov.zones(config.width, config.height)
        n = config.width * config.height
        self.accum = Vec3.zeros((n,))
        self.subframe_index = 0
        self.gaze = (config.width // 2, config.height // 2)
        self.last_rays = 0.0
        self._frame_times: list[float] = []

    def set_gaze(self, x: int, y: int) -> None:
        """Gaze in image coords (the reference uses the mouse cursor)."""
        self.gaze = (int(x), int(y))

    def set_camera(self, camera: Camera) -> None:
        self.camera = camera
        self.subframe_index = 0

    def render(self) -> np.ndarray:
        t0 = time.perf_counter()
        cam = CameraParams.from_camera(self.camera)
        gaze = jnp.asarray(
            [self.gaze[0], self.config.height - 1 - self.gaze[1]], jnp.int32
        )  # image y (top-first) -> buffer y (bottom-first)
        rays = 0.0
        if self.fused:
            self.accum, r = _fused_step(
                self.cs, self.probe, self.config, self.zones, cam, gaze,
                self.accum, jnp.uint32(self.subframe_index),
            )
            rays = float(r)
        else:
            for zone in self.zones:
                self.accum, r = _zone_step(
                    self.cs, self.probe, self.config, zone, cam, gaze,
                    self.accum, jnp.uint32(self.subframe_index),
                )
                rays += float(r)
        jax.block_until_ready(self.accum.x)
        self.subframe_index += 1
        self.last_rays = rays
        self._frame_times.append(time.perf_counter() - t0)
        return self.frame()

    def frame(self, exposure_stops: float = 2.0) -> np.ndarray:
        """Tone-mapped display frame (sv4: exposure 2^2 + Reinhard + sRGB)."""
        disp = tonemap.finalize(
            self.accum, mode=tonemap.TONEMAP_REINHARD, exposure_stops=exposure_stops
        )
        img = tonemap.pack_rgba8(disp)
        h, w = self.config.height, self.config.width
        return np.asarray(img).reshape(h, w, 4)[::-1]

    def accum_image(self) -> np.ndarray:
        h, w = self.config.height, self.config.width
        img = np.stack(
            [np.asarray(self.accum.x), np.asarray(self.accum.y), np.asarray(self.accum.z)],
            -1,
        )
        return img.reshape(h, w, 3)[::-1]

    def stats(self) -> dict:
        times = self._frame_times[-64:]
        if not times:
            return {"frames": 0}
        return {
            "frames": self.subframe_index,
            "fps": 1.0 / max(float(np.mean(times)), 1e-9),
            "last_rays": self.last_rays,
        }
