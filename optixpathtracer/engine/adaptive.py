"""Variance-guided adaptive sampling renderer.

Beyond-parity capability: the reference spends samples uniformly (or by a
gaze point, HelloPathtracing_sv4_vmv23/SimplePathtracer.cpp:135-215 — the
foveated engine here matches that); this engine spends them where the
estimator's own measured variance says they buy the most error reduction.
It reuses the fused-foveation lane machinery (wavefront.py `sample_lanes`:
per-lane RNG counters, one sample per lane) with "zones" chosen per round by
per-tile error instead of by gaze radius.

Shape discipline: adaptive sampling is the textbook dynamic-shape
workload (each pixel wants a different sample count), which XLA cannot
compile. The design keeps every launch STATIC:

  * the frame is covered by the renderer's native 16x8 pixel tiles (128
    rays — refinement granularity == the renderer's coherent ray
    granularity, so refined lanes stay block-coherent);
  * each refinement round selects a FIXED number K of tiles via
    `jax.lax.top_k` over per-tile error — one jitted launch of exactly
    K * 128 * spp lanes, every round, no recompiles;
  * per-pixel sample counts live in a (padded) count buffer; the running
    image is sum / count, and per-lane RNG counters continue each pixel's
    stream where it left off (sample i of a pixel draws the same tea stream
    whether it was traced by warmup, refinement, or the uniform renderer).

Estimator: per-pixel mean of that pixel's own samples. Sample COUNTS depend
only on other samples' values (classic adaptive-sampling caveat: stopping
rules correlated with the integrand introduce O(1/n^2) bias; standard
practice, and the consistency test pins the full-coverage case to the
uniform renderer). Radiance is clamped per SAMPLE at cfg.clamp_radiance —
the per-launch-mean clamp of the uniform path (deviceProgram.cu:462) has no
analog when a launch carries one sample per lane.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..builder import CompiledScene
from ..core.camera import Camera
from ..core.math import Vec3, luminance
from ..lights.probe import Probe
from .wavefront import CameraParams, RenderConfig, trace_wavefront

Array = jax.Array

TILE_W, TILE_H = 16, 8
TILE_N = TILE_W * TILE_H  # == the renderer's 16x8 pixel tile


def _tile_layout(width: int, height: int):
    """Padded tile layout: every tile holds exactly TILE_N lane slots.

    Returns (tiles_x, tiles_y, px, py, valid) with px/py/valid of shape
    (tiles_x * tiles_y * TILE_N,): slot t*128+i is lane i (row-major within
    the tile) of tile t. Edge tiles carry invalid (out-of-frame) slots that
    launches mask off — the price of static per-tile lane counts."""
    tiles_x = -(-width // TILE_W)
    tiles_y = -(-height // TILE_H)
    t = np.arange(tiles_x * tiles_y, dtype=np.int32)
    tx, ty = t % tiles_x, t // tiles_x
    i = np.arange(TILE_N, dtype=np.int32)
    px = tx[:, None] * TILE_W + (i % TILE_W)[None, :]
    py = ty[:, None] * TILE_H + (i // TILE_W)[None, :]
    valid = (px < width) & (py < height)
    return tiles_x, tiles_y, px.reshape(-1), py.reshape(-1), valid.reshape(-1)


@partial(jax.jit, static_argnames=("cfg", "spp"))
def _adaptive_launch(
    cs: CompiledScene,
    probe: Probe,
    cfg: RenderConfig,
    cam: CameraParams,
    sel: Array,        # (K,) int32 selected tile ids
    px_all: Array,     # (P,) padded slot coords
    py_all: Array,
    valid_all: Array,  # (P,) bool
    col_sum: Vec3,     # (P,) running per-pixel sums
    lum_sum: Array,
    lum2_sum: Array,
    count: Array,      # (P,) uint32 samples so far
    nrm_sum: Vec3,     # (P,) first-bounce AOV sums (denoiser guides)
    alb_sum: Vec3,
    dep_sum: Array,    # (P,) first-bounce depth sums
    spp: int,
    area_light=None,
):
    """Trace spp new samples for every pixel of the K selected tiles and
    fold them into the running (sum, m2, count) state. One static launch of
    K * TILE_N * spp lanes."""
    k = sel.shape[0]
    slot = (sel[:, None] * TILE_N
            + jnp.arange(TILE_N, dtype=jnp.int32)[None, :]).reshape(-1)
    px, py, valid = px_all[slot], py_all[slot], valid_all[slot]
    base_ctr = count[slot]

    m = k * TILE_N
    px_s = jnp.tile(px, spp)
    py_s = jnp.tile(py, spp)
    valid_s = jnp.tile(valid, spp)
    # continue each pixel's RNG stream: sample j of this launch is overall
    # sample count[pixel] + j — the same tea stream the uniform renderer
    # would have used for that sample index
    lanes = (jnp.tile(base_ctr, spp)
             + jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), m))

    fcfg = dataclasses.replace(cfg, samples_per_launch=1, batch_spp=False)
    out = trace_wavefront(
        cs, probe, fcfg, cam, px_s, py_s, jnp.uint32(0),
        active_mask=valid_s, sample_lanes=lanes, area_light=area_light,
    )

    # per-sample clamp (see module docstring), masked lanes contribute zero
    # (their trace output is the bare backplate composite)
    c = Vec3(
        jnp.clip(out.color.x, 0.0, cfg.clamp_radiance),
        jnp.clip(out.color.y, 0.0, cfg.clamp_radiance),
        jnp.clip(out.color.z, 0.0, cfg.clamp_radiance),
    )
    vf = valid_s.astype(jnp.float32)
    c = Vec3(c.x * vf, c.y * vf, c.z * vf)
    lum = luminance(c)

    def fold(a):
        return a.reshape(spp, m).sum(0)

    col_sum = Vec3(
        col_sum.x.at[slot].add(fold(c.x)),
        col_sum.y.at[slot].add(fold(c.y)),
        col_sum.z.at[slot].add(fold(c.z)),
    )
    lum_sum = lum_sum.at[slot].add(fold(lum))
    lum2_sum = lum2_sum.at[slot].add(fold(lum * lum))
    count = count.at[slot].add(jnp.uint32(spp) * valid.astype(jnp.uint32))
    # first-bounce AOVs accumulate alongside color — the denoiser guides
    # (out.normal/albedo are per-lane at spp=1 in fused-lane mode)
    nrm_sum = Vec3(
        nrm_sum.x.at[slot].add(fold(out.normal.x * vf)),
        nrm_sum.y.at[slot].add(fold(out.normal.y * vf)),
        nrm_sum.z.at[slot].add(fold(out.normal.z * vf)),
    )
    alb_sum = Vec3(
        alb_sum.x.at[slot].add(fold(out.albedo.x * vf)),
        alb_sum.y.at[slot].add(fold(out.albedo.y * vf)),
        alb_sum.z.at[slot].add(fold(out.albedo.z * vf)),
    )
    dep_sum = dep_sum.at[slot].add(fold(out.depth * vf))
    return (col_sum, lum_sum, lum2_sum, count, nrm_sum, alb_sum, dep_sum,
            out.rays_traced)


@partial(jax.jit, static_argnames=("n_tiles",))
def _tile_errors(
    lum_sum: Array, lum2_sum: Array, count: Array, n_tiles: int
) -> Array:
    """Per-tile refinement score: summed relative variance of each pixel's
    mean, variance-of-mean / (mean + eps)^2 — the standard
    perceptually-weighted adaptive-sampling criterion (dark pixels need
    absolutely less variance for the same relative error)."""
    n = jnp.maximum(count.astype(jnp.float32), 1.0)
    mean = lum_sum / n
    var = jnp.maximum(lum2_sum / n - mean * mean, 0.0)
    var_mean = var / n
    err = var_mean / (mean + 1e-2) ** 2
    err = jnp.where(count > 0, err, 0.0)  # padded slots score zero
    return err.reshape(n_tiles, TILE_N).sum(axis=1)


class AdaptiveRenderer:
    """Progressive renderer that concentrates samples on high-variance tiles.

    render() traces one round: the first call is a uniform WARMUP pass
    (`warmup_spp` samples for every pixel — seeds the variance estimates);
    every later call refines the top `refine_fraction` of tiles by measured
    error with `refine_spp` fresh samples each. accum_image() is the running
    per-pixel mean at any point.
    """

    def __init__(
        self,
        compiled_scene: CompiledScene,
        probe: Probe,
        config: RenderConfig | None = None,
        camera: Camera | None = None,
        area_light=None,
        warmup_spp: int = 2,
        refine_spp: int = 4,
        refine_fraction: float = 0.25,
    ):
        self.cs = compiled_scene
        self.probe = probe
        self.config = config or RenderConfig()
        self.camera = camera or Camera()
        self.area_light = area_light
        self.warmup_spp = int(warmup_spp)
        self.refine_spp = int(refine_spp)
        w, h = self.config.width, self.config.height
        self.tiles_x, self.tiles_y, px, py, valid = _tile_layout(w, h)
        self.n_tiles = self.tiles_x * self.tiles_y
        self.refine_tiles = max(1, min(self.n_tiles,
                                       int(round(self.n_tiles * refine_fraction))))
        self._px = jnp.asarray(px)
        self._py = jnp.asarray(py)
        self._valid = jnp.asarray(valid)
        self._valid_np = valid
        p = px.shape[0]
        self.col_sum = Vec3.zeros((p,))
        self.lum_sum = jnp.zeros((p,), jnp.float32)
        self.lum2_sum = jnp.zeros((p,), jnp.float32)
        self.count = jnp.zeros((p,), jnp.uint32)
        self.nrm_sum = Vec3.zeros((p,))
        self.alb_sum = Vec3.zeros((p,))
        self.dep_sum = jnp.zeros((p,), jnp.float32)
        self.rounds = 0
        self.rays_traced = 0.0

    # -- rendering ---------------------------------------------------------
    def render(self) -> None:
        """One adaptive round (warmup on the first call)."""
        cam = CameraParams.from_camera(self.camera)
        if self.rounds == 0:
            sel = jnp.arange(self.n_tiles, dtype=jnp.int32)
            spp = self.warmup_spp
        else:
            err = _tile_errors(self.lum_sum, self.lum2_sum, self.count,
                               self.n_tiles)
            _, sel = jax.lax.top_k(err, self.refine_tiles)
            sel = sel.astype(jnp.int32)
            spp = self.refine_spp
        (self.col_sum, self.lum_sum, self.lum2_sum, self.count,
         self.nrm_sum, self.alb_sum, self.dep_sum, rays) = _adaptive_launch(
            self.cs, self.probe, self.config, cam, sel,
            self._px, self._py, self._valid,
            self.col_sum, self.lum_sum, self.lum2_sum, self.count,
            self.nrm_sum, self.alb_sum, self.dep_sum,
            spp, self.area_light,
        )
        self.rays_traced += float(rays)
        self.rounds += 1

    def render_n(self, n: int) -> np.ndarray:
        for _ in range(n):
            self.render()
        return self.accum_image()

    # -- outputs -----------------------------------------------------------
    def _mean_image(self, v: Vec3) -> np.ndarray:
        """(H, W, 3) per-pixel sum/count, top row first (image convention)."""
        w, h = self.config.width, self.config.height
        n = np.maximum(np.asarray(self.count, np.float32), 1.0)
        mean = np.stack(
            [np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], axis=-1,
        ) / n[:, None]
        img = np.zeros((h * w, 3), np.float32)
        yx = (np.asarray(self._py) * w + np.asarray(self._px))[self._valid_np]
        img[yx] = mean[self._valid_np]
        return img.reshape(h, w, 3)[::-1]

    def accum_image(self) -> np.ndarray:
        """(H, W, 3) running mean, top row first (image convention)."""
        return self._mean_image(self.col_sum)

    def aovs(self) -> dict[str, np.ndarray]:
        """Running-mean normal/albedo/depth AOVs (denoiser guides)."""
        return {
            "normal": self._mean_image(self.nrm_sum),
            "albedo": self._mean_image(self.alb_sum),
            "depth": self._mean_scalar_image(self.dep_sum),
        }

    def _mean_scalar_image(self, s: Array) -> np.ndarray:
        """(H, W) running mean of a scalar per-lane sum (depth AOV)."""
        w, h = self.config.width, self.config.height
        n = np.maximum(np.asarray(self.count, np.float32), 1.0)
        img = np.zeros((h * w,), np.float32)
        yx = (np.asarray(self._py) * w + np.asarray(self._px))[self._valid_np]
        img[yx] = (np.asarray(s) / n)[self._valid_np]
        return img.reshape(h, w)[::-1]

    def variance_image(self) -> np.ndarray:
        """(H, W) variance of the per-pixel mean (the denoiser's noise
        guide): Var[samples] / count."""
        w, h = self.config.width, self.config.height
        n = np.maximum(np.asarray(self.count, np.float32), 1.0)
        m = np.asarray(self.lum_sum) / n
        v = np.maximum(np.asarray(self.lum2_sum) / n - m * m, 0.0) / n
        img = np.zeros((h * w,), np.float32)
        yx = (np.asarray(self._py) * w + np.asarray(self._px))[self._valid_np]
        img[yx] = v[self._valid_np]
        return img.reshape(h, w)[::-1]

    def denoised_image(self, **kwargs) -> np.ndarray:
        """AOV-guided À-Trous denoise of the adaptive running mean — the
        composed variance pipeline's output (stratified sampling + adaptive
        refinement + denoise)."""
        import jax.numpy as jnp

        from ..ops.denoise import atrous_denoise

        aov = self.aovs()
        # defaults tuned on the bench scene:
        # heavy variance-scaled color smoothing + albedo demodulation; the
        # depth guide measured NEGATIVE there and stays opt-in
        kwargs.setdefault("variance", jnp.asarray(self.variance_image()))
        kwargs.setdefault("sigma_color", 4.0)
        kwargs.setdefault("sigma_albedo", 1.0)
        kwargs.setdefault("var_boost", 256.0)
        kwargs.setdefault("demodulate", True)
        return np.asarray(
            atrous_denoise(
                jnp.asarray(self.accum_image()),
                jnp.asarray(aov["normal"]),
                jnp.asarray(aov["albedo"]),
                **kwargs,
            )
        )

    def sample_map(self) -> np.ndarray:
        """(H, W) per-pixel sample counts — the adaptive effort map."""
        w, h = self.config.width, self.config.height
        out = np.zeros((h * w,), np.int64)
        yx = (np.asarray(self._py) * w + np.asarray(self._px))[self._valid_np]
        out[yx] = np.asarray(self.count)[self._valid_np]
        return out.reshape(h, w)[::-1]

    def error_map(self) -> np.ndarray:
        """(tiles_y, tiles_x) current per-tile refinement scores."""
        err = np.asarray(
            _tile_errors(self.lum_sum, self.lum2_sum, self.count, self.n_tiles)
        )
        return err.reshape(self.tiles_y, self.tiles_x)[::-1]

    def stats(self) -> dict:
        counts = np.asarray(self.count)[self._valid_np]
        return {
            "rounds": self.rounds,
            "rays_traced": self.rays_traced,
            "total_samples": int(counts.sum()),
            "spp_min": int(counts.min()) if counts.size else 0,
            "spp_max": int(counts.max()) if counts.size else 0,
            "refine_tiles": self.refine_tiles,
            "n_tiles": self.n_tiles,
        }
