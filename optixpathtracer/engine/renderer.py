"""Progressive renderer: owns framebuffer state, jits the wavefront step.

This is the SampleRenderer (HelloPathtracing_original/
SimplePathtracer.h:46-62): render() / resize() / set_camera() / set_probe() /
download_pixels(), plus what the reference lacked — checkpoint/resume of the
progressive accumulation state (SURVEY.md §5: {accum, subframe_index, camera}
IS the renderer state) and structured per-frame metrics.

Where the reference re-uploads LaunchParams and calls optixLaunch each frame
(SimplePathtracer.cpp:73-97), here one jitted function takes (accum, subframe,
camera) and returns the updated accum + AOVs; camera motion is just a new
argument, not a pipeline rebuild.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..builder import CompiledScene
from ..core.camera import Camera
from ..core.math import Vec3
from ..lights.probe import Probe
from ..ops import tonemap
from .wavefront import CameraParams, RenderConfig, SampleOutput, accumulate, trace_wavefront


@partial(jax.jit, static_argnames=("cfg",))
def _render_step(
    cs: CompiledScene,
    probe: Probe,
    cfg: RenderConfig,
    cam: CameraParams,
    pixel_x: jax.Array,
    pixel_y: jax.Array,
    accum: Vec3,
    subframe: jax.Array,
    area_light=None,
    demand_pool=None,
):
    """One progressive launch over a pixel chunk (the optixLaunch unit)."""
    out = trace_wavefront(
        cs, probe, cfg, cam, pixel_x, pixel_y, subframe, area_light=area_light,
        demand_pool=demand_pool,
    )
    new_accum = accumulate(
        accum, out.color, subframe, cfg.samples_per_launch, cfg.clamp_radiance
    )
    frame = tonemap.pack_rgba8(
        tonemap.finalize(new_accum, mode=tonemap.TONEMAP_NONE, srgb=True)
    )
    return new_accum, frame, out


class Renderer:
    """Progressive path-tracing renderer over a compiled scene."""

    def __init__(
        self,
        compiled_scene: CompiledScene,
        probe: Probe,
        config: RenderConfig | None = None,
        camera: Camera | None = None,
        area_light=None,
        demand=None,
    ):
        self.cs = compiled_scene
        self.probe = probe
        self.config = config or RenderConfig()
        self.camera = camera or Camera()
        self.area_light = area_light
        # demand-loaded sparse textures (io.demand.DemandTextureManager):
        # material texture_ids index the manager's sources; every launch
        # returns a page-usage bitmap and the pager services it between
        # launches — the reference's DemandLoader launchPrepare/processRequests
        # cycle (DemandLoaderImpl), with non-resident hits shading fallback
        # colors until their tiles arrive.
        self.demand = demand
        # settle: retry a launch (same subframe/RNG) until its working set is
        # resident before folding it into the progressive mean — keeps the
        # accumulated estimator free of fallback-shaded samples (critical on
        # checkpoint resume: converged accum + empty pool). Set False for
        # reference-style render-with-what's-resident behavior.
        self.demand_settle = True
        self.demand_settle_max = 32
        self.subframe_index = 0
        self._frame_times: list[float] = []
        self.resize(self.config.width, self.config.height)

    # -- state management ----------------------------------------------------
    TILE_W, TILE_H = 16, 8  # pixel-tile shape for ray-block coherence

    def resize(self, width: int, height: int) -> None:
        """Reallocate framebuffers (SimplePathtracer resize :109-126).

        Pixels are ordered in TILE_W x TILE_H tiles (not scanlines): a
        16x8 pixel tile's rays form a far tighter bundle than a 128-wide
        scanline strip, so neighbouring traversal threads walk the same
        nodes. The permutation is static; all image-space outputs are
        unpermuted on read."""
        self.config = dataclasses.replace(self.config, width=width, height=height)
        n = width * height
        ys, xs = np.divmod(np.arange(n, dtype=np.int32), width)
        tw, th = self.TILE_W, self.TILE_H
        tiles_x = -(-width // tw)
        tile_id = (ys // th) * tiles_x + (xs // tw)
        within = (ys % th) * tw + (xs % tw)
        perm = np.argsort(tile_id * (tw * th) + within, kind="stable")
        self._perm = perm
        self._inv_perm = jnp.asarray(np.argsort(perm, kind="stable"))
        self._px = jnp.asarray(xs[perm])
        self._py = jnp.asarray(ys[perm])
        self.accum = Vec3.zeros((n,))
        self.subframe_index = 0
        self._last: SampleOutput | None = None
        self._frame_u8 = None

    def set_camera(self, camera: Camera) -> None:
        camera.aspect_ratio = self.config.width / self.config.height
        self.camera = camera
        self.subframe_index = 0  # camera motion restarts accumulation

    def set_probe(self, probe: Probe) -> None:
        self.probe = probe
        self.subframe_index = 0

    # -- rendering -------------------------------------------------------------
    def render(self, download: bool = True) -> np.ndarray | None:
        """One progressive launch; returns the (H, W, 4) uint8 frame.

        With cfg.dispatch_tiles > 1 the frame is traced in that many
        sequential pixel-chunk dispatches (bounds the device memory of one
        launch and the BFS worklist).

        download=False keeps the frame on device and returns None — the
        progressive-loop mode (the reference's render() also leaves pixels
        on the GPU; downloadPixels is a separate call). Use
        download_pixels() to fetch the latest frame when needed."""
        t0 = time.perf_counter()
        cam = CameraParams.from_camera(self.camera)
        tiles = max(1, self.config.dispatch_tiles)
        n = self._px.shape[0]
        chunk = -(-n // tiles)
        sub = jnp.uint32(self.subframe_index)
        def compute():
            dpool = self.demand.pool if self.demand is not None else None
            if tiles == 1:
                return _render_step(
                    self.cs, self.probe, self.config, cam,
                    self._px, self._py, self.accum, sub, self.area_light, dpool,
                )
            accum_parts, frame_parts, outs = [], [], []
            for t in range(tiles):
                s = t * chunk
                e = min(n, s + chunk)
                a_chunk = jax.tree.map(lambda v: v[s:e], self.accum)
                na, fr, out = _render_step(
                    self.cs, self.probe, self.config, cam,
                    self._px[s:e], self._py[s:e], a_chunk, sub,
                    self.area_light, dpool,
                )
                accum_parts.append(na)
                frame_parts.append(fr)
                outs.append(out)
            accum = jax.tree.map(lambda *xs: jnp.concatenate(xs), *accum_parts)
            frame = jnp.concatenate(frame_parts)

            def _merge(*xs):
                if xs[0].ndim == 0:  # scalar metrics (ray counts) sum up
                    return sum(xs[1:], xs[0])
                if xs[0].dtype == jnp.bool_:  # page-usage bitmaps OR up
                    out = xs[0]
                    for x in xs[1:]:
                        out = out | x
                    return out
                return jnp.concatenate(xs)

            return accum, frame, jax.tree.map(_merge, *outs)

        if self.demand is None:
            self.accum, frame, self._last = compute()
        else:
            # settle loop: a launch that touched any NON-resident page shaded
            # those hits with flat fallback colors — folding it into the
            # progressive mean would bake that bias in permanently (worst on
            # checkpoint resume, where accum is converged but the pool starts
            # empty). Service the usage bitmap and RETRY the same subframe
            # (identical RNG) until the working set is resident, then keep
            # exactly one unbiased launch. Bounded: each retry strictly grows
            # residency, so it ends in ceil(working_set / capacity) passes.
            for _ in range(max(2, self.demand_settle_max)):
                new_accum, frame, self._last = compute()
                usage = np.asarray(self._last.tex_usage)
                n_pending = int((usage & (self.demand._page_table < 0)).sum())
                self.demand.process_requests(usage)
                if n_pending == 0 or not self.demand_settle:
                    break
                if int(usage.sum()) > self.demand.capacity:
                    # the launch's working set can never be simultaneously
                    # resident — accept the best-effort launch (the
                    # reference's render-with-what's-resident behavior)
                    break
            self.accum = new_accum
        frame.block_until_ready()
        self.subframe_index += 1
        self._frame_u8 = frame
        self._frame_times.append(time.perf_counter() - t0)
        return self.download_pixels() if download else None

    def render_n(self, n: int) -> np.ndarray:
        for _ in range(n):
            out = self.render()
        return out

    # -- outputs ---------------------------------------------------------------
    def _to_image(self, v: Vec3) -> np.ndarray:
        h, w = self.config.height, self.config.width
        inv = np.asarray(self._inv_perm)
        img = np.stack(
            [np.asarray(v.x)[inv], np.asarray(v.y)[inv], np.asarray(v.z)[inv]],
            axis=-1,
        ).reshape(h, w, 3)
        return img[::-1]  # row 0 is bottom (GL convention) -> flip for images

    def download_pixels(self) -> np.ndarray:
        """(H, W, 4) uint8, top row first (SampleRenderer::downloadPixels)."""
        h, w = self.config.height, self.config.width
        u8 = np.asarray(self._frame_u8)[np.asarray(self._inv_perm)]
        return u8.reshape(h, w, 4)[::-1]

    def accum_image(self) -> np.ndarray:
        return self._to_image(self.accum)

    def aovs(self) -> dict[str, np.ndarray]:
        """normal/albedo/alpha/depth AOVs of the last launch (denoiser
        inputs; depth is (H, W), 0 on miss)."""
        if self._last is None:
            raise RuntimeError("render() first")
        h, w = self.config.height, self.config.width
        inv = np.asarray(self._inv_perm)
        depth = np.asarray(self._last.depth)[inv].reshape(h, w)[::-1]
        return {
            "normal": self._to_image(self._last.normal),
            "albedo": self._to_image(self._last.albedo),
            "alpha": self._to_image(self._last.alpha),
            "depth": depth,
        }

    def denoised_image(self, **kwargs) -> np.ndarray:
        """AOV-guided À-Trous denoise of the current accumulation
        (the OptixDenoiser exec() role, done for real)."""
        import jax.numpy as jnp

        from ..ops.denoise import atrous_denoise

        aov = self.aovs()
        return np.asarray(
            atrous_denoise(
                jnp.asarray(self.accum_image()),
                jnp.asarray(aov["normal"]),
                jnp.asarray(aov["albedo"]),
                **kwargs,
            )
        )

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        """displayStats-style numbers (sutil.cpp:723-783) as structured data."""
        times = self._frame_times[-64:]
        if not times:
            return {"frames": 0}
        spp_total = self.subframe_index * self.config.samples_per_launch
        return {
            "frames": self.subframe_index,
            "last_frame_s": times[-1],
            "mean_frame_s": float(np.mean(times)),
            "fps": 1.0 / max(float(np.mean(times)), 1e-9),
            "total_spp": spp_total,
        }

    # -- checkpoint / resume -------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Persist the full progressive state: exact resume (new vs reference,
        which loses all accumulation on exit)."""
        inv = np.asarray(self._inv_perm)
        np.savez(
            path,
            accum=np.stack(
                [np.asarray(self.accum.x)[inv], np.asarray(self.accum.y)[inv],
                 np.asarray(self.accum.z)[inv]]
            ),
            subframe_index=self.subframe_index,
            width=self.config.width,
            height=self.config.height,
            eye=self.camera.eye,
            lookat=self.camera.lookat,
            up=self.camera.up,
            fov_y=self.camera.fov_y,
        )

    def load_checkpoint(self, path: str) -> None:
        d = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        if int(d["width"]) != self.config.width or int(d["height"]) != self.config.height:
            self.resize(int(d["width"]), int(d["height"]))
        a = d["accum"][:, self._perm]  # canonical -> tile order
        self.accum = Vec3(jnp.asarray(a[0]), jnp.asarray(a[1]), jnp.asarray(a[2]))
        self.subframe_index = int(d["subframe_index"])
        self.camera = Camera(
            eye=d["eye"], lookat=d["lookat"], up=d["up"], fov_y=float(d["fov_y"]),
            aspect_ratio=self.config.width / self.config.height,
        )
