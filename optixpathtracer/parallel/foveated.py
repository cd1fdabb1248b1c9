"""Multi-device foveated rendering: the fused zone wavefront sharded by lanes.

The reference's multi-GPU scaffold (sutil/WorkDistribution.h:34-87) assigns
interleaved pixel STRIPS — under foveation that is load-imbalanced, because
the fovea's pixels carry 8 spp at full resolution while periphery pixels
carry 1 spp at 1/4 resolution (the fovea strip is ~64x the work of a
periphery strip; SURVEY §5 suggests ray-stealing to fix it).

The fix needs no stealing: the fused single-launch foveation
(engine/foveated._fused_step) already expands every zone to per-sample
LANES — one lane == one path == one unit of work — so round-robin
interleaving the concatenated lane list over the device mesh gives every
chip an identical lane count AND an identical zone mix, statically. Each
device re-sorts its own shard by the spatial coherence key inside
trace_wavefront, so block coherence is recovered locally. Per-lane RNG
counters make the estimator bit-identical to the single-device fused mode
(and hence to the reference's three sequential optixLaunches); only the
lane->device assignment changes. Collectives: one psum for the ray count
and the implicit all-gather of per-lane colors at the zone fold — ~22 MB
per 4K frame.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..builder import CompiledScene
from ..core.camera import Camera
from ..core.math import Vec3
from ..engine.foveated import (
    FoveationConfig,
    FoveationZone,
    _expand_zone_lanes,
    _fold_and_splat,
    _zone_lanes,
)
from ..ops import tonemap
from ..engine.wavefront import CameraParams, RenderConfig, trace_wavefront
from ..lights.probe import Probe

Array = jax.Array


def make_fused_foveated_step(
    cs: CompiledScene,
    probe: Probe,
    cfg: RenderConfig,
    zones: tuple[FoveationZone, ...],
    mesh: Mesh,
) -> Callable:
    """Jitted multi-device fused-foveation step:
    (cam, gaze, accum, subframe) -> (new_accum, rays)."""
    n_dev = int(mesh.devices.size)
    fcfg = dataclasses.replace(cfg, samples_per_launch=1, batch_spp=False)
    # per-zone lane counts AFTER the static annulus cull (engine.foveated
    # _zone_lanes drops gaze-independent dead lanes from centered zones)
    n_lanes = sum(len(_zone_lanes(z)[0]) * z.spp for z in zones)
    n_pad = ((n_lanes + n_dev - 1) // n_dev) * n_dev
    pad = n_pad - n_lanes

    def trace_shard(cs_, probe_, cam, px, py, act, lanes, subframe):
        out = trace_wavefront(
            cs_, probe_, fcfg, cam, px, py, subframe,
            active_mask=act, sample_lanes=lanes,
        )
        rays = jax.lax.psum(out.rays_traced, "lanes")
        # per-device ray counts: the static lane balance evidence
        return out.color, rays, out.rays_traced.reshape(1)

    def _repl(tree):
        return jax.tree.map(lambda _: P(), tree)

    cam_proto = CameraParams(
        Vec3(0.0, 0.0, 0.0), Vec3(0.0, 0.0, 0.0), Vec3(0.0, 0.0, 0.0),
        Vec3(0.0, 0.0, 0.0),
    )
    shard = jax.shard_map(
        trace_shard,
        mesh=mesh,
        in_specs=(
            _repl(cs), _repl(probe), _repl(cam_proto),
            P("lanes"), P("lanes"), P("lanes"), P("lanes"), P(),
        ),
        out_specs=(jax.tree.map(lambda _: P("lanes"), Vec3(0.0, 0.0, 0.0)), P(),
                   P("lanes")),
        check_vma=False,  # the traversal kernel's ffi_call outputs carry no vma metadata
    )

    def rr(a: Array, fill) -> Array:
        """Pad to a device multiple, then interleave round-robin so shard d
        holds lanes l with l % n_dev == d (equal zone mix per device)."""
        if pad:
            a = jnp.concatenate([a, jnp.full((pad,), fill, a.dtype)])
        return a.reshape(n_pad // n_dev, n_dev).T.reshape(n_pad)

    def unrr(a: Array) -> Array:
        return a.reshape(n_dev, n_pad // n_dev).T.reshape(n_pad)[:n_lanes]

    @jax.jit
    def step(cam: CameraParams, gaze: Array, accum: Vec3, subframe: Array):
        sf = subframe.astype(jnp.uint32)
        # the same lane expansion as the single-device fused launch
        # (engine/foveated._expand_zone_lanes) — identical RNG counters, so
        # only the lane->device assignment differs from fused single-chip
        px, py, act, lanes, grids = _expand_zone_lanes(cfg, zones, gaze, sf)

        color, rays, rays_dev = shard(
            cs, probe, cam,
            rr(px, 0), rr(py, 0), rr(act, False), rr(lanes, 0), subframe,
        )
        # fold back to concat order (the implicit cross-shard gather), then
        # reduce and splat exactly as the single-device fused step does
        color = Vec3(unrr(color.x), unrr(color.y), unrr(color.z))
        return (_fold_and_splat(cfg, zones, grids, color, accum, subframe),
                rays, rays_dev)

    return step


class DistributedFoveatedRenderer:
    """Gaze-contingent progressive renderer over a device mesh.

    Same API and estimator as engine.foveated.FoveatedRenderer(fused=True);
    lanes are statically balanced across devices (see module docstring)."""

    def __init__(
        self,
        compiled_scene: CompiledScene,
        probe: Probe,
        config: RenderConfig,
        camera: Camera,
        foveation: FoveationConfig | None = None,
        mesh: Mesh | None = None,
    ):
        self.cs = compiled_scene
        self.probe = probe
        self.config = config
        self.camera = camera
        self.fov = foveation or FoveationConfig()
        self.mesh = mesh if mesh is not None else Mesh(
            np.asarray(jax.devices()), axis_names=("lanes",)
        )
        self.zones = self.fov.zones(config.width, config.height)
        n = config.width * config.height
        self.accum = Vec3.zeros((n,))
        self.subframe_index = 0
        self.gaze = (config.width // 2, config.height // 2)
        self.last_rays = 0.0
        self.last_rays_per_device: np.ndarray | None = None
        self._frame_times: list[float] = []
        self._step = make_fused_foveated_step(
            compiled_scene, probe, config, self.zones, self.mesh
        )

    def set_gaze(self, x: int, y: int) -> None:
        self.gaze = (int(x), int(y))

    def set_camera(self, camera: Camera) -> None:
        self.camera = camera
        self.subframe_index = 0

    def render(self) -> np.ndarray:
        t0 = time.perf_counter()
        cam = CameraParams.from_camera(self.camera)
        gaze = jnp.asarray(
            [self.gaze[0], self.config.height - 1 - self.gaze[1]], jnp.int32
        )
        self.accum, rays, rays_dev = self._step(
            cam, gaze, self.accum, jnp.uint32(self.subframe_index)
        )
        jax.block_until_ready(self.accum.x)
        self.subframe_index += 1
        self.last_rays = float(rays)
        self.last_rays_per_device = np.asarray(rays_dev)
        self._frame_times.append(time.perf_counter() - t0)
        return self.frame()

    def frame(self, exposure_stops: float = 2.0) -> np.ndarray:
        """Tone-mapped display frame (sv4: exposure 2^2 + Reinhard + sRGB) —
        same contract as engine.foveated.FoveatedRenderer.frame."""
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
