"""Multi-device rendering: interleaved pixel strips sharded over a device mesh.

Reference scaffold being replaced: sutil/WorkDistribution.h
StaticWorkDistribution (:34-87) — interleaved TILE_WIDTH x TILE_HEIGHT strips
statically assigned to N GPUs — plus CUDAOutputBuffer's ZERO_COPY / CUDA_P2P
multi-GPU modes (CUDAOutputBuffer.h:45-51).

Design: a 1-D `jax.sharding.Mesh` over the slice; the frame's
pixel list is permuted into round-robin row strips so each device gets an
equal, spatially-interleaved share (foveated workloads stay balanced — the
fovea's rows hit every device). Scene/BVH/probe are replicated; pixels and
the accumulation buffer are sharded on the leading axis. The render step is
embarrassingly parallel under shard_map — XLA inserts NO collectives in the
hot loop; only the final frame assembly does an implicit all-gather when the
host reads the sharded array (the reference's PBO handoff equivalent).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..builder import CompiledScene
from ..core.math import Vec3
from ..engine.wavefront import CameraParams, RenderConfig, accumulate, trace_wavefront
from ..lights.probe import Probe

Array = jax.Array


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), axis_names=("tiles",))


class TileLayout(NamedTuple):
    """Round-robin row-strip assignment (StaticWorkDistribution semantics)."""

    pixel_x: np.ndarray  # (N,) int32, permuted so device shards interleave rows
    pixel_y: np.ndarray
    inverse: np.ndarray  # (N,) scatter indices: permuted -> row-major frame

    @staticmethod
    def build(width: int, height: int, n_devices: int, strip_rows: int = 1) -> "TileLayout":
        rows = np.arange(height)
        owner = (rows // strip_rows) % n_devices
        order = np.argsort(owner, kind="stable")  # rows grouped by device
        ys = np.repeat(order, width).astype(np.int32)
        xs = np.tile(np.arange(width, dtype=np.int32), height)
        perm = ys.astype(np.int64) * width + xs
        inverse = np.empty_like(perm)
        inverse[perm] = np.arange(perm.size)
        return TileLayout(pixel_x=xs, pixel_y=ys, inverse=inverse)


def _replicated(mesh: Mesh, tree):
    return jax.tree.map(lambda _: P(), tree)


def _sharded(mesh: Mesh, tree):
    return jax.tree.map(lambda _: P("tiles"), tree)


def make_sharded_step(
    cs: CompiledScene,
    probe: Probe,
    cfg: RenderConfig,
    mesh: Mesh,
    demand_pool=None,
):
    """Build the jitted multi-device progressive step.

    Returned fn: (cam: CameraParams, px, py, accum: Vec3, subframe[, pool])
    -> (new_accum, color_sum, rays[, usage]) with px/py/accum sharded over
    'tiles'. With demand_pool given, the pool rides replicated and the
    per-shard page-usage bitmaps are OR-reduced over the mesh (one small
    psum per frame) so the host pager sees the union working set.
    """
    demand = demand_pool is not None

    def step(cs, probe, cam, px, py, accum, subframe, *pool):
        out = trace_wavefront(
            cs, probe, cfg, cam, px, py, subframe,
            demand_pool=pool[0] if demand else None,
        )
        new_accum = accumulate(
            accum, out.color, subframe, cfg.samples_per_launch, cfg.clamp_radiance
        )
        rays = jax.lax.psum(out.rays_traced, "tiles")
        # per-device ray counts (one scalar per shard, concatenated over the
        # mesh): the load-balance evidence dryrun_multichip asserts on
        rays_dev = out.rays_traced.reshape(1)
        if demand:
            usage = jax.lax.psum(out.tex_usage.astype(jnp.int32), "tiles") > 0
            return new_accum, out.color, rays, rays_dev, usage
        return new_accum, out.color, rays, rays_dev

    in_specs = [
        _replicated(mesh, cs),
        _replicated(mesh, probe),
        _replicated(mesh, CameraParams(Vec3(0, 0, 0), Vec3(0, 0, 0), Vec3(0, 0, 0), Vec3(0, 0, 0))),
        P("tiles"),
        P("tiles"),
        _sharded(mesh, Vec3(0, 0, 0)),
        P(),
    ]
    out_specs = [
        _sharded(mesh, Vec3(0, 0, 0)),
        _sharded(mesh, Vec3(0, 0, 0)),
        P(),
        P("tiles"),
    ]
    if demand:
        in_specs.append(_replicated(mesh, demand_pool))
        out_specs.append(P())

    # check_vma=False: the traversal kernel's ffi_call outputs don't carry
    # varying-mesh-axis metadata; the specs above fully pin the sharding
    shard = jax.shard_map(
        step, mesh=mesh, in_specs=tuple(in_specs), out_specs=tuple(out_specs),
        check_vma=False,
    )

    @jax.jit
    def run(cam, px, py, accum, subframe, *pool):
        return shard(cs, probe, cam, px, py, accum, subframe, *pool)

    return run


class DistributedRenderer:
    """Progressive renderer sharded over a device mesh (strip DP)."""

    def __init__(
        self,
        compiled_scene: CompiledScene,
        probe: Probe,
        config: RenderConfig,
        camera,
        mesh: Mesh | None = None,
        demand=None,
    ):
        self.cs = compiled_scene
        self.probe = probe
        self.config = config
        self.camera = camera
        # demand-loaded sparse textures over the mesh: the pool is
        # replicated, every shard samples it, usage bitmaps OR-reduce over
        # 'tiles' and the (host-side, single) pager services the union
        self.demand = demand
        # same settle semantics as engine.renderer.Renderer: retry a launch
        # until its (union) working set is resident so fallback-shaded
        # samples never enter the progressive mean
        self.demand_settle = True
        self.demand_settle_max = 32
        self.mesh = mesh or make_mesh()
        n_dev = self.mesh.devices.size
        assert (config.width * config.height) % n_dev == 0, (
            "frame pixels must divide evenly over devices"
        )
        self.layout = TileLayout.build(config.width, config.height, n_dev)
        sharding = NamedSharding(self.mesh, P("tiles"))
        self._px = jax.device_put(jnp.asarray(self.layout.pixel_x), sharding)
        self._py = jax.device_put(jnp.asarray(self.layout.pixel_y), sharding)
        n = config.width * config.height
        z = jnp.zeros((n,), jnp.float32)
        self.accum = Vec3(*(jax.device_put(z, sharding) for _ in range(3)))
        self.subframe_index = 0
        self.last_rays = 0.0
        self.last_rays_per_device: np.ndarray | None = None
        self._step = make_sharded_step(
            compiled_scene, probe, config, self.mesh,
            demand_pool=demand.pool if demand is not None else None,
        )

    def render(self) -> None:
        cam = CameraParams.from_camera(self.camera)
        sub = jnp.uint32(self.subframe_index)
        if self.demand is not None:
            for _ in range(max(2, self.demand_settle_max)):
                new_accum, _, rays, rays_dev, usage = self._step(
                    cam, self._px, self._py, self.accum, sub, self.demand.pool
                )
                u = np.asarray(usage)
                n_pending = int((u & (self.demand._page_table < 0)).sum())
                self.demand.process_requests(u)
                if n_pending == 0 or not self.demand_settle:
                    break
                if int(u.sum()) > self.demand.capacity:
                    break  # working set can never be simultaneously resident
            self.accum = new_accum
        else:
            self.accum, _, rays, rays_dev = self._step(
                cam, self._px, self._py, self.accum, sub
            )
        jax.block_until_ready(self.accum)
        self.subframe_index += 1
        self.last_rays = float(rays)
        self.last_rays_per_device = np.asarray(rays_dev)

    def accum_image(self) -> np.ndarray:
        """Gather shards and undo the strip permutation -> (H, W, 3), top-first."""
        h, w = self.config.height, self.config.width
        flat = np.stack(
            [np.asarray(self.accum.x), np.asarray(self.accum.y), np.asarray(self.accum.z)],
            axis=-1,
        )
        frame = flat[self.layout.inverse]  # permuted slots -> row-major pixels
        return frame.reshape(h, w, 3)[::-1]
