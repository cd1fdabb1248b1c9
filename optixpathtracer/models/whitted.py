"""Config 2 — 'whitted spheres': recursive reflect/refract + shadow rays.

Preset scene in the spirit of the classic OptiX whitted sample the reference
vendors (cuda/whitted.cu + cuda/sphere.cu): glass and metal spheres over a
checkered-ish floor, point lights, constant-color miss.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..builder import CompiledScene, compile_scene
from ..core.camera import Camera
from ..core.materials import make_material
from ..core.math import Vec3
from ..core.scene import HostScene
from ..engine.wavefront import CameraParams
from ..engine.whitted import WhittedConfig, render_whitted
from ..lights.lights import build_lights, make_ambient_light, make_point_light
from ..ops.spheres import build_spheres
from ..ops.tonemap import finalize, TONEMAP_NONE


def default_scene():
    """Spheres + floor + lights (whitted-sample look)."""
    materials = [
        make_material(color=(0.95, 0.95, 0.95), transmission=1.0, eta=1.5, roughness=0.05),
        make_material(color=(0.9, 0.75, 0.3), metallic=1.0, roughness=0.1),
        make_material(color=(0.25, 0.45, 0.9), metallic=0.0, roughness=0.4),
    ]
    spheres = [
        ((0.0, 1.2, 0.0), 1.2, 0),   # glass
        ((-2.4, 0.9, -1.0), 0.9, 1),  # gold
        ((2.2, 0.7, -0.5), 0.7, 2),   # blue plastic
    ]
    ss = build_spheres(spheres, materials)

    hs = HostScene()
    hs.add_box(make_material(color=(0.75, 0.75, 0.75), roughness=0.9),
               pos=(0, -0.15, 0), extent=(12, 0.15, 12))
    cs = compile_scene(hs)

    lights = build_lights([
        make_point_light((6.0, 8.0, 4.0), (1.0, 1.0, 0.95), intensity=120.0),
        make_point_light((-7.0, 6.0, -2.0), (0.6, 0.7, 1.0), intensity=60.0),
        make_ambient_light((1.0, 1.0, 1.0), 0.12),
    ])
    return ss, cs, lights


class WhittedRenderer:
    def __init__(self, ss, cs, lights, cfg: WhittedConfig, camera: Camera,
                 curves=None, dispatch_tiles: int | None = None):
        self.ss, self.cs, self.lights = ss, cs, lights
        self.curves = curves
        self.cfg = cfg
        self.camera = camera
        n = cfg.width * cfg.height
        # the ray tree doubles per level (engine/whitted.py), so a full-
        # resolution single launch peaks at n * 2^depth live rays. Chunk the
        # pixel launch so the deepest level stays ~1M rays, which bounds the
        # launch's device memory; every chunk reuses ONE compiled step
        # (identical shapes), so the chunk count must divide n.
        if dispatch_tiles is None:
            dispatch_tiles = -(-n * (2 ** cfg.max_depth) // 1_000_000)
        dispatch_tiles = min(max(1, dispatch_tiles), n)
        while n % dispatch_tiles:
            dispatch_tiles += 1
        self.dispatch_tiles = dispatch_tiles
        chunk = n // dispatch_tiles
        ys, xs = np.divmod(np.arange(n, dtype=np.int32), cfg.width)
        self._px = [jnp.asarray(xs[i * chunk:(i + 1) * chunk])
                    for i in range(dispatch_tiles)]
        self._py = [jnp.asarray(ys[i * chunk:(i + 1) * chunk])
                    for i in range(dispatch_tiles)]
        self.accum = Vec3.zeros((n,))
        self.subframe_index = 0
        from ..engine.whitted import light_kinds

        kinds = light_kinds(lights)
        self._step = jax.jit(
            lambda cam, sub, px, py: render_whitted(
                self.ss, self.cs, self.lights, self.cfg, cam, px, py,
                sub, kinds=kinds, curves=self.curves,
            )
        )

    def render(self) -> np.ndarray:
        """Progressive accumulation like whitted.cu raygen (:91-102)."""
        cam = CameraParams.from_camera(self.camera)
        sub = jnp.uint32(self.subframe_index)
        parts = [self._step(cam, sub, px, py)
                 for px, py in zip(self._px, self._py)]
        out = Vec3(
            jnp.concatenate([p.x for p in parts]),
            jnp.concatenate([p.y for p in parts]),
            jnp.concatenate([p.z for p in parts]),
        )
        a = 1.0 / (self.subframe_index + 1.0)
        self.accum = out if self.subframe_index == 0 else self.accum + (out - self.accum) * a
        self.subframe_index += 1
        disp = finalize(self.accum, mode=TONEMAP_NONE, srgb=True)
        h, w = self.cfg.height, self.cfg.width
        img = np.stack([np.asarray(disp.x), np.asarray(disp.y), np.asarray(disp.z)], -1)
        return img.reshape(h, w, 3)[::-1]


def make_renderer(width=768, height=576, max_depth=3) -> WhittedRenderer:
    ss, cs, lights = default_scene()
    cfg = WhittedConfig(width=width, height=height, max_depth=max_depth)
    cam = Camera(eye=(0.0, 3.2, 9.0), lookat=(0.0, 1.0, 0.0), up=(0, 1, 0),
                 fov_y=40, aspect_ratio=width / height)
    return WhittedRenderer(ss, cs, lights, cfg, cam)
