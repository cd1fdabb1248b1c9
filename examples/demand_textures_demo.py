"""Demand-loaded sparse textures driven by visibility feedback.

A ground plane carries a HUGE (8k x 8k) procedural checkerboard texture —
far too big to keep resident. Primary-ray traversal produces first-hit
(tex, u, v); sampling the sparse pool records page requests; the host pager
services them; the next pass finds the pages resident. Only the pages the
camera actually sees are ever loaded (the whole point of the reference's
DemandLoading library, which its build disables: CMakeLists.txt:385-386).

Run: python examples/demand_textures_demo.py [out.png] [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# the paging loop is host<->device chatty by design (request bitmap down,
# tile rows up, every pass); --cpu runs it on the CPU
if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.math import Vec3, normalize
from optixpathtracer.core.scene import HostScene, Mesh
from optixpathtracer.engine.wavefront import CameraParams, _closest_hit, RenderConfig
from optixpathtracer.io.demand import CheckerBoardSource, DemandTextureManager, sample_demand
from optixpathtracer.io.image import save_png
from optixpathtracer.utils.platform import auto_tune


def main():
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    out = args[0] if args else "demand_textures.png"
    w, h = 640, 400

    hs = HostScene()
    # ground quad, uv-mapped 0..1 across 120 world units
    s = 60.0
    verts = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    hs.add_mesh(Mesh(vertices=verts, indices=faces, texcoords=uvs,
                     material=make_material(color=(1, 1, 1))))
    hs.add_box(make_material(color=(0.8, 0.3, 0.2)), pos=(0, 1.5, 0), extent=(1.5, 1.5, 1.5))
    cs = compile_scene(hs)

    # 8192^2 checkerboard = 17,689 base pages of 62^2 texels; the pool holds
    # 4096 — enough for the visible footprint, a fraction of the full
    # texture. With a 6-level mip chain + distance LOD the footprint drops
    # ~7x further: distant ground resolves from a handful of coarse pages.
    src = CheckerBoardSource(width=8192, height=8192, squares_per_side=128,
                             color_a=(0.9, 0.9, 0.85), color_b=(0.15, 0.2, 0.5))
    mgr = DemandTextureManager([src], capacity=4096, levels=6)

    cam = Camera(eye=(9, 5, 9), lookat=(0, 0.8, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=w / h)
    cfg = auto_tune(RenderConfig(width=w, height=h), cs.num_triangles)
    cp = CameraParams.from_camera(cam)

    ys, xs = np.divmod(np.arange(w * h, dtype=np.int32), w)

    @jax.jit
    def first_hit(px, py):
        dx = 2.0 * (px.astype(jnp.float32) + 0.5) / w - 1.0
        dy = 2.0 * (py.astype(jnp.float32) + 0.5) / h - 1.0
        d = normalize(cp.u * dx + cp.v * dy + cp.w * 1.0)
        o = Vec3(cp.eye.x + 0 * dx, cp.eye.y + 0 * dx, cp.eye.z + 0 * dx)
        rec = _closest_hit(cs, cfg, o, d, 1e-3, 1e16)
        tri = jnp.maximum(rec.tri, 0)
        sc = cs.scene
        w0 = 1.0 - rec.u - rec.v
        tu = sc.uv0u[tri] * w0 + sc.uv1u[tri] * rec.u + sc.uv2u[tri] * rec.v
        tv = sc.uv0v[tri] * w0 + sc.uv1v[tri] * rec.u + sc.uv2v[tri] * rec.v
        # the ground quad is the first mesh -> material 0 carries the demand
        # texture; everything else samples nothing
        mat = sc.material_id[tri]
        tex = jnp.where(rec.hit & (mat == 0), 0, -1)
        shade = jnp.abs(d.y)  # simple headlight-ish term for the demo image
        # screen-space texel footprint -> mip LOD: pixel solid angle grows
        # the footprint with hit distance t and with grazing incidence on
        # the ground plane (1/|d.y|); one 8192-texel texture spans 120 units
        import math

        pixel_ang = 2.0 * math.tan(math.radians(45.0 / 2)) / h
        texel_sz = (2 * 60.0) / 8192.0
        foot = rec.t * pixel_ang / jnp.maximum(jnp.abs(d.y), 1e-3) / texel_sz
        lod = jnp.clip(jnp.log2(jnp.maximum(foot, 1.0)), 0.0, 5.0)
        return tex, tu, tv, rec.hit, shade, lod

    tex, tu, tv, hit, shade, lod = first_hit(jnp.asarray(xs), jnp.asarray(ys))

    sample = jax.jit(lambda pool, t, u, v, l: sample_demand(
        pool, t, u, v, l, trilinear=True))
    for npass in range(1, 12):
        color, resident, usage = sample(mgr.pool, tex, tu, tv, lod)
        n_used = int(np.asarray(usage).sum())
        loaded = mgr.process_requests(usage)
        print(f"pass {npass}: touched {n_used} pages, loaded {loaded} "
              f"(total {mgr.pages_loaded}, evicted {mgr.pages_evicted})")
        if loaded == 0:
            break

    total = mgr.num_pages
    print(f"resident {int((np.asarray(mgr.pool.page_table) >= 0).sum())} / "
          f"{total} pages ({mgr.pages_loaded} loads) — sparse residency; "
          f"distance LOD resolves distant ground from coarse mip pages")

    img = np.zeros((w * h, 3), np.float32)
    rgb = np.stack([np.asarray(color.x), np.asarray(color.y), np.asarray(color.z)], -1)
    hitm = np.asarray(hit)
    img[hitm] = rgb[hitm] * np.asarray(shade)[hitm, None]
    img[~hitm] = (0.4, 0.55, 0.8)
    img = img.reshape(h, w, 3)[::-1]
    save_png(out, (np.clip(img, 0, 1) ** (1 / 2.2) * 255).astype(np.uint8))
    print("wrote", out)


if __name__ == "__main__":
    main()
