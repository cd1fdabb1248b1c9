"""Cornell box with area-light NEE — the classic sanity render.

Run: python examples/render_cornell.py [out.png]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.math import Vec3
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.io.image import save_png
from optixpathtracer.io.obj import load_obj
from optixpathtracer.lights.lights import QuadLight
from optixpathtracer.lights.probe import build_probe
from optixpathtracer.ops import tonemap as tm
from optixpathtracer.utils.cache import enable_compilation_cache

import jax.numpy as jnp


def main():
    enable_compilation_cache()
    out = sys.argv[1] if len(sys.argv) > 1 else "cornell.png"
    scene_path = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell_box.obj")

    hs = load_obj(scene_path)
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 1e-5, np.float32))  # dark env
    light = QuadLight.make(
        corner=(-0.3, 1.985, -0.3), v1=(0.6, 0, 0), v2=(0, 0, 0.6),
        emission=(15.0, 15.0, 15.0),
    )
    from optixpathtracer.utils.platform import auto_tune

    cfg = auto_tune(
        RenderConfig(width=256, height=256, samples_per_launch=8,
                     max_depth=5, emission_all_bounces=True),
        num_triangles=cs.num_triangles,
    )
    cam = Camera(eye=(0, 1.0, 3.6), lookat=(0, 1.0, 0), up=(0, 1, 0),
                 fov_y=40, aspect_ratio=1.0)
    r = Renderer(cs, probe, cfg, cam, area_light=light)
    frames = int(os.environ.get("FRAMES", "8"))
    for i in range(frames):
        r.render()
        print(f"frame {i + 1}/{frames}  {r.stats()['total_spp']} spp", flush=True)

    acc = r.accum_image()
    v = Vec3(jnp.asarray(acc[..., 0]), jnp.asarray(acc[..., 1]), jnp.asarray(acc[..., 2]))
    disp = tm.finalize(v, mode="reinhard", exposure_stops=1.0)
    save_png(out, np.stack([np.asarray(disp.x), np.asarray(disp.y), np.asarray(disp.z)], -1))
    print("wrote", out)


if __name__ == "__main__":
    main()
