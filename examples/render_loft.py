"""Render the bundled textured interior (scenes/loft.obj).

The loft is a CLOSED scene — the sky probe never leaks in — so it is lit by
its emissive ceiling panels and window via emission_all_bounces (the
reference's cornell-style closed scenes render black there, since it adds
emission only on primary hits; see RenderConfig.emission_all_bounces).

Run: python examples/render_loft.py [out.png]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.io.image import save_png
from optixpathtracer.io.obj import load_obj
from optixpathtracer.lights.probe import build_probe
from optixpathtracer.utils.platform import auto_tune


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "loft.png"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hs = load_obj(os.path.join(root, "scenes", "loft.obj"))
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 1e-6, np.float32))  # closed room
    w, h = 480, 320
    cfg = auto_tune(
        RenderConfig(
            width=w, height=h, samples_per_launch=4, max_depth=4,
            emission_all_bounces=True, use_shading_normals=True,
        )
    )
    cam = Camera(
        eye=(-5.2, 2.4, 3.2), lookat=(2.0, 1.2, -1.0), up=(0, 1, 0),
        fov_y=55, aspect_ratio=w / h,
    )
    r = Renderer(cs, probe, cfg, cam)
    frames = 8
    for i in range(frames):
        img = r.render()
        print(f"frame {i + 1}/{frames}", flush=True)
    save_png(out, img)
    print("wrote", out, "- denoised:", out.replace(".png", "_denoised.png"))
    save_png(out.replace(".png", "_denoised.png"),
             np.clip(np.sqrt(np.clip(r.denoised_image(), 0, None)), 0, 1))


if __name__ == "__main__":
    main()
