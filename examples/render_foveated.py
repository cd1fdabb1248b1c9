"""Foveated rendering demo: gaze-contingent 3-zone path tracing (sv4 config).

Run: python examples/render_foveated.py [out.png]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.engine.foveated import FoveatedRenderer, FoveationConfig
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.io.image import save_png
from optixpathtracer.lights.probe import build_probe
from optixpathtracer.utils.cache import enable_compilation_cache


def main():
    enable_compilation_cache()
    out = sys.argv[1] if len(sys.argv) > 1 else "foveated.png"

    sky = np.full((32, 64, 3), 0.35, np.float32)
    sky[4:7, 14:18] = (30.0, 28.0, 24.0)
    probe = build_probe(sky)

    hs = HostScene()
    hs.add_box(make_material(color=(0.75, 0.75, 0.75)), pos=(0, -0.1, 0), extent=(8, 0.1, 8))
    for p, c in [((-1, 0.5, 0), (0.85, 0.2, 0.2)), ((0.9, 0.7, 0.4), (0.2, 0.7, 0.3)),
                 ((0, 0.3, 1.5), (0.3, 0.4, 0.9))]:
        hs.add_box(make_material(color=c, roughness=0.5), pos=p, extent=(0.4, 0.5, 0.4))
    cs = compile_scene(hs)

    from optixpathtracer.utils.platform import auto_tune

    w, h = 480, 360
    cfg = auto_tune(RenderConfig(width=w, height=h, max_depth=3))
    cam = Camera(eye=(4, 2.5, 5), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=40,
                 aspect_ratio=w / h)
    fr = FoveatedRenderer(cs, probe, cfg, cam,
                          FoveationConfig(inner_radius=50, outer_radius=120))
    fr.set_gaze(w // 2, h // 2)
    frames = int(os.environ.get("FRAMES", "8"))
    for i in range(frames):
        frame = fr.render()
        print(f"frame {i + 1}/{frames}  rays={fr.last_rays:.0f}", flush=True)
    save_png(out, frame)
    print("wrote", out, fr.stats())


if __name__ == "__main__":
    main()
