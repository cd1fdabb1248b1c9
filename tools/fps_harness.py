"""Per-frame fps harness reproducing the reference's measurement files.

The reference commits its benchmark evidence as raw per-frame dumps:
  - per-frame timing rows `i, stateUpdate, render, display, cursorX, cursorY`
    (HelloPathtracing_sv3/main.cpp:348-383 -> data_save.dat / cc.dat);
  - foveated-vs-uniform fps columns (HelloPathtracing_sv4_vmv23/
    final_fps.dat, written via sutil displayStats sutil.cpp:758-773).

This tool renders the same A/B — foveated 3-zone (sv4 radii, zone
spp 1/2/8) against uniform 8 spp at the same resolution and depth — while
the gaze follows a circular trajectory (the reference's gaze is the live
mouse cursor, main.cpp:310-314), and writes both artifacts:

  out/fps_frames.tsv : i  mode  state_s  render_s  display_s  cursorX  cursorY  rays
  out/fps_summary.tsv: city_fov  city_uni   (per-frame fps columns)

Run:  python tools/fps_harness.py [--small] [--frames N] [--out DIR]
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="320x240 smoke size")
    ap.add_argument("--frames", type=int, default=10, help="foveated frames")
    ap.add_argument("--uni-frames", type=int, default=3)
    ap.add_argument("--uni-spp", type=int, default=8)
    ap.add_argument("--out", default="/tmp/fps_harness")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from bench import build_city_scene
    from optixpathtracer.builder import compile_scene
    from optixpathtracer.core.camera import Camera
    from optixpathtracer.lights.probe import build_probe
    from optixpathtracer import models
    from optixpathtracer.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    w, h = (320, 240) if args.small else (1200, 800)
    n_boxes = 400 if args.small else 12500

    hs = build_city_scene(n_boxes=n_boxes)
    print(f"devices: {jax.devices()}", flush=True)
    cs = compile_scene(hs, leaf_size=8, wide_width=8, build_wide_bvh=False)
    print(f"scene compiled: {cs.num_triangles} tris", flush=True)
    sky = np.full((64, 128, 3), 0.4, np.float32)
    sky[8:12, 30:34] = (60.0, 55.0, 45.0)
    probe = build_probe(sky)
    cam = Camera(eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0), up=(0, 1, 0),
                 fov_y=45, aspect_ratio=w / h)

    os.makedirs(args.out, exist_ok=True)
    rows = []          # per-frame rows (sv3 data_save.dat columns + mode/rays)
    fov_fps, uni_fps = [], []

    # ---- foveated: gaze orbits the frame center like a moving cursor ----
    # at smoke size, scale the sv4 radii (157/515 at 2160p) to the frame so
    # the zone grids don't overflow it (the 4K measurement uses them as-is)
    fov = None
    if args.small:
        from optixpathtracer.engine.foveated import FoveationConfig

        fov = FoveationConfig(inner_radius=max(8, 157 * h // 2160),
                              outer_radius=max(24, 515 * h // 2160))
    fr = models.make_foveated_renderer(cs, probe, cam, w, h, max_depth=4,
                                       foveation=fov)
    t_c = time.perf_counter()
    fr.render()  # compile
    print(f"foveated compiled+first frame: {time.perf_counter()-t_c:.1f}s",
          flush=True)
    fr.accum = type(fr.accum).zeros((w * h,))
    fr.subframe_index = 0
    for i in range(args.frames):
        t0 = time.perf_counter()
        ang = 2 * math.pi * i / max(args.frames, 1)
        gx = int(w / 2 + 0.25 * w * math.cos(ang))
        gy = int(h / 2 + 0.25 * h * math.sin(ang))
        fr.set_gaze(gx, gy)
        t1 = time.perf_counter()
        fr.render()
        t2 = time.perf_counter()
        _ = fr.frame()  # display/tonemap path (the reference's display split)
        t3 = time.perf_counter()
        rows.append((i, "fov", t1 - t0, t2 - t1, t3 - t2, gx, gy, fr.last_rays))
        fov_fps.append(1.0 / (t2 - t1))
        print(f"fov frame {i}: {t2-t1:.2f}s gaze=({gx},{gy})", flush=True)

    # ---- uniform: full-res 8 spp, same depth (final_fps.dat's *_uni) ----
    ur = models.make_disney_pt_renderer(
        cs, probe, cam, w, h, spp=args.uni_spp, max_depth=4,
    )
    t_c = time.perf_counter()
    ur.render()  # compile
    print(f"uniform compiled+first frame: {time.perf_counter()-t_c:.1f}s",
          flush=True)
    for i in range(args.uni_frames):
        t1 = time.perf_counter()
        ur.render()
        t2 = time.perf_counter()
        rows.append((i, "uni", 0.0, t2 - t1, 0.0, w // 2, h // 2,
                     float(ur._last.rays_traced)))
        uni_fps.append(1.0 / (t2 - t1))
        print(f"uni frame {i}: {t2-t1:.2f}s", flush=True)

    with open(os.path.join(args.out, "fps_frames.tsv"), "w") as f:
        f.write("i\tmode\tstate_s\trender_s\tdisplay_s\tcursorX\tcursorY\trays\n")
        for r in rows:
            f.write("\t".join(str(x) for x in r) + "\n")
    with open(os.path.join(args.out, "fps_summary.tsv"), "w") as f:
        f.write("city_fov\tcity_uni\n")
        for i in range(max(len(fov_fps), len(uni_fps))):
            a = fov_fps[i] if i < len(fov_fps) else ""
            b = uni_fps[i] if i < len(uni_fps) else ""
            f.write(f"{a}\t{b}\n")

    mf, mu = float(np.mean(fov_fps)), float(np.mean(uni_fps))
    print(f"{w}x{h} depth 4, {cs.num_triangles} tris: "
          f"foveated {mf:.3f} fps | uniform {mu:.3f} fps | "
          f"speed-up {mf / mu:.1f}x (reference band 11-21x at 4K)")
    print(f"wrote {args.out}/fps_frames.tsv, fps_summary.tsv")


if __name__ == "__main__":
    main()
