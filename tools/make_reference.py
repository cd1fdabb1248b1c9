"""Generate a committed self-reference for the time-to-RMSE bench track
(VERDICT r3 item 1): the bench city rendered to convergence with stratified
sampling (unbiased — same estimator mean as the benched rows; stream-
decorrelated from both the random uniform row and the sobol pipeline row),
max_depth 4.

The artifact (scenes/ref_city_{W}x{H}.npz) stores the converged accumulation
as float16 in the renderer's CANONICAL flat order (row 0 = bottom, y-major),
i.e. exactly `Renderer.accum` unpermuted — bench.py uploads it once and
computes sqrt-space RMSE against it on-device (only scalars cross to the
host per checkpoint).

The accumulation is CHECKPOINTED at power-of-two spp milestones (512 spp
onward, atomic tmp+rename), so a long full-resolution run is usable from
its first milestone; each npz records its own `spp` and bench rows report
the reference spp they measured against.

Run (on the GPU):
  PYTHONPATH=. python tools/make_reference.py                 # 600x400, 4096 spp
  PYTHONPATH=. python tools/make_reference.py --width 1200 --height 800  # full headline res
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _save(path, canonical, w, h, spp):
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp, image=canonical.astype(np.float16), width=w, height=h,
        spp=spp, max_depth=4, scene="city_12500_seed0",
        eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0), fov_y=45.0,
    )
    os.replace(tmp, path)
    print(f"checkpoint {spp} spp -> {path} mean={canonical.mean():.4f}",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=600)
    ap.add_argument("--height", type=int, default=400)
    ap.add_argument("--spp", type=int, default=4096)
    ap.add_argument("--spp-per-launch", type=int, default=8)
    args = ap.parse_args()
    w, h, spl = args.width, args.height, args.spp_per_launch
    if args.spp % spl:
        ap.error(f"--spp {args.spp} must be divisible by --spp-per-launch {spl}")

    from optixpathtracer.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import bench as B
    from optixpathtracer.builder import compile_scene
    from optixpathtracer.core.camera import Camera
    from optixpathtracer.engine.renderer import Renderer
    from optixpathtracer.engine.wavefront import RenderConfig
    from optixpathtracer.lights.probe import build_probe
    from optixpathtracer.utils.platform import auto_tune

    hs = B.build_city_scene(n_boxes=12500)
    cs = compile_scene(hs, leaf_size=8, wide_width=8, build_wide_bvh=False)
    sky = np.full((64, 128, 3), 0.4, np.float32)
    sky[8:12, 30:34] = (60.0, 55.0, 45.0)
    probe = build_probe(sky)
    cam = Camera(eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0), up=(0, 1, 0),
                 fov_y=45, aspect_ratio=w / h)
    cfg = auto_tune(RenderConfig(
        width=w, height=h, samples_per_launch=spl, max_depth=4,
        nee_final_bounce=False, batch_spp=True, sampling="stratified",
    ))
    r = Renderer(cs, probe, cfg, cam)
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", f"ref_city_{w}x{h}.npz")
    inv = np.argsort(r._perm, kind="stable")

    def canonical():
        accum = np.stack([np.asarray(r.accum.x), np.asarray(r.accum.y),
                          np.asarray(r.accum.z)], -1)
        return accum[inv]  # flat (H*W, 3), row 0 = bottom

    # milestone popping (ADVICE r4): fire on `spp_done >= m`, so launch sizes
    # that don't divide the power-of-two milestones still checkpoint
    milestones = sorted(m for m in (512, 1024, 2048, 4096, 8192)
                        if m <= args.spp)
    n_launches = args.spp // spl
    t0 = time.perf_counter()
    for i in range(n_launches):
        r.render(download=False)
        spp_done = (i + 1) * spl
        hit = False
        while milestones and spp_done >= milestones[0]:
            milestones.pop(0)
            hit = True
        if hit or i + 1 == n_launches:
            _save(out, canonical(), w, h, spp_done)
        if (i + 1) % 64 == 0:
            float(r._last.rays_traced)  # hard sync for an honest ETA
            dt = time.perf_counter() - t0
            print(f"{spp_done} spp, {dt:.0f}s "
                  f"(ETA {dt / (i + 1) * (n_launches - i - 1):.0f}s)",
                  flush=True)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
