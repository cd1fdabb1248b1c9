"""References for the 3840x2160 foveated quality track (VERDICT r4 item 2 —
the reference's own published configuration, final_fps.dat / sv4
main.cpp:256).

Two artifacts, both of the bench city under the 16:9 camera:

  scenes/ref_city_4k_fovea.npz
      the FOVEA DISC (r <= disc_r around frame center, the sv4 inner radius
      157 by default) rendered to convergence (default 2048 spp,
      Owen-scrambled Sobol — unbiased, same estimator mean as every benched
      row). Stores (idx, image rows) in flat bottom-first pixel order.
  scenes/ref_city_4k_q.npz
      full-frame companion at QUARTER resolution (960x540): the 4K frame's
      4x4 box downsample, rendered at --q-spp (default 256) full-res spp =>
      an effective 16 x 256 = 4096 samples per stored pixel. Quarter-res is
      the information content of the foveated periphery (factor-4 splat), so
      the companion RMSE measures exactly what the periphery can express.

Run (on the GPU):  PYTHONPATH=. python tools/make_reference_4k.py
            (--skip-q / --skip-fovea to split across sessions)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

W4K, H4K = 3840, 2160


def city_setup(w=W4K, h=H4K):
    import bench as B
    from optixpathtracer.builder import compile_scene
    from optixpathtracer.core.camera import Camera
    from optixpathtracer.lights.probe import build_probe

    hs = B.build_city_scene(n_boxes=12500)
    cs = compile_scene(hs, leaf_size=8, wide_width=8, build_wide_bvh=False)
    sky = np.full((64, 128, 3), 0.4, np.float32)
    sky[8:12, 30:34] = (60.0, 55.0, 45.0)
    probe = build_probe(sky)
    cam = Camera(eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0), up=(0, 1, 0),
                 fov_y=45, aspect_ratio=w / h)
    return cs, probe, cam


def disc_pixels(w, h, cx, cy, r):
    """Fovea-disc pixels in 16x8 tile order (camera-ray block coherence)."""
    ys, xs = np.mgrid[0:h, 0:w]
    keep = (xs - cx) ** 2 + (ys - cy) ** 2 <= r * r
    px, py = xs[keep].astype(np.int32), ys[keep].astype(np.int32)
    order = np.lexsort([
        px % 16 + 16 * (py % 8),
        px // 16 + (py // 8) * ((w + 15) // 16),
    ])
    return px[order], py[order]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--disc-spp", type=int, default=2048)
    ap.add_argument("--disc-r", type=int, default=157)
    ap.add_argument("--q-spp", type=int, default=256)
    ap.add_argument("--spp-per-launch", type=int, default=2)
    ap.add_argument("--skip-fovea", action="store_true")
    ap.add_argument("--skip-q", action="store_true")
    args = ap.parse_args()

    from optixpathtracer.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from optixpathtracer.engine.renderer import Renderer
    from optixpathtracer.engine.wavefront import (
        CameraParams,
        RenderConfig,
        trace_wavefront,
    )
    from optixpathtracer.utils.platform import auto_tune

    cs, probe, cam = city_setup()
    scenes_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes")
    cfg = auto_tune(RenderConfig(
        width=W4K, height=H4K, samples_per_launch=args.spp_per_launch,
        max_depth=4, nee_final_bounce=False, batch_spp=True,
        sampling="sobol",
    ))

    # ---- fovea disc at disc_spp ----------------------------------------
    if not args.skip_fovea:
        cx, cy = W4K // 2, H4K // 2  # buffer coords, bottom-first y
        px, py = disc_pixels(W4K, H4K, cx, cy, args.disc_r)
        n = len(px)
        print(f"fovea disc: {n} pixels, {args.disc_spp} spp", flush=True)
        pxj, pyj = jnp.asarray(px), jnp.asarray(py)
        camp = CameraParams.from_camera(cam)

        import functools

        @functools.partial(jax.jit, donate_argnums=(0,))
        def launch(acc, subframe):
            out = trace_wavefront(cs, probe, cfg, camp, pxj, pyj, subframe)
            return (acc[0] + out.color.x, acc[1] + out.color.y,
                    acc[2] + out.color.z), out.rays_traced

        acc = tuple(jnp.zeros((n,), jnp.float32) for _ in range(3))
        spl = cfg.samples_per_launch
        t0 = time.perf_counter()
        for i in range(args.disc_spp // spl):
            acc, rays = launch(acc, jnp.uint32(i))
            if (i + 1) % 128 == 0:
                float(rays)
                dt = time.perf_counter() - t0
                done = (i + 1) * spl
                print(f"  {done} spp, {dt:.0f}s (ETA "
                      f"{dt / done * (args.disc_spp - done):.0f}s)", flush=True)
        img = np.stack([np.asarray(a) for a in acc], -1) / args.disc_spp
        out = os.path.join(scenes_dir, "ref_city_4k_fovea.npz")
        np.savez_compressed(
            out, idx=(py.astype(np.int64) * W4K + px).astype(np.int64),
            image=img.astype(np.float16), width=W4K, height=H4K,
            spp=args.disc_spp, gaze=(cx, cy), disc_r=args.disc_r,
            sampling="sobol", max_depth=4, scene="city_12500_seed0")
        print(f"wrote {out} mean={img.mean():.4f}")

    # ---- quarter-res full-frame companion at q_spp ---------------------
    if not args.skip_q:
        print(f"companion: {W4K}x{H4K} at {args.q_spp} spp -> 960x540",
              flush=True)
        qcfg = cfg
        r = Renderer(cs, probe, qcfg, cam)
        t0 = time.perf_counter()
        n_l = args.q_spp // qcfg.samples_per_launch
        for i in range(n_l):
            r.render(download=False)
            if (i + 1) % 16 == 0:
                float(r._last.rays_traced)
                dt = time.perf_counter() - t0
                done = (i + 1) * qcfg.samples_per_launch
                print(f"  {done} spp, {dt:.0f}s (ETA "
                      f"{dt / done * (args.q_spp - done):.0f}s)", flush=True)
        inv = np.argsort(r._perm, kind="stable")
        accum = np.stack([np.asarray(r.accum.x), np.asarray(r.accum.y),
                          np.asarray(r.accum.z)], -1)[inv]
        full = accum.reshape(H4K, W4K, 3)  # bottom-first rows
        q = full.reshape(540, 4, 960, 4, 3).mean(axis=(1, 3))
        out = os.path.join(scenes_dir, "ref_city_4k_q.npz")
        np.savez_compressed(
            out, image=q.astype(np.float16), width=960, height=540,
            full_width=W4K, full_height=H4K, spp=args.q_spp,
            effective_spp=args.q_spp * 16, sampling="sobol", max_depth=4,
            scene="city_12500_seed0")
        print(f"wrote {out} mean={q.mean():.4f}")


if __name__ == "__main__":
    main()
