#!/usr/bin/env python3
"""Smoke test of the path tracer on an NVIDIA GPU, through its user entry points.

    python chip_smoke.py           # one card: every phase below, in order
    python chip_smoke.py --multi   # four cards: the sharded renderers only

One-card phases (--phases picks a subset, for debugging):
  build      compile the CUDA traversal kernel (timed as set-up)
  tests      tests/test_traverse_gpu.py's tests marked `gpu` (kernel vs
             oracle), in-process
  exactness  kernel and XLA lockstep traversal against the brute-force
             oracle on the 150k-triangle city: closest and any hit, for the
             8192 mixed gate rays and the 1200x1024 camera rays
  timing     kernel vs lockstep on camera rays and on bounce rays, sorted
             and unsorted
  render     models.make_disney_pt_renderer at its published settings
             (1200x1024, 32 spp, depth 8) on the city: compile time, frame
             time, memory, and a same-seed comparison with lockstep
  cli        the same render through `render` of the command line, in-process
  quality    uniform PT at 600x400 to RMSE <= 0.03 against
             scenes/ref_city_600x400.npz

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "smoke")
WIDTH, HEIGHT, SPP, DEPTH = 1200, 1024, 32, 8  # models/__init__.py disney_pt
FOV_WIDTH, FOV_HEIGHT = 3840, 2160  # models/__init__.py foveated (sv4)
PHASES = ("build", "tests", "exactness", "timing", "render", "cli", "quality")

# Tolerances. Traversal is exact, so a traversal and the brute-force oracle
# differ only by floating-point contraction and order (FMA in nvcc and in
# XLA's fusions): t agrees to a few ulps of f32, and a ray may report another
# triangle (or miss) only where the f32 decision is ill-conditioned: two hits
# tie in t (shared edges, coplanar faces), or the ray passes so close to a
# triangle edge that f32 rounding decides inside/outside. Edge grazes are
# checked in float64: one of the two candidate triangles must have its
# smallest barycentric within EDGE_BARY of 0. Moller-Trumbore in f32 forms
# u, v from coordinates ~100 units out with edges ~0.5 long, so one rounding
# of a coordinate (~100 * 6e-8) moves u by ~1e-5.
T_REL = 1e-5  # t vs the oracle where both report the same triangle, relative
TIE_REL = 1e-6  # another triangle at the same t, relative: a tie
EDGE_BARY = 2e-5  # another triangle, or hit vs miss, at an edge graze
IMAGE_REL_RMSE = 0.01  # renders that differ only in float order, / mean radiance


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args, reps: int = 5):
    """(result, median seconds, min seconds) after one warm-up call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return out, ts[len(ts) // 2], ts[0]


class Ctx:
    """Scene, camera and probe shared by the phases (built once)."""

    def __init__(self):
        import numpy as np

        import bench
        from optixpathtracer.builder import compile_scene
        from optixpathtracer.core.camera import Camera
        from optixpathtracer.lights.probe import build_probe

        t0 = time.perf_counter()
        self.hs = bench.build_city_scene(12500)
        self.cs = compile_scene(self.hs, leaf_size=8, build_wide_bvh=False)
        log(f"scene: {self.cs.num_triangles} triangles, "
            f"{self.cs.bvh.num_internal} nodes, built in "
            f"{time.perf_counter() - t0:.2f} s")
        sky = np.full((64, 128, 3), 0.4, np.float32)
        sky[8:12, 30:34] = (60.0, 55.0, 45.0)
        self.probe = build_probe(sky)
        self.camera = lambda w, h: Camera(**bench.CITY_CAMERA, aspect_ratio=w / h)
        self.gate = bench.gate_rays(self.hs, self.camera(WIDTH, HEIGHT))


def camera_rays(cam, w, h):
    """Pixel-centre primary rays, (w*h, 3) origins and unit directions."""
    import numpy as np

    uu, vv, ww = (np.asarray(a, np.float32) for a in cam.uvw_frame())
    ys, xs = np.divmod(np.arange(w * h, dtype=np.float32), w)
    dx = 2.0 * (xs + 0.5) / w - 1.0
    dy = 2.0 * (ys + 0.5) / h - 1.0
    d = dx[:, None] * uu + dy[:, None] * vv + ww
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(np.asarray(cam.eye, np.float32), d.shape)
    return np.ascontiguousarray(o), d.astype(np.float32)


def vec3(a):
    import jax.numpy as jnp

    from optixpathtracer.core.math import Vec3

    return Vec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def tracers(cs):
    """traversal name -> (jitted closest(o, d, t_min, t_max), jitted any)."""
    import jax

    from optixpathtracer.ops import traverse, traverse_gpu

    gpu_c = jax.jit(lambda p, o, d, lo, hi: traverse_gpu.closest_hit(p, o, d, lo, hi))
    gpu_a = jax.jit(lambda p, o, d, lo, hi: traverse_gpu.any_hit(p, o, d, lo, hi))
    ls_c = jax.jit(lambda b, s, o, d, lo, hi: traverse.closest_hit(b, s, o, d, lo, hi))
    ls_a = jax.jit(lambda b, s, o, d, lo, hi: traverse.any_hit(b, s, o, d, lo, hi))
    return {
        "gpu": (lambda *r: gpu_c(cs.packed, *r), lambda *r: gpu_a(cs.packed, *r)),
        "lockstep": (lambda *r: ls_c(cs.bvh, cs.scene, *r),
                     lambda *r: ls_a(cs.bvh, cs.scene, *r)),
    }


def phase_build(ctx):
    from optixpathtracer.ops import traverse_gpu

    fresh = not os.path.exists(traverse_gpu.library_path())
    t0 = time.perf_counter()
    traverse_gpu.register()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({'compiled' if fresh else 'cached'} {traverse_gpu.library_path()})")


def phase_tests(ctx):
    import pytest

    # tests/conftest.py pins JAX to the CPU unless JAX_PLATFORMS names
    # another platform; this process already runs on the GPU
    os.environ["JAX_PLATFORMS"] = "cuda"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_traverse_gpu.py")])
    log(f"tests marked gpu: pytest exit {int(rc)}")
    if rc != 0:
        raise AssertionError(f"gpu tests failed (pytest exit {int(rc)})")


def phase_exactness(ctx):
    import jax
    import numpy as np

    from optixpathtracer.ops.traverse import brute_force_closest_hit

    cs = ctx.cs
    oracle = jax.jit(lambda s, o, d, lo, hi: brute_force_closest_hit(
        s, o, d, lo, hi, num_valid=cs.num_triangles, ray_chunk=1024))
    rng = np.random.default_rng(7)
    sets = {"mixed8192": ctx.gate,
            f"camera{WIDTH}x{HEIGHT}": camera_rays(ctx.camera(WIDTH, HEIGHT), WIDTH, HEIGHT)}
    failures = []
    for set_name, (o_np, d_np) in sets.items():
        n = len(o_np)
        o, d = vec3(o_np), vec3(d_np)
        t_any = rng.uniform(0.5, 80.0, n).astype(np.float32)
        t0 = time.perf_counter()
        ref = jax.block_until_ready(oracle(cs.scene, o, d, 1e-3, 1e16))
        ref_any = np.asarray(oracle(cs.scene, o, d, 1e-2, t_any).tri) >= 0
        log(f"oracle {set_name}: {time.perf_counter() - t0:.1f} s")
        rtri, rt = np.asarray(ref.tri), np.asarray(ref.t)
        for name, (closest, anyhit) in tracers(cs).items():
            rec = closest(o, d, 1e-3, 1e16)
            tri, t = np.asarray(rec.tri), np.asarray(rec.t)
            hit, rhit = tri >= 0, rtri >= 0
            rel = np.abs(t - rt) / np.maximum(np.abs(rt), 1e-30)
            same = (tri == rtri) & hit
            n_t = int((rel[same] > T_REL).sum())
            other = np.nonzero(tri != rtri)[0]
            if len(other) > 1000:
                raise AssertionError(f"{name} {set_name}: {len(other)} rays differ")
            tie = hit[other] & rhit[other] & (rel[other] <= TIE_REL)
            graze = np.array([edge_margin(ctx, o_np[i], d_np[i], (tri[i], rtri[i]))
                              <= EDGE_BARY for i in other], bool)
            n_bad = int((~tie & ~graze).sum())
            occ = np.asarray(anyhit(o, d, 1e-2, t_any))
            n_any = int((occ != ref_any).sum())
            ok = n_t == n_bad == n_any == 0
            log(f"exactness {name:8s} {set_name}: {n} rays, {int(rhit.sum())} hits; "
                f"same tri {int(same.sum())} (t rel max {rel[same].max():.2e}, "
                f"> {T_REL:g}: {n_t}); other tri or hit/miss {len(other)}: "
                f"{int(tie.sum())} ties, {int((~tie & graze).sum())} edge grazes, "
                f"{n_bad} unexplained; any-hit differ {n_any} of "
                f"{int(ref_any.sum())} occluded -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{name} {set_name}")
    if failures:
        raise AssertionError(f"traversal not exact: {failures}")


def edge_margin(ctx, o, d, tris) -> float:
    """Smallest |barycentric| in float64 of ray (o, d) against the given
    triangles (ids < 0 skipped): how close the ray passes to an edge."""
    import numpy as np

    sc = ctx.cs.scene
    best = np.inf
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    for j in tris:
        if j < 0:
            continue
        v0, v1, v2 = (np.array([float(a.x[j]), float(a.y[j]), float(a.z[j])])
                      for a in (sc.v0, sc.v1, sc.v2))
        e1, e2 = v1 - v0, v2 - v0
        p = np.cross(d, e2)
        det = e1 @ p
        if det == 0.0:
            continue
        tv = o - v0
        u = tv @ p / det
        v = d @ np.cross(tv, e1) / det
        best = min(best, abs(u), abs(v), abs(1.0 - u - v))
    return best


def bounce_rays(ctx, o_cam, d_cam, rec, seed=3):
    """Bounce-like rays from the primary hits: origin at the hit, direction
    cosine-distributed about the geometric normal; misses are dead rays
    (t_max = 0), as in the path wavefront."""
    import numpy as np

    sc = ctx.cs.scene
    tri = np.asarray(rec.tri)
    hit = tri >= 0
    k = np.maximum(tri, 0)
    p = o_cam + d_cam * np.where(hit, np.asarray(rec.t), 0.0)[:, None]
    v = [np.stack([np.asarray(a.x)[k], np.asarray(a.y)[k], np.asarray(a.z)[k]], -1)
         for a in (sc.v0, sc.v1, sc.v2)]
    n = np.cross(v[1] - v[0], v[2] - v[0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    n *= -np.sign(np.sum(n * d_cam, axis=1, keepdims=True) + 1e-30)
    g = np.random.default_rng(seed).normal(size=n.shape)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    d = n + g
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    t_max = np.where(hit, 1e16, 0.0).astype(np.float32)
    return p.astype(np.float32), d.astype(np.float32), t_max


def phase_timing(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from optixpathtracer.engine.wavefront import _coherence_key, permute_packed

    cs = ctx.cs
    tr = tracers(cs)
    o_np, d_np = camera_rays(ctx.camera(WIDTH, HEIGHT), WIDTH, HEIGHT)
    n = len(o_np)
    o, d = vec3(o_np), vec3(d_np)
    big = jnp.full((n,), 1e16, jnp.float32)
    rec = tr["gpu"][0](o, d, 1e-3, big)
    bo_np, bd_np, bt_np = bounce_rays(ctx, o_np, d_np, rec)
    bo, bd, bt = vec3(bo_np), vec3(bd_np), jnp.asarray(bt_np)
    log(f"bounce rays: {n} ({int((bt_np > 0).sum())} live)")

    aabb = jnp.asarray(cs.scene_aabb)

    @jax.jit
    def sort(o, d, t_max):
        key = _coherence_key(o, d, t_max <= 0.0, aabb)
        _, perm = jax.lax.sort([key, jax.lax.iota(jnp.uint32, key.shape[0])], num_keys=1)
        x = permute_packed([o.x, o.y, o.z, d.x, d.y, d.z, t_max], perm)
        return type(o)(*x[0:3]), type(d)(*x[3:6]), x[6]

    (so, sd, st), sort_s, _ = timed(sort, bo, bd, bt)
    cases = [
        ("camera", "closest", (o, d, 1e-3, big)),
        ("bounce", "closest", (bo, bd, 1e-3, bt)),
        ("bounce sorted", "closest", (so, sd, 1e-3, st)),
        ("bounce", "any", (bo, bd, 1e-2, bt)),
        ("bounce sorted", "any", (so, sd, 1e-2, st)),
    ]
    card = nvidia_smi()
    log(f"timing on {card}: {n} rays per call; sort+permute of the bounce "
        f"rays {sort_s * 1e3:.2f} ms")
    for rays, kind, args in cases:
        line = []
        for name, (closest, anyhit) in tr.items():
            fn = closest if kind == "closest" else anyhit
            _, med, best = timed(fn, *args, reps=10 if name == "gpu" else 3)
            line.append(f"{name} {med * 1e3:.2f} ms ({n / med / 1e6:.1f} Mrays/s)")
        log(f"timing {kind:7s} {rays:14s}: " + ", ".join(line))


def phase_render(ctx):
    import dataclasses

    import jax
    import numpy as np

    from optixpathtracer import models
    from optixpathtracer.engine.renderer import Renderer, _render_step
    from optixpathtracer.engine.wavefront import CameraParams

    cam = ctx.camera(WIDTH, HEIGHT)
    r = models.make_disney_pt_renderer(ctx.cs, ctx.probe, cam, WIDTH, HEIGHT, SPP, DEPTH)
    cfg = r.config
    log(f"render: disney_pt {WIDTH}x{HEIGHT} spp {SPP} depth {DEPTH}, "
        f"traversal {cfg.traversal}, sort_rays {cfg.sort_rays}, "
        f"dispatch_tiles {cfg.dispatch_tiles}")
    t0 = time.perf_counter()
    r.render(download=False)
    jax.block_until_ready(r.accum)
    first = time.perf_counter() - t0
    times, rays = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        r.render(download=False)
        jax.block_until_ready(r.accum)
        times.append(time.perf_counter() - t0)
        rays.append(float(r._last.rays_traced))
    frame_s = float(np.median(times))
    log(f"render: first frame (compile + run) {first:.2f} s, so compile ~"
        f"{first - frame_s:.2f} s; frames {', '.join(f'{t:.3f}' for t in times)} s; "
        f"{np.median(rays) / frame_s / 1e6:.1f} Mrays/s "
        f"({np.median(rays) / 1e6:.1f} M rays/frame)")
    img = r.accum_image()
    alt = Renderer(ctx.cs, ctx.probe, dataclasses.replace(
        cfg, sort_rays=not cfg.sort_rays), cam)
    alt.render(download=False)
    alt_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        alt.render(download=False)
        jax.block_until_ready(alt.accum)
        alt_times.append(time.perf_counter() - t0)
    log(f"render: sort_rays {not cfg.sort_rays} frames "
        f"{', '.join(f'{t:.3f}' for t in alt_times)} s (median "
        f"{np.median(alt_times):.3f} vs {frame_s:.3f} s with sort_rays {cfg.sort_rays})")
    if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all():
        raise AssertionError(f"render: bad image {img.shape}, finite {np.isfinite(img).all()}")
    lowered = _render_step.lower(
        ctx.cs, ctx.probe, cfg, CameraParams.from_camera(cam), r._px, r._py,
        r.accum, jax.numpy.uint32(0), None, None)
    mem = lowered.compile().memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    gib = 1 / 2**30
    log(f"render memory: arguments {mem.argument_size_in_bytes * gib:.3f} GiB, "
        f"outputs {mem.output_size_in_bytes * gib:.3f} GiB, temporaries "
        f"{mem.temp_size_in_bytes * gib:.3f} GiB; peak_bytes_in_use "
        f"{stats.get('peak_bytes_in_use', 0) * gib:.3f} GiB")

    # same seeds, lockstep traversal: only floating-point order may differ
    spp_cmp = 2
    cmp = {}
    for tr in (cfg.traversal, "lockstep"):
        rc = Renderer(ctx.cs, ctx.probe, dataclasses.replace(
            cfg, traversal=tr, samples_per_launch=spp_cmp), cam)
        t0 = time.perf_counter()
        rc.render(download=False)
        jax.block_until_ready(rc.accum)
        cmp[tr] = (rc.accum_image(), time.perf_counter() - t0)
    (a, ta), (b, tb) = cmp[cfg.traversal], cmp["lockstep"]
    rel = float(np.sqrt(np.mean((a - b) ** 2)) / np.mean(b))
    log(f"render vs lockstep (same seeds, {spp_cmp} spp, depth {DEPTH}): "
        f"RMSE / mean radiance {rel:.2e} (limit {IMAGE_REL_RMSE}), "
        f"max |diff| {np.abs(a - b).max():.3e}; frame incl. compile: "
        f"{cfg.traversal} {ta:.1f} s, lockstep {tb:.1f} s")
    if not rel <= IMAGE_REL_RMSE:
        raise AssertionError(f"render differs from lockstep: {rel:.3e}")


def phase_cli(ctx):
    import numpy as np

    from optixpathtracer import cli
    from optixpathtracer.io.image import decode_png
    from optixpathtracer.io.obj import save_obj

    work = os.path.join(REPO, ".smoke")
    os.makedirs(work, exist_ok=True)
    os.makedirs(OUT, exist_ok=True)
    try:
        scene = os.path.join(work, "city.obj")
        save_obj(scene, ctx.hs)
        out = os.path.join(OUT, "cli_disney_pt.png")
        ckpt = os.path.join(work, "cli_state.npz")
        cam = ctx.camera(WIDTH, HEIGHT)
        argv = ["render", "--model", "disney_pt", "--scene", scene,
                "--width", str(WIDTH), "--height", str(HEIGHT), "--spp", str(SPP),
                "--max-depth", str(DEPTH), "--frames", "2", "--out", out,
                "--checkpoint", ckpt, "--eye", *map(str, cam.eye),
                "--lookat", *map(str, cam.lookat), "--fov-y", str(cam.fov_y)]
        t0 = time.perf_counter()
        rc = cli.main(argv)
        dt = time.perf_counter() - t0
        accum = np.load(ckpt)["accum"]
        png = decode_png(open(out, "rb").read())
        ok = (rc == 0 and np.isfinite(accum).all() and accum.mean() > 0
              and png.shape[:2] == (HEIGHT, WIDTH))
        log(f"cli: render exit {rc}, 2 frames in {dt:.1f} s incl. scene build "
            f"and compile; accumulated mean {accum.mean():.4f}, finite "
            f"{bool(np.isfinite(accum).all())}, png {png.shape} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("cli render failed")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_quality(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from optixpathtracer.engine.renderer import Renderer
    from optixpathtracer.engine.wavefront import RenderConfig
    from optixpathtracer.utils.platform import auto_tune

    ref_d = np.load(os.path.join(REPO, "scenes", "ref_city_600x400.npz"))
    w, h = int(ref_d["width"]), int(ref_d["height"])
    ref_sqrt = np.sqrt(np.clip(ref_d["image"].astype(np.float32), 0, None))
    # bench.quality_track's uniform row: 2 spp per launch, depth 4
    cfg = auto_tune(RenderConfig(width=w, height=h, samples_per_launch=2, max_depth=4,
                                 nee_final_bounce=False, batch_spp=True))
    r = Renderer(ctx.cs, ctx.probe, cfg, ctx.camera(w, h))
    ref_tile = jnp.asarray(ref_sqrt[r._perm])
    rmse = jax.jit(lambda a: jnp.sqrt(jnp.mean(
        (jnp.sqrt(jnp.clip(jnp.stack([a.x, a.y, a.z], -1), 0, None)) - ref_tile) ** 2)))
    max_spp, target = 64, 0.03
    spp, v, t = 0, float("inf"), 0.0
    while spp < max_spp and v > target:
        t0 = time.perf_counter()
        r.render(download=False)
        v = float(rmse(r.accum))
        t += time.perf_counter() - t0
        spp += cfg.samples_per_launch
    log(f"quality: uniform PT {w}x{h} reached RMSE {v:.4f} at {spp} spp "
        f"(target {target} within {max_spp} spp; ref {int(ref_d['spp'])} spp), "
        f"{t:.2f} s incl. first compile")
    if v > target:
        raise AssertionError(f"quality: RMSE {v:.4f} > {target} after {spp} spp")


def phase_multi(ctx, n_dev=4):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from optixpathtracer import models
    from optixpathtracer.engine.renderer import Renderer
    from optixpathtracer.engine.foveated import FoveationConfig
    from optixpathtracer.engine.wavefront import RenderConfig
    from optixpathtracer.parallel.foveated import DistributedFoveatedRenderer
    from optixpathtracer.parallel.tiles import DistributedRenderer, make_mesh
    from optixpathtracer.utils.platform import auto_tune

    devices = jax.devices()
    if len(devices) < n_dev:
        raise RuntimeError(f"--multi needs {n_dev} devices, JAX sees {len(devices)}")
    devices = devices[:n_dev]

    def compare(name, single, sharded, dt1, dtn):
        rel = float(np.sqrt(np.mean((sharded - single) ** 2)) / np.mean(single))
        ok = np.isfinite(sharded).all() and rel <= IMAGE_REL_RMSE
        log(f"multi {name}: sharded over {n_dev} vs one card: RMSE / mean "
            f"{rel:.2e} (limit {IMAGE_REL_RMSE}), max |diff| "
            f"{np.abs(sharded - single).max():.3e}; frame {dtn:.3f} s on {n_dev} "
            f"cards vs {dt1:.3f} s on one -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"multi {name}: sharded differs from one card")

    def frames(r, k=3):
        r.render()  # compile
        ts = []
        for _ in range(k):
            t0 = time.perf_counter()
            r.render()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    # strip data parallelism at the disney_pt preset size
    cam = ctx.camera(WIDTH, HEIGHT)
    cfg = auto_tune(RenderConfig(width=WIDTH, height=HEIGHT, samples_per_launch=SPP,
                                 max_depth=DEPTH))
    one = Renderer(ctx.cs, ctx.probe, cfg, cam)
    dt1 = frames(one)
    many = DistributedRenderer(ctx.cs, ctx.probe, cfg, cam, mesh=make_mesh(devices))
    dtn = frames(many)
    compare(f"strip DP {WIDTH}x{HEIGHT} spp {SPP} depth {DEPTH}", one.accum_image(),
            many.accum_image(), dt1, dtn)

    # fused foveation, lanes round-robin over the cards, at the sv4 4K size
    w4, h4 = FOV_WIDTH, FOV_HEIGHT
    cam4 = ctx.camera(w4, h4)
    fov = FoveationConfig()
    one_f = models.make_foveated_renderer(ctx.cs, ctx.probe, cam4, w4, h4,
                                          foveation=fov, fused=True)
    dt1 = frames(one_f)
    many_f = DistributedFoveatedRenderer(
        ctx.cs, ctx.probe, one_f.config, cam4, foveation=fov,
        mesh=Mesh(np.asarray(devices), axis_names=("lanes",)))
    dtn = frames(many_f)
    compare(f"foveated {w4}x{h4}", one_f.accum_image(), many_f.accum_image(), dt1, dtn)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {platform!r})", file=sys.stderr)
        return 2
    device = {"platform": platform, "kind": devices[0].device_kind,
              "count": len(devices)}
    log(f"device: {device}")
    log(f"nvidia-smi: {nvidia_smi()}")

    sys.path.insert(0, REPO)
    from optixpathtracer.utils.cache import enable_compilation_cache

    log(f"compile cache: {enable_compilation_cache()}")
    ctx = Ctx()
    if args.multi:
        phase_multi(ctx)
    else:
        for name in args.phases.split(","):
            if name not in PHASES:
                raise SystemExit(f"unknown phase {name!r}")
            t0 = time.perf_counter()
            globals()[f"phase_{name}"](ctx)
            log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
