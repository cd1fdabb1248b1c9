"""Benchmark: incoherent-ray throughput of the Disney wavefront path tracer.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Workload mirrors the reference's headline config (BASELINE.md): 1200x800
frame, Disney path tracing with probe NEE, max depth 4, on a procedural
box-city scene sized like lost_empire.obj (~150k triangles; the reference's
scene files are external hard-coded Windows paths and not in the repo, so a
same-scale procedural stand-in is used). The metric counts every traced ray
(radiance + shadow) exactly, as accumulated on-device by the wavefront loop.

vs_baseline is against the 100 Mrays/s north-star target (BASELINE.json) —
the reference publishes no Mrays/s number of its own.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def build_city_scene(n_boxes=12500, seed=0):
    """~12.5k boxes x 12 tris = 150k triangles, lost_empire scale."""
    from optixpathtracer.core.materials import make_material
    from optixpathtracer.core.scene import HostScene, Mesh

    rng = np.random.default_rng(seed)
    hs = HostScene()

    # ground slab
    hs.add_box(make_material(color=(0.75, 0.75, 0.75)), pos=(0, -0.5, 0), extent=(60, 0.5, 60))

    # one fused mesh of random boxes (one material per color bucket)
    centers = rng.uniform(-50, 50, size=(n_boxes, 2)).astype(np.float32)
    heights = rng.gamma(2.0, 1.2, size=n_boxes).astype(np.float32) + 0.3
    widths = rng.uniform(0.2, 0.9, size=(n_boxes, 2)).astype(np.float32)

    # build 8 material buckets, each a single fused mesh
    n_buckets = 8
    bucket = rng.integers(0, n_buckets, n_boxes)
    base = np.array(
        [[0.8, 0.3, 0.2], [0.2, 0.7, 0.3], [0.25, 0.35, 0.8], [0.8, 0.75, 0.3],
         [0.6, 0.6, 0.6], [0.8, 0.5, 0.2], [0.4, 0.2, 0.6], [0.7, 0.7, 0.9]],
        np.float32,
    )
    unit_v, unit_f = _unit_box()
    for b in range(n_buckets):
        idx = np.nonzero(bucket == b)[0]
        if len(idx) == 0:
            continue
        k = len(idx)
        scale = np.stack([widths[idx, 0], heights[idx] * 0.5, widths[idx, 1]], -1)
        offset = np.stack(
            [centers[idx, 0], heights[idx] * 0.5, centers[idx, 1]], -1
        )
        verts = unit_v[None] * scale[:, None, :] + offset[:, None, :]
        faces = unit_f[None] + (np.arange(k)[:, None, None] * len(unit_v))
        mat = make_material(color=tuple(base[b]), roughness=float(rng.uniform(0.3, 0.9)))
        hs.add_mesh(
            Mesh(
                vertices=verts.reshape(-1, 3).astype(np.float32),
                indices=faces.reshape(-1, 3).astype(np.int32),
                material=mat,
            )
        )
    return hs


CITY_CAMERA = dict(eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0),
                   up=(0, 1, 0), fov_y=45)


def gate_rays(hs, cam, n=8192, seed=42):
    """The exactness gate's mixed rays: n/2 camera rays through random
    points of the frame and n/2 bounce-like rays from uniform points of
    the (slightly shrunk) scene box in uniform directions. Returns (o, d)
    as (n, 3) float32 arrays with unit directions."""
    rng = np.random.default_rng(seed)
    half = n // 2
    uu, vv, ww = cam.uvw_frame()
    sx = rng.uniform(-1, 1, (half, 1))
    sy = rng.uniform(-1, 1, (half, 1))
    dcam = sx * uu[None] + sy * vv[None] + ww[None]
    ocam = np.broadcast_to(np.asarray(cam.eye, np.float32), (half, 3))
    all_v = np.concatenate([m.vertices for m in hs.meshes])
    lo, hi = all_v.min(0), all_v.max(0)
    c, half_ext = (lo + hi) / 2, (hi - lo) / 2
    obnc = c + rng.uniform(-0.85, 0.85, (half, 3)) * half_ext
    dbnc = rng.normal(0, 1, (half, 3))
    og = np.concatenate([ocam, obnc]).astype(np.float32)
    dg = np.concatenate([dcam, dbnc]).astype(np.float32)
    dg /= np.linalg.norm(dg, axis=1, keepdims=True)
    return og, dg


def build_hostile_scene(n_boxes=9800, seed=3, terrain_grid=(256, 64)):
    """Adversarial traversal geometry (VERDICT r3 item 5): nothing here is
    axis-aligned. A fractal terrain heightfield triangulated on an
    anisotropic grid (256x64 => sliver triangles, like sponza's banners /
    san_miguel's leaves) plus the procedural city rotated 30 degrees about Y
    (every box face off-axis, so the slab cull sees rotated boxes it can
    only bound loosely). ~150k triangles total, lost_empire scale."""
    from optixpathtracer.core.materials import make_material
    from optixpathtracer.core.scene import HostScene, Mesh

    rng = np.random.default_rng(seed)
    hs = HostScene()

    # --- terrain: anisotropic heightfield grid ---------------------------
    gx, gz = terrain_grid  # default 2*255*63 = 32130 thin tris (4:1 aniso)
    xs = np.linspace(-65, 65, gx, dtype=np.float32)
    zs = np.linspace(-65, 65, gz, dtype=np.float32)
    xg, zg = np.meshgrid(xs, zs, indexing="ij")
    h = np.zeros_like(xg)
    for octave in range(4):
        f = 0.02 * (2 ** octave)
        px = rng.uniform(0, 100)
        pz = rng.uniform(0, 100)
        h += (np.sin(xg * f + px) * np.cos(zg * f * 1.7 + pz)) * (2.2 / (octave + 1))
    verts = np.stack([xg, h, zg], -1).reshape(-1, 3).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(gx - 1), np.arange(gz - 1), indexing="ij")
    q = (ii * gz + jj).ravel()
    quads = np.stack([q, q + 1, q + gz, q + gz + 1], -1)
    tris = np.concatenate(
        [quads[:, [0, 1, 2]], quads[:, [2, 1, 3]]], 0
    ).astype(np.int32)
    hs.add_mesh(Mesh(vertices=verts, indices=tris,
                     material=make_material(color=(0.45, 0.5, 0.35),
                                            roughness=0.8)))

    # --- 30-degree-rotated city sitting on the terrain --------------------
    th = np.deg2rad(30.0)
    rot = np.array([[np.cos(th), 0, np.sin(th)],
                    [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]], np.float32)
    centers = rng.uniform(-48, 48, size=(n_boxes, 2)).astype(np.float32)
    heights = rng.gamma(2.0, 1.2, size=n_boxes).astype(np.float32) + 0.3
    widths = rng.uniform(0.2, 0.9, size=(n_boxes, 2)).astype(np.float32)
    # ground height under each box center, sampled at the box's FINAL
    # (post-rotation) footprint — the whole city is rotated about Y below,
    # which keeps y but moves (x, z), so the lookup must use the rotated
    # center (nearest grid sample; corners clamp to the terrain edge)
    rx = centers[:, 0] * np.cos(th) + centers[:, 1] * np.sin(th)
    rz = -centers[:, 0] * np.sin(th) + centers[:, 1] * np.cos(th)
    cx = np.clip(np.rint((rx - xs[0]) / (xs[1] - xs[0])).astype(np.int64),
                 0, gx - 1)
    cz = np.clip(np.rint((rz - zs[0]) / (zs[1] - zs[0])).astype(np.int64),
                 0, gz - 1)
    base_y = h[cx, cz]

    n_buckets = 8
    bucket = rng.integers(0, n_buckets, n_boxes)
    base = np.array(
        [[0.8, 0.3, 0.2], [0.2, 0.7, 0.3], [0.25, 0.35, 0.8], [0.8, 0.75, 0.3],
         [0.6, 0.6, 0.6], [0.8, 0.5, 0.2], [0.4, 0.2, 0.6], [0.7, 0.7, 0.9]],
        np.float32,
    )
    unit_v, unit_f = _unit_box()
    for b in range(n_buckets):
        idx = np.nonzero(bucket == b)[0]
        if len(idx) == 0:
            continue
        k = len(idx)
        scale = np.stack([widths[idx, 0], heights[idx] * 0.5, widths[idx, 1]], -1)
        offset = np.stack(
            [centers[idx, 0], base_y[idx] + heights[idx] * 0.5, centers[idx, 1]],
            -1,
        )
        verts = unit_v[None] * scale[:, None, :] + offset[:, None, :]
        verts = verts.reshape(-1, 3) @ rot.T  # whole city off-axis
        faces = unit_f[None] + (np.arange(k)[:, None, None] * len(unit_v))
        mat = make_material(color=tuple(base[b]),
                            roughness=float(rng.uniform(0.3, 0.9)))
        hs.add_mesh(Mesh(vertices=verts.astype(np.float32),
                         indices=faces.reshape(-1, 3).astype(np.int32),
                         material=mat))
    return hs


def build_big_scene(n_boxes=12500, seed=0, terrain_grid=(1024, 512),
                    extra_rings=2):
    """>=1M unique triangles (VERDICT r4 item 1): the headline city plus a
    finely tessellated multi-octave terrain (unique geometry, no instancing
    — this probes the raw triangle-count axis the way san_miguel does for
    the reference, final_fps.dat col 6) and `extra_rings` concentric
    suburb rings of smaller boxes. Default ~1.35M triangles."""
    from optixpathtracer.core.materials import make_material
    from optixpathtracer.core.scene import HostScene, Mesh

    rng = np.random.default_rng(seed + 100)
    hs = build_city_scene(n_boxes=n_boxes, seed=seed)

    # fine terrain apron AROUND the city (city sits on its own ground slab)
    gx, gz = terrain_grid
    xs = np.linspace(-220, 220, gx, dtype=np.float32)
    zs = np.linspace(-220, 220, gz, dtype=np.float32)
    xg, zg = np.meshgrid(xs, zs, indexing="ij")
    h = np.zeros_like(xg)
    for octave in range(5):
        f = 0.012 * (2 ** octave)
        px = rng.uniform(0, 100)
        pz = rng.uniform(0, 100)
        h += (np.sin(xg * f + px) * np.cos(zg * f * 1.6 + pz)) * (
            3.0 / (octave + 1))
    # depress the terrain under the city footprint so it never pokes
    # through the city's ground slab (|x|,|z| < 62)
    inside = (np.abs(xg) < 62) & (np.abs(zg) < 62)
    h = np.where(inside, -2.5, h - 3.0).astype(np.float32)
    verts = np.stack([xg, h, zg], -1).reshape(-1, 3).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(gx - 1), np.arange(gz - 1), indexing="ij")
    q = (ii * gz + jj).ravel()
    quads = np.stack([q, q + 1, q + gz, q + gz + 1], -1)
    tris = np.concatenate(
        [quads[:, [0, 1, 2]], quads[:, [2, 1, 3]]], 0
    ).astype(np.int32)
    hs.add_mesh(Mesh(vertices=verts, indices=tris,
                     material=make_material(color=(0.4, 0.45, 0.3),
                                            roughness=0.85)))

    # suburb rings: unique small boxes on the terrain apron
    unit_v, unit_f = _unit_box()
    for ring in range(extra_rings):
        k = n_boxes // 2
        r0, r1 = 70 + 60 * ring, 120 + 60 * ring
        rad = rng.uniform(r0, r1, k).astype(np.float32)
        ang = rng.uniform(0, 2 * np.pi, k).astype(np.float32)
        cx = rad * np.cos(ang)
        cz = rad * np.sin(ang)
        hh = rng.gamma(2.0, 0.6, k).astype(np.float32) + 0.2
        ww = rng.uniform(0.15, 0.6, (k, 2)).astype(np.float32)
        # ground height via nearest grid sample
        gix = np.clip(np.rint((cx - xs[0]) / (xs[1] - xs[0])).astype(np.int64),
                      0, gx - 1)
        giz = np.clip(np.rint((cz - zs[0]) / (zs[1] - zs[0])).astype(np.int64),
                      0, gz - 1)
        base_y = h[gix, giz]
        scale = np.stack([ww[:, 0], hh * 0.5, ww[:, 1]], -1)
        offset = np.stack([cx, base_y + hh * 0.5, cz], -1)
        verts = unit_v[None] * scale[:, None, :] + offset[:, None, :]
        faces = unit_f[None] + (np.arange(k)[:, None, None] * len(unit_v))
        hs.add_mesh(Mesh(
            vertices=verts.reshape(-1, 3).astype(np.float32),
            indices=faces.reshape(-1, 3).astype(np.int32),
            material=make_material(
                color=(0.55 + 0.1 * ring, 0.5, 0.45), roughness=0.7),
        ))
    return hs


def quality_track(cs, probe, max_launches=128, ref_path=None):
    """Time-to-quality rows (VERDICT r3 item 1): seconds of render time to
    reach sqrt-space RMSE <= 0.03 against a committed converged stratified
    self-reference (tools/make_reference.py). Runs once against
    scenes/ref_city_600x400.npz (half the headline frame per axis) and,
    when the full-resolution
    artifact scenes/ref_city_1200x800.npz exists, again at the headline
    1200x800 (each row reports the ref_spp it measured against):

      uniform   — random-sampling progressive PT, raw accumulation (the
                  reference renderer's quality trajectory);
      pipeline  — Owen-scrambled Sobol sampling + variance-guided adaptive
                  top-K refinement + AOV-guided A-Trous denoise (every
                  quality subsystem composed; denoise cost counts toward
                  the time). Sobol over stratified: Sobol covers every
                  bounce depth, strata only depth 0;
      foveated  — progressive 3-zone foveation under a static gaze,
                  RMSE over the FOVEA disc (full quality where the user
                  looks — the foveated contract).

    All RMSE checks run ON DEVICE (only scalars cross to the host per
    checkpoint) and double as the hard sync for honest wall-clock.
    Returns a list of JSON records.
    """
    import dataclasses

    import jax
    import jax.numpy as jnp

    from optixpathtracer.core.camera import Camera
    from optixpathtracer.engine.adaptive import AdaptiveRenderer
    from optixpathtracer.engine.foveated import (
        FoveatedRenderer,
        FoveationConfig,
    )
    from optixpathtracer.engine.renderer import Renderer
    from optixpathtracer.engine.wavefront import RenderConfig
    from optixpathtracer.ops.denoise import atrous_denoise
    from optixpathtracer.utils.platform import auto_tune

    if ref_path is None:
        ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "scenes", "ref_city_600x400.npz")
    if not os.path.exists(ref_path):
        # LOUD failure (ADVICE r4 medium): a missing committed reference
        # means the repo's quality headline silently vanishes on a fresh
        # clone — print an unmissable error row AND complain on stderr
        msg = (f"missing committed reference artifact {ref_path} "
               "(regenerate with tools/make_reference.py)")
        print(f"BENCH ERROR: {msg}", file=sys.stderr, flush=True)
        return [{"metric": "time-to-RMSE track", "value": 0.0,
                 "unit": "s", "vs_baseline": 0.0, "error": msg}]
    ref_d = np.load(ref_path)
    w, h = int(ref_d["width"]), int(ref_d["height"])
    ref_spp = int(ref_d["spp"])
    # reference-convergence floor (ADVICE r4 medium): below 2048 spp the
    # RMSE<=0.03 gate carries non-trivial reference noise; mark the rows
    ref_below_floor = ref_spp < 2048
    if ref_below_floor:
        print(f"BENCH WARNING: {ref_path} has ref_spp={ref_spp} < 2048 — "
              "quality rows are marked ref_below_floor",
              file=sys.stderr, flush=True)
    ref = ref_d["image"].astype(np.float32)  # (H*W, 3) canonical, bottom-first
    ref_sqrt = np.sqrt(np.clip(ref, 0, None))
    target = 0.03

    cam = Camera(eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0), up=(0, 1, 0),
                 fov_y=45, aspect_ratio=w / h)
    cfgq = auto_tune(RenderConfig(
        width=w, height=h, samples_per_launch=2, max_depth=4,
        nee_final_bounce=False, batch_spp=True,
    ))
    records = []

    def row(name, label, run):
        """run() yields (seconds_so_far, rmse, spp) checkpoints."""
        secs = spp = None
        rmse = float("inf")
        for t, v, s in run:
            rmse = v
            if v <= target:
                secs, spp = t, s
                break
        rec = {
            "metric": f"seconds to RMSE<=0.03 @{w}x{h} ({label})",
            "value": round(secs, 2) if secs is not None else 0.0,
            "unit": "s",
            "reached": secs is not None,
            "final_rmse": round(rmse, 5),
            "spp": spp,
            "ref_spp": ref_spp,
        }
        if ref_below_floor:
            rec["ref_below_floor"] = True
        records.append((name, rec))
        return rec

    # ---- row 1: uniform random PT ---------------------------------------
    r = Renderer(cs, probe, cfgq, cam)
    ref_tile = jnp.asarray(ref_sqrt[r._perm])

    @jax.jit
    def rmse_uniform(accum):
        img = jnp.stack([accum.x, accum.y, accum.z], -1)
        return jnp.sqrt(jnp.mean(
            (jnp.sqrt(jnp.clip(img, 0, None)) - ref_tile) ** 2))

    def run_uniform():
        r.render(download=False)  # compile
        float(rmse_uniform(r.accum))
        r.resize(w, h)  # reset accumulation
        t = 0.0
        for i in range(max_launches):
            t0 = time.perf_counter()
            r.render(download=False)
            v = float(rmse_uniform(r.accum))  # device check == hard sync
            t += time.perf_counter() - t0
            yield t, v, (i + 1) * cfgq.samples_per_launch

    u_rec = row("uniform", "uniform PT, random sampling", run_uniform())

    # ---- row 2: sobol + adaptive + denoise -------------------------------
    acfg = dataclasses.replace(cfgq, sampling="sobol")
    ar = AdaptiveRenderer(cs, probe, acfg, cam, warmup_spp=2, refine_spp=4,
                          refine_fraction=0.25)
    yx_np = np.asarray(ar._py) * w + np.asarray(ar._px)
    yx_np = np.where(np.asarray(ar._valid), yx_np, w * h)  # dummy slot
    yx = jnp.asarray(yx_np)
    ref2d = jnp.asarray(ref_sqrt.reshape(h, w, 3))

    @jax.jit
    def rmse_pipeline(col, nrm, alb, lum, lum2, count):
        nf1 = jnp.maximum(count.astype(jnp.float32), 1.0)
        nf = nf1[:, None]

        def img(v):
            rows = jnp.stack([v.x, v.y, v.z], -1) / nf
            buf = jnp.zeros((w * h + 1, 3), jnp.float32).at[yx].set(
                rows, mode="promise_in_bounds")
            return buf[: w * h].reshape(h, w, 3)

        mean_l = lum / nf1
        var = jnp.maximum(lum2 / nf1 - mean_l * mean_l, 0.0) / nf1
        vbuf = jnp.zeros((w * h + 1,), jnp.float32).at[yx].set(
            var, mode="promise_in_bounds")
        # denoiser config: variance-scaled heavy color smoothing + albedo demodulation
        dn = atrous_denoise(img(col), img(nrm), img(alb),
                            sigma_color=4.0, sigma_albedo=1.0,
                            variance=vbuf[: w * h].reshape(h, w),
                            var_boost=256.0, demodulate=True)
        return jnp.sqrt(jnp.mean((jnp.sqrt(jnp.clip(dn, 0, None)) - ref2d) ** 2))

    def rmse_p(a):
        return float(rmse_pipeline(a.col_sum, a.nrm_sum, a.alb_sum,
                                   a.lum_sum, a.lum2_sum, a.count))

    def run_pipeline():
        # compile pass on a throwaway state (warmup round + refine round
        # have different launch shapes — warm both), then time fresh
        ar.render()
        rmse_p(ar)
        ar.render()
        rmse_p(ar)
        ar2 = AdaptiveRenderer(cs, probe, acfg, cam, warmup_spp=2,
                               refine_spp=4, refine_fraction=0.25)
        t = 0.0
        for _ in range(48):
            t0 = time.perf_counter()
            ar2.render()
            v = rmse_p(ar2)
            t += time.perf_counter() - t0
            mean_spp = float(np.asarray(ar2.count, np.float32).sum()) / (w * h)
            yield t, v, round(mean_spp, 2)

    p_rec = row("pipeline", "sobol+adaptive+denoise", run_pipeline())

    # ---- row 3: progressive foveation, fovea-disc RMSE -------------------
    fcfg = FoveationConfig(inner_radius=80, outer_radius=200,
                           progressive=True)
    fr = FoveatedRenderer(cs, probe,
                          dataclasses.replace(acfg, samples_per_launch=1),
                          cam, fcfg)
    gx, gy = w // 2, h // 2  # frame center: flip-convention invariant
    fr.set_gaze(gx, gy)
    ii = np.arange(w * h)
    fmask_np = ((ii % w - gx) ** 2 + (ii // w - gy) ** 2) <= 80 ** 2
    fmask = jnp.asarray(fmask_np)
    ref_flat = jnp.asarray(ref_sqrt)

    @jax.jit
    def rmse_fovea(accum):
        img = jnp.stack([accum.x, accum.y, accum.z], -1)
        se = jnp.sum(jnp.where(fmask[:, None],
                               (jnp.sqrt(jnp.clip(img, 0, None)) - ref_flat) ** 2,
                               0.0))
        return jnp.sqrt(se / (fmask_np.sum() * 3))

    def run_fovea():
        # compile pass, then time a fresh progressive accumulation
        fr.render()
        float(rmse_fovea(fr.accum))
        fr2 = FoveatedRenderer(
            cs, probe, dataclasses.replace(acfg, samples_per_launch=1),
            cam, fcfg)
        fr2.set_gaze(gx, gy)
        t = 0.0
        for i in range(40):
            t0 = time.perf_counter()
            fr2.render()
            v = float(rmse_fovea(fr2.accum))
            t += time.perf_counter() - t0
            yield t, v, (i + 1) * fcfg.fovea_spp

    f_rec = row("foveated", "progressive foveation, fovea disc", run_fovea())
    del f_rec  # reported via records; the speedup line compares rows 1-2

    out = [rec for _, rec in records]
    if u_rec["reached"] and p_rec["reached"] and p_rec["value"] > 0:
        speed = u_rec["value"] / p_rec["value"]
        out.append({
            "metric": "equal-quality speedup: sobol+adaptive+denoise "
                      f"vs uniform PT (RMSE<=0.03 @{w}x{h})",
            "value": round(speed, 2),
            "unit": "x",
            "vs_baseline": round(speed / 3.0, 3),  # VERDICT r3 target: >=3x
        })
    return out


def fovea4k_track(cs, probe, max_frames=16):
    """The reference's PUBLISHED configuration as a quality-normalized row
    (VERDICT r4 item 2): 3840x2160, 3-zone foveation with the sv4 radii
    157/515 and zone spp 1/2/8 (sv4 SimplePathtracer.cpp:20-21,135-215,
    main.cpp:256; its deliverable is 41 fps at this config,
    final_fps.dat) — here run progressively under a static central gaze
    with the full quality stack composed: Owen-scrambled Sobol sampling +
    Russian-roulette path termination + a color-guided A-Trous denoise of
    the fovea crop (checked both raw and denoised; cost counted).

    Reports seconds to fovea-disc sqrt-RMSE <= 0.03 against the committed
    2048-spp disc reference (tools/make_reference_4k.py), plus the
    full-frame companion (VERDICT r4 weak #7): the whole foveated frame's
    RMSE at quarter resolution — exactly the information content of the
    factor-4 periphery splat — against the committed 4096-effective-spp
    quarter-res reference."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from optixpathtracer.core.camera import Camera
    from optixpathtracer.engine.foveated import (
        FoveatedRenderer,
        FoveationConfig,
    )
    from optixpathtracer.engine.wavefront import RenderConfig
    from optixpathtracer.ops.denoise import atrous_denoise
    from optixpathtracer.utils.platform import auto_tune

    sdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes")
    fov_ref = os.path.join(sdir, "ref_city_4k_fovea.npz")
    q_ref = os.path.join(sdir, "ref_city_4k_q.npz")
    missing = [p for p in (fov_ref, q_ref) if not os.path.exists(p)]
    if missing:
        msg = (f"missing committed 4K reference artifact(s) {missing} "
               "(regenerate with tools/make_reference_4k.py)")
        print(f"BENCH ERROR: {msg}", file=sys.stderr, flush=True)
        return [{"metric": "seconds to fovea-disc RMSE<=0.03 @3840x2160",
                 "value": 0.0, "unit": "s", "vs_baseline": 0.0,
                 "error": msg}]

    fd = np.load(fov_ref)
    qd = np.load(q_ref)
    w, h = int(fd["width"]), int(fd["height"])
    cx, cy = (int(v) for v in fd["gaze"])  # buffer coords, bottom-first y
    disc_r = int(fd["disc_r"])
    idx = fd["idx"].astype(np.int64)
    ref_disc = jnp.asarray(np.sqrt(np.clip(
        fd["image"].astype(np.float32), 0, None)))
    ref_q = jnp.asarray(np.sqrt(np.clip(
        qd["image"].astype(np.float32), 0, None)))
    target = 0.03

    cam = Camera(eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0), up=(0, 1, 0),
                 fov_y=45, aspect_ratio=w / h)
    cfg = auto_tune(RenderConfig(
        width=w, height=h, samples_per_launch=1, max_depth=4,
        nee_final_bounce=False, batch_spp=True, sampling="sobol",
        russian_roulette=True,
    ))
    fov = FoveationConfig(inner_radius=157, outer_radius=515,
                          progressive=True)
    fr = FoveatedRenderer(cs, probe, cfg, cam, fov)
    # set_gaze takes IMAGE coords (top-first y); the reference disc center
    # is in buffer coords — invert the flip so splat center == disc center
    fr.set_gaze(cx, h - 1 - cy)

    idxj = jnp.asarray(idx)
    # fovea crop (384x384 around the gaze) for the denoise pass; the disc
    # (r=157) sits fully inside
    half = 192
    r0, c0 = cy - half, cx - half
    disc_rows = jnp.asarray(idx // w - r0)
    disc_cols = jnp.asarray(idx % w - c0)

    # One-time first-hit AOV guides for the crop (gaze and camera are
    # static, so normal/albedo/depth never change): a single primary-
    # visibility pass through the platform's traversal + the engine's own
    # hit-geometry stage — the same guides the reference's OptiX denoiser
    # takes as inputs (denoiser albedo/normal layers).
    from optixpathtracer.core.math import Vec3 as _V3
    from optixpathtracer.engine.wavefront import _hit_geometry
    from optixpathtracer.ops.dispatch import trace_closest

    ys_g, xs_g = np.mgrid[r0:r0 + 2 * half, c0:c0 + 2 * half]
    uu, vv, ww = cam.uvw_frame()
    dxs = 2.0 * (xs_g.ravel() + 0.5) / w - 1.0
    dys = 2.0 * (ys_g.ravel() + 0.5) / h - 1.0
    dirs = dxs[:, None] * uu[None] + dys[:, None] * vv[None] + ww[None]
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(
        np.float32)
    eye = np.broadcast_to(np.asarray(cam.eye, np.float32), dirs.shape)

    @jax.jit
    def _crop_guides(csj, ov, dv):
        o3 = _V3(ov[:, 0], ov[:, 1], ov[:, 2])
        d3 = _V3(dv[:, 0], dv[:, 1], dv[:, 2])
        rec = trace_closest(csj, o3, d3, 1e-3, 1e16)
        nrm, _, alb, _ = _hit_geometry(csj, rec, d3, False)
        hit = rec.t < 1e15
        sh = (2 * half, 2 * half)
        pack3 = lambda v: jnp.stack(
            [jnp.where(hit, v.x, 0.0), jnp.where(hit, v.y, 0.0),
             jnp.where(hit, v.z, 0.0)], -1).reshape(sh + (3,))
        zg = jnp.where(hit, rec.t, 0.0).reshape(sh)
        return pack3(nrm), pack3(alb), zg

    g_nrm, g_alb, g_z = _crop_guides(
        cs, jnp.asarray(eye), jnp.asarray(dirs))

    @jax.jit
    def rmses(accum):
        img = jnp.stack([accum.x, accum.y, accum.z], -1)  # (W*H, 3)
        disc = jnp.sqrt(jnp.clip(img[idxj], 0, None))
        raw = jnp.sqrt(jnp.mean((disc - ref_disc) ** 2))
        crop = img.reshape(h, w, 3)[r0:r0 + 2 * half, c0:c0 + 2 * half]
        # the quality pipeline's measured-best config:
        # demodulated, albedo/normal/depth-guided A-Trous
        dn = atrous_denoise(
            crop, g_nrm, g_alb, sigma_color=4.0, sigma_albedo=1.0,
            depth=g_z, demodulate=True)
        dn_disc = jnp.sqrt(jnp.clip(dn[disc_rows, disc_cols], 0, None))
        den = jnp.sqrt(jnp.mean((dn_disc - ref_disc) ** 2))
        return raw, den

    @jax.jit
    def companion(accum):
        img = jnp.stack([accum.x, accum.y, accum.z], -1).reshape(h, w, 3)
        q = img.reshape(540, 4, 960, 4, 3).mean(axis=(1, 3))
        return jnp.sqrt(jnp.mean(
            (jnp.sqrt(jnp.clip(q, 0, None)) - ref_q) ** 2))

    # compile pass (renders a frame + both rmse programs), then time fresh
    fr.render()
    float(rmses(fr.accum)[0])
    float(companion(fr.accum))
    from optixpathtracer.core.math import Vec3
    fr.accum = Vec3.zeros((w * h,))
    fr.subframe_index = 0

    t = 0.0
    secs = spp = None
    raw = den = float("inf")
    used = "raw"
    for i in range(max_frames):
        t0 = time.perf_counter()
        fr.render()
        raw_j, den_j = rmses(fr.accum)
        raw, den = float(raw_j), float(den_j)  # device sync
        t += time.perf_counter() - t0
        if min(raw, den) <= target:
            secs = t
            spp = (i + 1) * fov.fovea_spp
            used = "denoised" if den < raw else "raw"
            break
    comp = float(companion(fr.accum))
    return [{
        "metric": "seconds to fovea-disc RMSE<=0.03 @3840x2160 "
                  "(3-zone foveation r157/515, sobol+RR+denoised-fovea)",
        "value": round(secs, 2) if secs is not None else 0.0,
        "unit": "s",
        # VERDICT r4 item 2 target: <=2 s to quality; >=1.0 means met
        "vs_baseline": round(2.0 / secs, 3) if secs else 0.0,
        "reached": secs is not None,
        "final_rmse_raw": round(raw, 5),
        "final_rmse_denoised": round(den, 5),
        "gate_variant": used,
        "fovea_spp": spp,
        "ref_spp": int(fd["spp"]),
        "companion_fullframe_rmse_q": round(comp, 5),
        "companion_ref_effective_spp": int(qd["effective_spp"]),
        "reference_fps_at_this_config": 41.0,  # final_fps.dat col 2
    }]


def interactive_line(cs, probe, frames=16, record_path=None):
    """A live interactive foveated session at 640x480 (VERDICT r4 item 3):
    the viewer render loop driven headlessly by a scripted circular gaze
    path (the reference's gaze is the live mouse cursor, sv4
    main.cpp:310-314) with the composed pipeline — fused 3-zone foveation
    (sv4 radii scaled to 480p), Owen-scrambled Sobol sampling, Russian
    roulette, fovea spp 4 + a per-frame color-guided A-Trous denoise of the
    fovea crop as the display step (denoised zones need fewer spp than
    sv4's 8).

    Per-frame rows use the reference's own TSV columns (sv3
    main.cpp:348-383 data_save.dat: i, stateUpdate, render, display,
    cursorX, cursorY) + rays; record_path writes them
    (tools/interactive_session.py commits the artifact). Display is the
    on-device tonemap + fovea denoise sync — the reference's display is
    likewise a zero-copy GL blit, and the MJPEG viewer streams at its own
    cadence (a host transfer per frame would measure the transfer, not
    the renderer)."""
    import math

    import jax
    import jax.numpy as jnp

    from optixpathtracer.core.camera import Camera
    from optixpathtracer.engine.foveated import (
        FoveatedRenderer,
        FoveationConfig,
    )
    from optixpathtracer.engine.wavefront import RenderConfig
    from optixpathtracer.ops import tonemap
    from optixpathtracer.ops.denoise import atrous_denoise
    from optixpathtracer.utils.platform import auto_tune

    w, h = 640, 480
    cam = Camera(eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0), up=(0, 1, 0),
                 fov_y=45, aspect_ratio=w / h)
    cfg = auto_tune(RenderConfig(
        width=w, height=h, samples_per_launch=1, max_depth=4,
        nee_final_bounce=False, sampling="sobol", russian_roulette=True,
    ))
    inner = max(8, 157 * h // 2160)
    fov = FoveationConfig(
        inner_radius=inner,
        outer_radius=max(24, 515 * h // 2160),
        fovea_spp=4,  # denoised display needs fewer samples than sv4's 8
    )
    fr = FoveatedRenderer(cs, probe, cfg, cam, fov, fused=True)
    half = min(inner + 7, 64)

    @jax.jit
    def display(accum, gaze):
        # tonemapped frame + denoised fovea crop, all on device
        disp = tonemap.finalize(accum, mode=tonemap.TONEMAP_REINHARD,
                                exposure_stops=2.0)
        img = jnp.stack([disp.x, disp.y, disp.z], -1).reshape(h, w, 3)
        crop = jax.lax.dynamic_slice(
            img, (gaze[1] - half, gaze[0] - half, 0),
            (2 * half, 2 * half, 3))
        dn = atrous_denoise(crop, jnp.zeros_like(crop), jnp.ones_like(crop),
                            iterations=3, sigma_color=1.0)
        img = jax.lax.dynamic_update_slice(
            img, dn, (gaze[1] - half, gaze[0] - half, 0))
        return tonemap.pack_rgba8(
            type(accum)(img[:, :, 0].ravel(), img[:, :, 1].ravel(),
                        img[:, :, 2].ravel()))

    rows = []
    fps_list = []
    margin = half + 2
    fr.render()  # compile
    _ = np.asarray(jax.block_until_ready(display(
        fr.accum, jnp.array([w // 2, h // 2], jnp.int32))))[:4]
    for i in range(frames):
        t0 = time.perf_counter()
        ang = 2 * math.pi * i / max(frames, 1)
        gx = int(w / 2 + 0.22 * w * math.cos(ang))
        gy = int(h / 2 + 0.22 * h * math.sin(ang))
        gx = min(max(gx, margin), w - 1 - margin)
        gy = min(max(gy, margin), h - 1 - margin)
        fr.set_gaze(gx, gy)
        t1 = time.perf_counter()
        fr.render()
        t2 = time.perf_counter()
        gz = jnp.array([gx, h - 1 - gy], jnp.int32)  # buffer coords
        jax.block_until_ready(display(fr.accum, gz))
        t3 = time.perf_counter()
        rows.append((i, t1 - t0, t2 - t1, t3 - t2, gx, gy, fr.last_rays))
        fps_list.append(1.0 / (t3 - t1))
    if record_path:
        os.makedirs(os.path.dirname(record_path), exist_ok=True)
        with open(record_path, "w") as f:
            f.write("i\tstateUpdate\trender\tdisplay\tcursorX\tcursorY\trays\n")
            for r_ in rows:
                f.write("\t".join(str(x) for x in r_) + "\n")
    steady = fps_list[1:] if len(fps_list) > 1 else fps_list
    fps = float(np.mean(steady))
    return {
        "metric": "interactive foveated fps @640x480 (fused 3-zone, "
                  "scripted gaze orbit, sobol+RR+denoised fovea display)",
        "value": round(fps, 3),
        "unit": "fps",
        "vs_baseline": round(fps / 2.0, 3),  # VERDICT r4 item 3: >=2 fps
        "frames": frames,
        "render_ms_mean": round(1e3 * float(np.mean(
            [r_[2] for r_ in rows[1:]])), 1),
        "display_ms_mean": round(1e3 * float(np.mean(
            [r_[3] for r_ in rows[1:]])), 1),
    }


def demand_textures_line():
    """One driver-verifiable line composing demand-loaded sparse textures
    with the platform's traversal at bench scale (VERDICT r3 item 10):
    the loft interior with its walls re-skinned by 8192x8192 PROCEDURAL
    sources (checkerboard + Mandelbrot — the reference ImageSource set)
    streamed through the demand pool with a 6-level mip pyramid and
    footprint LOD. Reports steady-state fps + pager counters; quality gate:
    the steady state must shade zero non-resident pages (no fallback
    colors in the accumulated estimator)."""
    import jax
    import jax.numpy as jnp

    from optixpathtracer.builder import compile_scene
    from optixpathtracer.core.camera import Camera
    from optixpathtracer.engine.renderer import Renderer
    from optixpathtracer.engine.wavefront import RenderConfig
    from optixpathtracer.io.demand import (
        CheckerBoardSource,
        DemandTextureManager,
        MandelbrotSource,
    )
    from optixpathtracer.io.obj import load_obj
    from optixpathtracer.lights.probe import build_probe

    hs = load_obj(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "scenes", "loft.obj"))
    sources = [
        CheckerBoardSource(8192, 8192, squares_per_side=128,
                           color_a=(0.8, 0.7, 0.55), color_b=(0.45, 0.3, 0.2)),
        MandelbrotSource(8192, 8192),
        CheckerBoardSource(8192, 8192, squares_per_side=32,
                           color_a=(0.75, 0.75, 0.78), color_b=(0.5, 0.52, 0.6)),
    ]
    while len(sources) < len(hs.textures):
        sources.append(CheckerBoardSource(8192, 8192))
    mgr = DemandTextureManager(sources[: len(hs.textures)], capacity=1024,
                               levels=6)
    cs = compile_scene(hs, leaf_size=8, wide_width=8, build_wide_bvh=False)
    probe = build_probe(np.full((8, 16, 3), 1e-6, np.float32))
    w, h = 480, 320
    cfg = auto_tune(RenderConfig(
        width=w, height=h, samples_per_launch=2, max_depth=3,
        nee_final_bounce=False, batch_spp=True,
        emission_all_bounces=True, use_shading_normals=True,
    ))
    cam = Camera(eye=(-5.2, 2.4, 3.2), lookat=(2.0, 1.2, -1.0), up=(0, 1, 0),
                 fov_y=55, aspect_ratio=w / h)
    r = Renderer(cs, probe, cfg, cam, demand=mgr)
    # first launch: compile + settle (page in the frame's working set)
    r.render(download=False)
    loaded_at_settle = mgr.pages_loaded
    # steady state: same camera, pages resident — timed frames
    frames = 3
    t0 = time.perf_counter()
    for _ in range(frames):
        r.render(download=False)
    float(r._last.rays_traced)  # hard sync
    dt = time.perf_counter() - t0
    usage = np.asarray(r._last.tex_usage)
    non_resident_shaded = int((usage & (mgr._page_table < 0)).sum())
    fps = frames / dt
    return {
        "metric": "demand-textured loft fps (3x 8k procedural sources, "
                  f"6-level mips, {w}x{h} spp2 depth3)",
        "value": 0.0 if non_resident_shaded else round(fps, 3),
        "unit": "fps",
        "vs_baseline": 0.0,
        "pages_resident": int((mgr._page_table >= 0).sum()),
        "pages_loaded": mgr.pages_loaded,
        "pages_evicted": mgr.pages_evicted,
        "pages_total_addressable": int(mgr.num_pages),
        "pool_capacity": mgr.capacity,
        "settle_pages": loaded_at_settle,
        "non_resident_shaded_steady": non_resident_shaded,
        "rays_per_s": round(float(r._last.rays_traced) * frames / dt / 1e6, 3),
    }


def per_config_lines(cs, probe, cam):
    """One driver-verifiable perf line per remaining BASELINE.json config
    (VERDICT r4 weak #6): hello_raytracing, whitted, spectral. disney_pt is
    the headline; foveated has the quality-track row + fps harness. Each row
    is gated on a finite, non-degenerate frame (the radiometry itself is
    pinned by the per-preset goldens in tests/test_goldens.py)."""
    import jax

    from optixpathtracer import models

    rows = []

    def timed(render, frames=3):
        img = render()  # compile + warm
        t0 = time.perf_counter()
        for _ in range(frames):
            img = render()
        dt = time.perf_counter() - t0
        a = np.asarray(img)
        ok = bool(np.isfinite(a[np.isfinite(a)].astype(np.float64)).all()
                  and a.std() > 0)
        return frames / dt, ok

    def row(metric, make, frames=3, extra=None):
        fps, ok = timed(make(), frames=frames)
        r = {"metric": metric, "value": round(fps, 3) if ok else 0.0,
             "unit": "fps", "vs_baseline": 0.0}
        if extra:
            r.update(extra(fps) if ok else {})
        rows.append(r)

    # -- config 1: hello_raytracing (primary visibility + one shadow ray) --
    row("hello_raytracing fps (primary+shadow, 150k-tri city, 1200x800)",
        lambda: models.make_hello_renderer(cs, cam, width=1200,
                                           height=800).render,
        extra=lambda fps: {
            "mrays_per_s_min": round(fps * 1200 * 800 * 2 / 1e6, 2)})

    # -- config 2: whitted spheres (recursive reflect/refract, pt lights) --
    row("whitted fps (glass/metal spheres + floor, depth 3, 768x576)",
        lambda: models.make_whitted_renderer(width=768, height=576,
                                             max_depth=3).render)

    # -- config 4: spectral (hero-wavelength 4-lambda Disney PT) ----------
    row("spectral fps (hero-wavelength 4-lambda, 150k-tri city, "
        "1200x800 spp2 depth4)",
        lambda: models.make_spectral_renderer(cs, probe, cam, width=1200,
                                              height=800, spp=2,
                                              max_depth=4).render,
        frames=2)
    return rows


def _unit_box():
    v = np.array(
        [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
         [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
        np.float32,
    )
    f = np.array(
        [[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
         [3, 2, 6], [3, 6, 7], [0, 3, 7], [0, 7, 4], [1, 5, 6], [1, 6, 2]],
        np.int32,
    )
    return v, f


def main():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from optixpathtracer.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from optixpathtracer.builder import compile_scene
    from optixpathtracer.core.camera import Camera
    from optixpathtracer.engine.renderer import Renderer
    from optixpathtracer.engine.wavefront import RenderConfig
    from optixpathtracer.lights.probe import build_probe
    from optixpathtracer.utils.platform import auto_tune

    small = "--small" in sys.argv
    # --scene loft: the bundled CLOSED textured interior (round-1 verdict:
    # the open-sky city flatters traversal and under-tests emissives /
    # textures at bench scale). --scene hostile: terrain + 30-degree-rotated
    # city — nothing axis-aligned, sliver triangles (VERDICT r3 item 5's
    # sponza/san_miguel stand-in). Secondary numbers; the city stays headline.
    # --scene big: the triangle-count scaling axis (VERDICT r4 item 1) —
    # >=1.3M unique triangles (city + tessellated terrain + suburb rings).
    # The reference's analog is san_miguel (~10M tris, final_fps.dat col 6).
    scene_name = "city"
    if "--scene" in sys.argv:
        i = sys.argv.index("--scene")
        if i + 1 >= len(sys.argv) or sys.argv[i + 1] not in (
                "city", "loft", "hostile", "big"):
            print("usage: bench.py [--small] "
                  "[--scene city|loft|hostile|big]", file=sys.stderr)
            sys.exit(2)
        scene_name = sys.argv[i + 1]
    loft = scene_name == "loft"
    width, height = (320, 240) if small else (1200, 800)
    spp = 1 if small else 2
    n_boxes = 400 if small else 12500

    if loft:
        from optixpathtracer.io.obj import load_obj

        hs = load_obj(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "scenes", "loft.obj"))
        scene_label = "loft interior"
    elif scene_name == "hostile":
        hs = build_hostile_scene(n_boxes=980 if small else 9800)
        scene_label = "150k-tri hostile terrain+rotated city"
    elif scene_name == "big":
        hs = build_big_scene(n_boxes=1250 if small else 12500,
                             terrain_grid=(256, 128) if small else (1024, 512))
        scene_label = "1.35M-tri city+terrain"
    else:
        hs = build_city_scene(n_boxes=n_boxes)
        scene_label = "150k-tri city"
    # warm the backend + jax dispatch path OUTSIDE the build timer: the
    # first device_put pays the client bring-up and first-call dispatch
    # warm-up, which is not scene-build work
    jax.devices()
    compile_scene(build_city_scene(n_boxes=4), leaf_size=8, wide_width=8,
                  build_wide_bvh=False)
    t0 = time.perf_counter()
    cs = compile_scene(hs, leaf_size=8, wide_width=8, build_wide_bvh=False)
    build_s = time.perf_counter() - t0

    if loft:
        # closed room: lit by its emissive panels, not the sky
        probe = build_probe(np.full((8, 16, 3), 1e-6, np.float32))
    else:
        # sky probe with a sun
        sky = np.full((64, 128, 3), 0.4, np.float32)
        sky[8:12, 30:34] = (60.0, 55.0, 45.0)
        probe = build_probe(sky)

    cfg = auto_tune(RenderConfig(
        width=width, height=height, samples_per_launch=spp, max_depth=4,
        # skip the final bounce's NEE statically — the reference traces those
        # shadow rays then DISCARDS their contribution (deviceProgram.cu:
        # 429-437)
        nee_final_bounce=False,
        # one expanded pixels-x-samples wavefront per launch
        batch_spp=not small,
        emission_all_bounces=loft,
        use_shading_normals=loft,
    ))
    if loft:
        cam = Camera(
            eye=(-5.2, 2.4, 3.2), lookat=(2.0, 1.2, -1.0), up=(0, 1, 0),
            fov_y=55, aspect_ratio=width / height,
        )
    else:
        cam = Camera(**CITY_CAMERA, aspect_ratio=width / height)

    # ---- quality gate 1: traversal exactness at bench scale -------------
    # the headline number is only admissible if the traversal agrees with
    # the brute-force oracle on this very scene (round-1 lesson: a Mrays/s
    # figure from a truncating traversal is not a legitimate perf point).
    # 8k mixed rays: camera rays + scene-interior bounce-like rays. A ray
    # may report another triangle only at the same t (a tie: shared edges,
    # coplanar faces).
    from optixpathtracer.core.math import Vec3
    from optixpathtracer.ops.dispatch import trace_closest
    from optixpathtracer.ops.traverse import brute_force_closest_hit

    og, dg = gate_rays(hs, cam)
    ov = Vec3(*(jnp.asarray(og[:, i]) for i in range(3)))
    dv = Vec3(*(jnp.asarray(dg[:, i]) for i in range(3)))
    fast = trace_closest(cs, ov, dv, 1e-3, 1e16, traversal=cfg.traversal)
    exact = brute_force_closest_hit(cs.scene, ov, dv, 1e-3, 1e16,
                                    num_valid=cs.num_triangles, ray_chunk=1024)
    f_tri, e_tri = np.asarray(fast.tri), np.asarray(exact.tri)
    e_t = np.asarray(exact.t)
    tie = np.abs(np.asarray(fast.t) - e_t) <= 1e-6 * np.abs(e_t)
    gate_mismatch = int(((f_tri != e_tri) & ~((f_tri >= 0) & (e_tri >= 0) & tie)).sum())

    r = Renderer(cs, probe, cfg, cam)

    # warmup / compile
    t0 = time.perf_counter()
    r.render()
    compile_s = time.perf_counter() - t0

    # multi-device: the day the environment offers a slice, the record
    # captures it with zero changes — strip-DP over every device whose
    # count divides the pixel grid, plus a single-device reference frame
    # for the scaling-efficiency denominator (ref scaffold:
    # sutil/WorkDistribution.h:34-87)
    n_dev_avail = len(jax.devices())
    multi = n_dev_avail > 1
    frames = 2 if small else 4
    rays = 0.0
    overflow = 0.0
    scaling = None
    if multi:
        from optixpathtracer.parallel.tiles import (
            DistributedRenderer,
            make_mesh,
        )

        devs = list(jax.devices())
        while (width * height) % len(devs):
            devs = devs[:-1]
        dr = DistributedRenderer(cs, probe, cfg, cam, mesh=make_mesh(devs))
        dr.render()  # compile + warm
        # single-device reference frame (r is already warm)
        t0 = time.perf_counter()
        r.render()
        single_dt = time.perf_counter() - t0
        single_mrays = float(r._last.rays_traced) / single_dt / 1e6
        overflow += float(r._last.bfs_overflow)
        t0 = time.perf_counter()
        for _ in range(frames):
            dr.render()
            rays += dr.last_rays
        dt = time.perf_counter() - t0
        mrays = rays / dt / 1e6
        scaling = {
            "n_devices": len(devs),
            "single_device_mrays": round(single_mrays, 3),
            "scaling_efficiency": round(
                mrays / (len(devs) * single_mrays), 4
            ) if single_mrays > 0 else 0.0,
        }
    else:
        # timed progressive frames
        t0 = time.perf_counter()
        for _ in range(frames):
            r.render()
            rays += float(r._last.rays_traced)
            overflow += float(r._last.bfs_overflow)
        dt = time.perf_counter() - t0
        mrays = rays / dt / 1e6
    fps = frames / dt

    # ---- quality gates: refuse a headline number from wrong images ------
    gated_out = (overflow != 0.0) or (gate_mismatch != 0)
    result = {
        "metric": f"Mrays/s incoherent (Disney PT, depth 4, {scene_label}, 1200x800)",
        "value": 0.0 if gated_out else round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": 0.0 if gated_out else round(mrays / 100.0, 4),
    }
    print(json.dumps(result), flush=True)

    # ---- quality-normalized track (time-to-RMSE; VERDICT r3 item 1) -----
    # city headline runs only: the committed reference artifact is for the
    # city scene
    if scene_name == "city" and not small:
        for rec in quality_track(cs, probe):
            print(json.dumps(rec), flush=True)
        # full-headline-resolution track (VERDICT r3 item 1 asked for
        # 1200x800) against the COMMITTED 2048-spp reference artifact
        # (tools/make_reference.py --width 1200 --height 800 --spp 2048);
        # a missing artifact prints a loud error row via quality_track
        # rather than silently skipping (ADVICE r4 medium). --no-fullres
        # skips it explicitly
        fullres_ref = os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "scenes", "ref_city_1200x800.npz")
        if "--no-fullres" not in sys.argv:
            for rec in quality_track(cs, probe, ref_path=fullres_ref):
                print(json.dumps(rec), flush=True)
        print(json.dumps(demand_textures_line()), flush=True)
        # one perf line per remaining BASELINE.json config (VERDICT r4 #8)
        for rec in per_config_lines(cs, probe, cam):
            print(json.dumps(rec), flush=True)
        # live interactive foveated session, scripted gaze (VERDICT r4 #3)
        print(json.dumps(interactive_line(cs, probe)), flush=True)
        # the reference's published 4K foveated config, quality-normalized
        # (VERDICT r4 item 2); --no-4k skips it explicitly
        if "--no-4k" not in sys.argv:
            for rec in fovea4k_track(cs, probe):
                print(json.dumps(rec), flush=True)
    print(
        json.dumps(
            {
                "detail": {
                    "fps": round(fps, 4),
                    "spp_per_launch": spp,
                    "rays_total": rays,
                    "traversal": cfg.traversal,
                    "overflow": overflow,
                    "gate_mismatch_rays": gate_mismatch,
                    "quality_gated_out": gated_out,
                    "bvh_build_s": round(build_s, 2),
                    "first_frame_incl_compile_s": round(compile_s, 2),
                    "triangles": cs.num_triangles,
                    "devices": [str(d) for d in jax.devices()][:4],
                    "scaling": scaling,
                }
            }
        ),
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
