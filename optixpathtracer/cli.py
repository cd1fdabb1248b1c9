"""Command-line interface: `python -m optixpathtracer render ...`.

The user-facing replacement for the reference's hard-coded main() functions —
scene/probe paths, model variant, spp/depth, output, checkpoints and metrics
are all flags (the reference compiled these in; SURVEY.md §5).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .utils.config import RunConfig, add_config_args, config_from_args


def _load_scene(cfg: RunConfig):
    from .core.materials import make_material
    from .core.scene import HostScene

    lights = None
    if cfg.scene.lower().endswith((".gltf", ".glb")):
        from .io.gltf import load_gltf

        hs, lights = load_gltf(cfg.scene)
    elif cfg.scene:
        from .io.obj import load_obj

        hs = load_obj(cfg.scene)
    else:
        # procedural default: boxes on a floor (addBox demo scene,
        # HelloPathtracing_original/main.cpp:165-169)
        hs = HostScene()
        hs.add_box(make_material(color=(0.75, 0.75, 0.75)), pos=(0, -0.1, 0), extent=(8, 0.1, 8))
        hs.add_box(make_material(color=(0.8, 0.3, 0.2), roughness=0.5), pos=(-0.9, 0.5, 0), extent=(0.5, 0.5, 0.5))
        hs.add_box(make_material(color=(0.9, 0.8, 0.3), metallic=1.0, roughness=0.15), pos=(0.8, 0.65, 0.4), extent=(0.45, 0.65, 0.45))
    return hs, lights


def _traversal(cfg: RunConfig) -> dict:
    """Preset override for an explicit --traversal; empty means the
    platform's default (models route it through utils.platform.auto_tune)."""
    return {} if cfg.traversal is None else {"traversal": cfg.traversal}


def _load_probe(cfg: RunConfig):
    from .lights.probe import build_probe

    if cfg.probe:
        from .io.image import load_hdr

        return build_probe(load_hdr(cfg.probe))
    return build_probe(np.full((32, 64, 3), cfg.probe_level, np.float32))


def cmd_render(args: argparse.Namespace) -> int:
    import time

    from .builder import compile_scene
    from .core.camera import Camera
    from .io.image import save_png
    from .utils.logging import FrameLog, Timer
    from . import models

    cfg = config_from_args(args)
    camera = Camera(
        eye=cfg.camera.eye, lookat=cfg.camera.lookat, up=cfg.camera.up,
        fov_y=cfg.camera.fov_y, aspect_ratio=cfg.width / cfg.height,
    )

    log = FrameLog(cfg.metrics or None)
    timer = Timer()

    hs, _lights = _load_scene(cfg)
    cs = compile_scene(hs, leaf_size=8)
    probe = _load_probe(cfg)
    state_update = timer.lap()
    print(f"scene: {cs.num_triangles} triangles (compiled in {state_update:.1f}s)")

    if cfg.demand_textures > 0 and cfg.model != "disney_pt":
        print(f"warning: --demand-textures applies to the disney_pt model "
              f"only; ignored for --model {cfg.model}", file=sys.stderr)
    elif cfg.demand_textures > 0 and not hs.textures:
        print("warning: scene has no textures; --demand-textures ignored",
              file=sys.stderr)

    if cfg.model == "hello_raytracing":
        r = models.make_hello_renderer(cs, camera, cfg.width, cfg.height)
        img = r.render()
        save_png(cfg.out, img)
        log.log_frame(state_update_s=state_update, render_s=timer.lap())
        print(f"wrote {cfg.out}")
        return 0

    if cfg.model == "whitted":
        r = models.make_whitted_renderer(cfg.width, cfg.height, cfg.max_depth)
        for _ in range(cfg.frames):
            img = r.render()
            log.log_frame(render_s=timer.lap())
        save_png(cfg.out, img)
        print(f"wrote {cfg.out}")
        return 0

    if cfg.model == "spectral":
        r = models.make_spectral_renderer(
            cs, probe, camera, cfg.width, cfg.height, cfg.spp, cfg.max_depth,
            **_traversal(cfg),
            emission_all_bounces=cfg.emission_all_bounces,
            sampling=cfg.sampling, sampling_strata=cfg.sampling_strata,
        )
        for _ in range(cfg.frames):
            img = r.render()
            log.log_frame(render_s=timer.lap())
        from .ops import tonemap as tm
        from .core.math import Vec3
        import jax.numpy as jnp

        v = Vec3(jnp.asarray(img[..., 0]), jnp.asarray(img[..., 1]), jnp.asarray(img[..., 2]))
        disp = tm.finalize(v, mode=cfg.tonemap, exposure_stops=cfg.exposure)
        save_png(cfg.out, np.stack([np.asarray(disp.x), np.asarray(disp.y), np.asarray(disp.z)], -1))
        print(f"wrote {cfg.out}")
        return 0

    if cfg.model == "foveated":
        r = models.make_foveated_renderer(
            cs, probe, camera, cfg.width, cfg.height, cfg.max_depth,
            foveation=cfg.foveation,
            fused=cfg.fused_foveation, **_traversal(cfg),
            emission_all_bounces=cfg.emission_all_bounces,
            nee_final_bounce=cfg.nee_final_bounce, nee_rr=cfg.nee_rr,
            russian_roulette=cfg.russian_roulette,
            rr_start_depth=cfg.rr_start_depth,
            sampling=cfg.sampling, sampling_strata=cfg.sampling_strata,
        )
        gx, gy = cfg.gaze
        if gx >= 0:
            r.set_gaze(gx, gy)
        for _ in range(cfg.frames):
            frame = r.render()
            log.log_frame(render_s=timer.lap(), cursor=r.gaze, rays=r.last_rays)
        save_png(cfg.out, frame)
        print(f"wrote {cfg.out} ({r.stats()})")
        return 0

    if cfg.adaptive:
        if cfg.model != "disney_pt":
            print("warning: --adaptive applies to the disney_pt model only",
                  file=sys.stderr)
        r = models.make_adaptive_renderer(
            cs, probe, camera, cfg.width, cfg.height, cfg.spp, cfg.max_depth,
            refine_fraction=cfg.adaptive_fraction, **_traversal(cfg),
            emission_all_bounces=cfg.emission_all_bounces,
            nee_final_bounce=cfg.nee_final_bounce, nee_rr=cfg.nee_rr,
            russian_roulette=cfg.russian_roulette,
            rr_start_depth=cfg.rr_start_depth,
            sampling=cfg.sampling, sampling_strata=cfg.sampling_strata,
        )
        for _ in range(cfg.frames):
            r.render()
            st = r.stats()
            log.log_frame(render_s=timer.lap(), rays=st["rays_traced"],
                          spp=st["spp_max"])
        st = r.stats()
        print(f"adaptive: {st['rounds']} rounds, {st['total_samples']} "
              f"samples (per-pixel spp {st['spp_min']}..{st['spp_max']}), "
              f"{st['rays_traced']:.0f} rays")
        from .ops import tonemap as tm
        from .core.math import Vec3
        import jax.numpy as jnp

        img = r.accum_image()
        v = Vec3(jnp.asarray(img[..., 0]), jnp.asarray(img[..., 1]),
                 jnp.asarray(img[..., 2]))
        disp = tm.finalize(v, mode=cfg.tonemap, exposure_stops=cfg.exposure)
        save_png(cfg.out, np.stack(
            [np.asarray(disp.x), np.asarray(disp.y), np.asarray(disp.z)], -1))
        print(f"wrote {cfg.out}")
        log.close()
        return 0

    # disney_pt (default)
    demand = None
    if cfg.demand_textures > 0 and hs.textures:
        from .io.demand import DemandTextureManager

        # levels=4: the engine derives a per-hit mip LOD from the path-length
        # footprint and each triangle's texel density, and samples trilinear
        # (minified textures read coarse pages — fewer resident pages and
        # anti-aliased minification)
        demand = DemandTextureManager.from_host_scene(
            hs, capacity=cfg.demand_textures, levels=4
        )
        print(f"demand textures: {demand.num_pages} pages, "
              f"pool capacity {cfg.demand_textures}")
    r = models.make_disney_pt_renderer(
        cs, probe, camera, cfg.width, cfg.height, cfg.spp, cfg.max_depth,
        **_traversal(cfg),
        emission_all_bounces=cfg.emission_all_bounces,
        nee_final_bounce=cfg.nee_final_bounce, nee_rr=cfg.nee_rr,
        russian_roulette=cfg.russian_roulette,
        rr_start_depth=cfg.rr_start_depth,
        sampling=cfg.sampling, sampling_strata=cfg.sampling_strata,
        demand=demand,
    )
    if cfg.checkpoint:
        import os

        if os.path.exists(cfg.checkpoint if cfg.checkpoint.endswith(".npz") else cfg.checkpoint + ".npz"):
            r.load_checkpoint(cfg.checkpoint)
            print(f"resumed at subframe {r.subframe_index}")
    for _ in range(cfg.frames):
        frame = r.render()
        st = r.stats()
        log.log_frame(render_s=st["last_frame_s"], spp=st["total_spp"],
                      rays=float(r._last.rays_traced))
        print(f"\r{log.display_stats()} | {st['total_spp']} spp", end="", flush=True)
    print()
    if cfg.checkpoint:
        r.save_checkpoint(cfg.checkpoint)
        print(f"checkpoint saved to {cfg.checkpoint}")

    if cfg.denoise:
        from .ops.denoise import atrous_denoise

        aov = r.aovs()
        den = np.asarray(
            atrous_denoise(r.accum_image().astype(np.float32), aov["normal"].astype(np.float32), aov["albedo"].astype(np.float32))
        )
        from .ops import tonemap as tm
        from .core.math import Vec3
        import jax.numpy as jnp

        v = Vec3(jnp.asarray(den[..., 0]), jnp.asarray(den[..., 1]), jnp.asarray(den[..., 2]))
        disp = tm.finalize(v, mode=cfg.tonemap, exposure_stops=cfg.exposure)
        save_png(cfg.out, np.stack([np.asarray(disp.x), np.asarray(disp.y), np.asarray(disp.z)], -1))
    else:
        save_png(cfg.out, frame)
    print(f"wrote {cfg.out}")
    log.close()
    return 0


def cmd_view(args: argparse.Namespace) -> int:
    """Interactive viewer: progressive render streamed to the browser."""
    from .builder import compile_scene
    from .core.camera import Camera
    from .viewer.server import run_interactive
    from . import models

    cfg = config_from_args(args)
    camera = Camera(
        eye=cfg.camera.eye, lookat=cfg.camera.lookat, up=cfg.camera.up,
        fov_y=cfg.camera.fov_y, aspect_ratio=cfg.width / cfg.height,
    )
    hs, _ = _load_scene(cfg)
    cs = compile_scene(hs, leaf_size=8)
    probe = _load_probe(cfg)
    if cfg.model == "foveated":
        r = models.make_foveated_renderer(
            cs, probe, camera, cfg.width, cfg.height, cfg.max_depth,
            foveation=cfg.foveation,
            fused=cfg.fused_foveation, **_traversal(cfg),
            emission_all_bounces=cfg.emission_all_bounces,
            nee_final_bounce=cfg.nee_final_bounce, nee_rr=cfg.nee_rr,
            russian_roulette=cfg.russian_roulette,
            rr_start_depth=cfg.rr_start_depth,
            sampling=cfg.sampling, sampling_strata=cfg.sampling_strata,
        )
    else:
        demand = None
        if cfg.demand_textures > 0 and hs.textures:
            from .io.demand import DemandTextureManager

            demand = DemandTextureManager.from_host_scene(
                hs, capacity=cfg.demand_textures, levels=1
            )
        r = models.make_disney_pt_renderer(
            cs, probe, camera, cfg.width, cfg.height, cfg.spp, cfg.max_depth,
            **_traversal(cfg), demand=demand,
            sampling=cfg.sampling, sampling_strata=cfg.sampling_strata,
        )
    run_interactive(r, camera, port=args.port, max_frames=args.max_frames)
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    import subprocess

    return subprocess.call([sys.executable, "bench.py"] + (["--small"] if args.small else []))


def main(argv=None) -> int:
    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()
    parser = argparse.ArgumentParser(prog="optixpathtracer")
    sub = parser.add_subparsers(dest="command", required=True)

    p_render = sub.add_parser("render", help="render a scene with a model preset")
    add_config_args(p_render)
    p_render.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a jax.profiler device trace of the whole render into "
             "DIR (open with TensorBoard/xprof; the device-side analog of "
             "the reference's chrono frame splits, sutil.cpp:723-783)")
    p_render.set_defaults(fn=cmd_render)

    p_view = sub.add_parser("view", help="interactive browser viewer")
    add_config_args(p_view)
    p_view.add_argument("--port", type=int, default=8000)
    p_view.add_argument("--max-frames", type=int, default=None, dest="max_frames")
    p_view.set_defaults(fn=cmd_view)

    p_bench = sub.add_parser("bench", help="run the throughput benchmark")
    p_bench.add_argument("--small", action="store_true")
    p_bench.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    if getattr(args, "profile", None):
        import jax

        jax.profiler.start_trace(args.profile)
        try:
            return args.fn(args)
        finally:
            jax.profiler.stop_trace()
            print(f"profiler trace written to {args.profile}")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
