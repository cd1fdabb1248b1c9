"""Run configuration + CLI — new work by design.

The reference has NO config system: every knob is a compile-time #define or a
hard-coded absolute Windows path (SURVEY.md §5 'Config / flag system'; e.g.
scene path main.cpp:171, HDR main.cpp:175, FOV_ON SimplePathtracer.cpp:23,
spp main.cpp:134). Here the whole LaunchParams/#define surface is one JSON-
serializable dataclass tree driving the model presets.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any

from ..engine.foveated import FoveationConfig
from ..engine.wavefront import RenderConfig

TRAVERSALS = ("lockstep", "gpu", "bfs", "dense")


@dataclasses.dataclass
class CameraSpec:
    eye: tuple = (3.0, 2.0, 4.0)
    lookat: tuple = (0.0, 0.4, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov_y: float = 35.0


@dataclasses.dataclass
class RunConfig:
    """Top-level run spec: model preset + scene + camera + render knobs."""

    model: str = "disney_pt"  # one of models.PRESETS
    scene: str = ""  # .obj / .gltf / .glb path, or "" for procedural preset
    probe: str = ""  # .hdr path, or "" for uniform sky
    probe_level: float = 0.5  # uniform sky radiance when probe == ""
    out: str = "out.png"
    frames: int = 1  # progressive launches
    width: int = 1200
    height: int = 800
    spp: int = 4
    max_depth: int = 4
    traversal: str | None = None  # None: the platform's (utils/platform.py)
    emission_all_bounces: bool = False  # emissive GEOMETRY lights the scene
    #   through BSDF paths (closed interiors like scenes/loft.obj render
    #   black without it — the reference adds emission only on primary hits)
    nee_final_bounce: bool = True  # False: statically skip the last bounce's
    #   NEE shadow sweep (the reference traces it then discards the result)
    nee_rr: float = 0.0  # unbiased Russian-roulette shadow-ray scheduling
    #   threshold (0 = always trace, reference behavior)
    russian_roulette: bool = False  # throughput-proportional Russian-roulette
    #   PATH termination after rr_start_depth bounces (unbiased; off for
    #   reference parity — its bounce loop always runs to max depth)
    rr_start_depth: int = 2
    sampling: str = "random"  # per-sample uniform strategy for the variance-
    #   dominant draws: "random" | "stratified" | "blue" | "sobol" (the
    #   reference's sample.h Sample2D strategy switch, live at runtime;
    #   "sobol" = padded Owen-scrambled (0,2)-sequence over every path
    #   dimension pair at every bounce, core/sobol.py)
    sampling_strata: int = 64  # strata / blue-noise points per pixel epoch
    denoise: bool = False
    tonemap: str = "reinhard"
    exposure: float = 0.0
    checkpoint: str = ""  # resume/save progressive state here
    metrics: str = ""  # JSONL per-frame metrics path
    gaze: tuple = (-1, -1)  # foveated: gaze pixel (defaults to center)
    fused_foveation: bool | None = None  # trace all foveation zones in ONE
    #   wavefront launch (same RNG streams/estimator as the reference's
    #   three sequential optixLaunches; pays the per-sweep floors once);
    #   None = auto (fused at interactive sizes)
    demand_textures: int = 0  # >0: shade scene textures from the sparse
    #   demand-loaded pool with this tile capacity (pages stream in between
    #   progressive launches; the reference's DemandLoading, live)
    adaptive: bool = False  # disney_pt: variance-guided adaptive sampling —
    #   after a uniform warmup launch, each frame refines only the
    #   highest-variance tiles (beyond-parity; engine/adaptive.py)
    adaptive_fraction: float = 0.25  # fraction of tiles refined per frame
    camera: CameraSpec = dataclasses.field(default_factory=CameraSpec)
    foveation: FoveationConfig = dataclasses.field(default_factory=FoveationConfig)

    def render_config(self, **overrides) -> RenderConfig:
        if self.traversal is not None:
            overrides.setdefault("traversal", self.traversal)
        return RenderConfig(
            width=self.width,
            height=self.height,
            samples_per_launch=self.spp,
            max_depth=self.max_depth,
            emission_all_bounces=self.emission_all_bounces,
            nee_final_bounce=self.nee_final_bounce,
            nee_rr=self.nee_rr,
            russian_roulette=self.russian_roulette,
            rr_start_depth=self.rr_start_depth,
            sampling=self.sampling,
            sampling_strata=self.sampling_strata,
            **overrides,
        )

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "RunConfig":
        d = json.loads(text)
        cam = CameraSpec(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in d.pop("camera", {}).items()})
        fov = FoveationConfig(**d.pop("foveation", {}))
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return RunConfig(camera=cam, foveation=fov, **d)


def add_config_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", default="", help="JSON RunConfig file")
    parser.add_argument("--model", default=None, choices=[
        "hello_raytracing", "whitted", "disney_pt", "spectral", "foveated"])
    parser.add_argument("--scene", default=None)
    parser.add_argument("--probe", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--frames", type=int, default=None)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--spp", type=int, default=None)
    parser.add_argument("--max-depth", type=int, default=None, dest="max_depth")
    parser.add_argument(
        "--traversal", default=None, choices=TRAVERSALS,
        help="traversal backend (default: gpu on a GPU, lockstep on the CPU)")
    parser.add_argument(
        "--emission-all-bounces", action="store_true", default=None,
        dest="emission_all_bounces",
        help="let emissive geometry light the scene through BSDF paths "
             "(needed for closed interiors, e.g. scenes/loft.obj)")
    parser.add_argument(
        "--no-nee-final-bounce", action="store_false", default=None,
        dest="nee_final_bounce",
        help="skip the final bounce's NEE shadow sweep (the reference traces "
             "it then discards the contribution; ~6%% faster frames)")
    parser.add_argument(
        "--nee-rr", type=float, default=None, dest="nee_rr",
        help="unbiased Russian-roulette shadow-ray scheduling threshold "
             "(potential-contribution luminance; 0 = always trace)")
    parser.add_argument(
        "--russian-roulette", action="store_true", default=None,
        dest="russian_roulette",
        help="throughput-proportional Russian-roulette path termination "
             "after --rr-start-depth bounces (unbiased; kills most deep "
             "paths on dark scenes)")
    parser.add_argument(
        "--rr-start-depth", type=int, default=None, dest="rr_start_depth",
        metavar="D", help="first bounce depth roulette applies to (default 2)")
    parser.add_argument(
        "--sampling", default=None,
        choices=["random", "stratified", "blue", "sobol"],
        help="sampling strategy for the variance-dominant 2D draws: "
             "per-pixel-scrambled jittered strata / projective blue noise "
             "(AA + first-bounce NEE/BSDF) or a padded Owen-scrambled Sobol "
             "(0,2)-sequence covering every bounce's draws (all unbiased; "
             "measured 2-5x variance cut on direct lighting at equal spp)")
    parser.add_argument(
        "--sampling-strata", type=int, default=None, dest="sampling_strata",
        metavar="M", help="strata / blue-noise points per pixel epoch "
                          "(perfect square; default 64)")
    parser.add_argument(
        "--demand-textures", type=int, default=None, dest="demand_textures",
        metavar="CAPACITY",
        help="shade textures from a sparse demand-loaded tile pool of this "
             "capacity (0 = resident textures, the default)")
    parser.add_argument(
        "--adaptive", action="store_true", default=None,
        help="disney_pt: variance-guided adaptive sampling — frame 1 is a "
             "uniform warmup, every further frame refines only the "
             "highest-variance tiles (--frames controls the round count)")
    parser.add_argument(
        "--adaptive-fraction", type=float, default=None,
        dest="adaptive_fraction", metavar="F",
        help="fraction of tiles refined per adaptive round (default 0.25)")
    parser.add_argument("--denoise", action="store_true", default=None)
    parser.add_argument("--tonemap", default=None, choices=["none", "sqrt", "reinhard"])
    parser.add_argument("--exposure", type=float, default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--metrics", default=None)
    parser.add_argument("--eye", type=float, nargs=3, default=None)
    parser.add_argument("--lookat", type=float, nargs=3, default=None)
    parser.add_argument("--fov-y", type=float, default=None, dest="fov_y")
    parser.add_argument("--gaze", type=int, nargs=2, default=None)
    parser.add_argument(
        "--fused-foveation", action=argparse.BooleanOptionalAction,
        default=None, dest="fused_foveation",
        help="trace all foveation zones in one wavefront launch instead of "
             "three (identical streams/estimator; pays dispatch floors once); "
             "--no-fused-foveation forces the 3-launch mode; default: auto "
             "(fused at interactive sizes)")


def config_from_args(args: argparse.Namespace) -> RunConfig:
    cfg = RunConfig()
    if args.config:
        with open(args.config) as f:
            cfg = RunConfig.from_json(f.read())
    for field in ("model", "scene", "probe", "out", "frames", "width", "height",
                  "spp", "max_depth", "traversal", "emission_all_bounces",
                  "nee_final_bounce", "nee_rr", "russian_roulette",
                  "rr_start_depth", "sampling", "sampling_strata",
                  "fused_foveation",
                  "demand_textures", "adaptive",
                  "adaptive_fraction",
                  "denoise", "tonemap", "exposure", "checkpoint", "metrics"):
        v = getattr(args, field, None)
        if v is not None:
            setattr(cfg, field, v)
    if args.eye is not None:
        cfg.camera.eye = tuple(args.eye)
    if args.lookat is not None:
        cfg.camera.lookat = tuple(args.lookat)
    if args.fov_y is not None:
        cfg.camera.fov_y = args.fov_y
    if args.gaze is not None:
        cfg.gaze = tuple(args.gaze)
    return cfg
