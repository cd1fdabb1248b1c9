import argparse

from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.utils.config import (
    RunConfig,
    add_config_args,
    config_from_args,
)
from optixpathtracer.utils.platform import auto_tune


def test_runconfig_json_roundtrip():
    import dataclasses

    from optixpathtracer.engine.foveated import FoveationConfig

    cfg = RunConfig(model="foveated", scene="x.obj", spp=7, width=320, height=200,
                    foveation=FoveationConfig(inner_radius=42))
    cfg.camera.eye = (1.0, 2.0, 3.0)
    back = RunConfig.from_json(cfg.to_json())
    assert back.model == "foveated"
    assert back.spp == 7
    assert tuple(back.camera.eye) == (1.0, 2.0, 3.0)
    assert back.foveation.inner_radius == 42


def test_cli_overrides_config(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(RunConfig(model="whitted", spp=3).to_json())
    parser = argparse.ArgumentParser()
    add_config_args(parser)
    args = parser.parse_args(["--config", str(p), "--spp", "9", "--width", "64"])
    cfg = config_from_args(args)
    assert cfg.model == "whitted"  # from file
    assert cfg.spp == 9  # overridden
    assert cfg.width == 64


def test_render_config_factory():
    rc = RunConfig(width=100, height=50, spp=2, max_depth=3, traversal="bfs")
    cfg = rc.render_config()
    assert isinstance(cfg, RenderConfig)
    assert (cfg.width, cfg.height, cfg.samples_per_launch, cfg.max_depth) == (100, 50, 2, 3)
    assert cfg.traversal == "bfs"


def test_auto_tune_cpu_picks_lockstep():
    # tests run with jax on CPU
    cfg = auto_tune(RenderConfig(width=64, height=48, traversal="bfs"))
    assert cfg.traversal == "lockstep"
    assert cfg.dispatch_tiles == 1


def test_fused_foveation_tri_state():
    """--fused-foveation / --no-fused-foveation / absent (auto) must map to
    True / False / None — the auto-enable rule needs a real off switch."""
    for argv, want in ([["--fused-foveation"], True],
                       [["--no-fused-foveation"], False],
                       [[], None]):
        parser = argparse.ArgumentParser()
        add_config_args(parser)
        cfg = config_from_args(parser.parse_args(argv))
        assert cfg.fused_foveation is want, (argv, cfg.fused_foveation)


def test_cli_sampling_flag_reaches_the_engine(tmp_path):
    """Regression: the render command must FORWARD --sampling to the engine
    (round 4 shipped a CLI that accepted the flag and dropped it on the
    disney_pt path) — renders with different strategies must differ, and
    the same strategy must reproduce bit-exactly."""
    import runpy
    import sys

    import numpy as np

    from optixpathtracer.io.image import decode_png

    def render(strategy, out):
        argv = ["cli", "render", "--model", "disney_pt", "--width", "48",
                "--height", "32", "--spp", "1", "--max-depth", "1",
                "--sampling", strategy, "--out", str(out)]
        old = sys.argv
        sys.argv = argv
        try:
            runpy.run_module("optixpathtracer.cli", run_name="__main__")
        except SystemExit:
            pass
        finally:
            sys.argv = old
        return decode_png(out.read_bytes()).astype(float)

    a = render("sobol", tmp_path / "a.png")
    b = render("random", tmp_path / "b.png")
    c = render("sobol", tmp_path / "c.png")
    assert not np.array_equal(a, b), "--sampling had no effect on the render"
    np.testing.assert_array_equal(a, c)
    assert abs(a.mean() - b.mean()) / b.mean() < 0.1  # same scene, same scale
