"""One backend decision (utils/platform.py): the JAX platform picks the
traversal, an unknown platform is an error, and the command line routes an
absent --traversal through it."""
import argparse

import pytest

from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.utils import platform
from optixpathtracer.utils.config import add_config_args, config_from_args


def test_cpu_runs_lockstep():
    assert platform.device_platform() == "cpu"  # the tests pin the CPU
    assert platform.default_traversal() == "lockstep"
    cfg = platform.auto_tune(RenderConfig(width=64, height=48, traversal="bfs",
                                          dispatch_tiles=4, sort_rays=True))
    assert (cfg.traversal, cfg.sort_rays, cfg.dispatch_tiles) == ("lockstep", False, 1)


def test_gpu_runs_the_cuda_kernel(monkeypatch):
    monkeypatch.setattr(platform, "device_platform", lambda: "gpu")
    assert platform.default_traversal() == "gpu"
    cfg = platform.auto_tune(RenderConfig(width=1200, height=1024, dispatch_tiles=8))
    assert cfg.traversal == "gpu" and cfg.dispatch_tiles == 1
    assert cfg.sort_rays == platform.DEFAULTS["gpu"][1]


@pytest.mark.parametrize("name", ["METAL", "rocm", "neuron"])
def test_unknown_platform_raises(monkeypatch, name):
    monkeypatch.setattr(platform, "device_platform", lambda: name)
    with pytest.raises(RuntimeError, match="no traversal for JAX platform"):
        platform.auto_tune(RenderConfig(width=8, height=8))
    with pytest.raises(RuntimeError):
        platform.default_traversal()


def test_cli_traversal_choices():
    parser = argparse.ArgumentParser()
    add_config_args(parser)
    assert config_from_args(parser.parse_args([])).traversal is None  # auto
    for tr in ("lockstep", "gpu", "bfs", "dense"):
        assert config_from_args(parser.parse_args(["--traversal", tr])).traversal == tr
    for gone in ("cluster", "oracle"):
        with pytest.raises(SystemExit):
            parser.parse_args(["--traversal", gone])
    with pytest.raises(SystemExit):
        parser.parse_args(["--instanced"])
