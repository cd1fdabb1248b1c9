"""NEE scheduling: final-bounce skip (cfg.nee_final_bounce) and
Russian-roulette shadow-ray scheduling (cfg.nee_rr).

Reference semantics being matched/extended: the reference traces a shadow
ray at EVERY shaded hit (deviceProgram.cu:264-277) but its raygen loop
breaks before accumulating the final sweep's radiance
(deviceProgram.cu:429-437), so final-bounce NEE work is discarded upstream.
nee_final_bounce=False skips that sweep statically; nee_rr>0 replaces
always-trace with an unbiased RR estimator.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.engine.wavefront import (
    CameraParams,
    RenderConfig,
    trace_wavefront,
)
from optixpathtracer.lights.probe import build_probe


def _setup(width=24, height=16, spp=4, max_depth=3, **kw):
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0),
               extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2), roughness=0.4),
               pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    hs.add_box(make_material(color=(0.9, 0.8, 0.2), metallic=1.0, roughness=0.2),
               pos=(1.2, 0.4, 0.5), extent=(0.4, 0.4, 0.4))
    cs = compile_scene(hs)
    rng = np.random.default_rng(7)
    img = (0.3 + rng.random((8, 16, 3)) * 1.5).astype(np.float32)
    probe = build_probe(img)
    cfg = RenderConfig(width=width, height=height, samples_per_launch=spp,
                       max_depth=max_depth, **kw)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=width / height)
    n = width * height
    ys, xs = np.divmod(np.arange(n, dtype=np.int32), width)
    return cs, probe, cfg, CameraParams.from_camera(cam), jnp.asarray(xs), jnp.asarray(ys)


def _render(cs, probe, cfg, cam, px, py):
    return trace_wavefront(cs, probe, cfg, cam, px, py, jnp.uint32(0))


def _rgb(out):
    return np.stack([np.asarray(out.color.x), np.asarray(out.color.y),
                     np.asarray(out.color.z)])


@pytest.mark.slow
def test_final_bounce_skip_is_a_subset_of_always():
    """Skipping the final bounce's NEE removes only non-negative
    contributions from identical RNG streams: color_skip <= color_always
    elementwise, with strictly fewer rays traced."""
    cs, probe, cfg, cam, px, py = _setup()
    base = _render(cs, probe, cfg, cam, px, py)
    skip = _render(cs, probe, dataclasses.replace(cfg, nee_final_bounce=False),
                   cam, px, py)
    cb, csk = _rgb(base), _rgb(skip)
    assert np.isfinite(csk).all()
    assert float(skip.rays_traced) < float(base.rays_traced)
    assert np.all(csk <= cb + 1e-5)
    # the earlier bounces' NEE is untouched: images agree where the final
    # bounce contributed nothing (misses before the last bounce)
    assert np.any(np.abs(csk - cb) < 1e-7)


@pytest.mark.slow
def test_final_bounce_skip_fused_mode():
    cs, probe, cfg, cam, px, py = _setup()
    base = _render(cs, probe, dataclasses.replace(cfg, fused_shadows=True),
                   cam, px, py)
    skip = _render(
        cs, probe,
        dataclasses.replace(cfg, fused_shadows=True, nee_final_bounce=False),
        cam, px, py,
    )
    cb, csk = _rgb(base), _rgb(skip)
    assert np.isfinite(csk).all()
    assert float(skip.rays_traced) < float(base.rays_traced)
    assert np.all(csk <= cb + 1e-5)


def test_final_bounce_skip_depth0():
    """max_depth=0 + skip: pure primary visibility, no shadow rays at all."""
    cs, probe, cfg, cam, px, py = _setup(max_depth=0, spp=1)
    skip = _render(cs, probe, dataclasses.replace(cfg, nee_final_bounce=False),
                   cam, px, py)
    # every traced ray is a camera ray: rays == #pixels
    assert float(skip.rays_traced) == px.shape[0]


def test_rr_traces_fewer_rays_and_stays_finite():
    cs, probe, cfg, cam, px, py = _setup()
    base = _render(cs, probe, cfg, cam, px, py)
    rr = _render(cs, probe, dataclasses.replace(cfg, nee_rr=10.0), cam, px, py)
    assert np.isfinite(_rgb(rr)).all()
    assert float(rr.rays_traced) < float(base.rays_traced)


def test_rr_is_unbiased():
    """High-spp means agree between always-trace and RR scheduling (the RR
    estimator is exactly compensated by 1/p)."""
    cs, probe, cfg, cam, px, py = _setup(width=12, height=8, spp=192,
                                         max_depth=2)
    base = _render(cs, probe, cfg, cam, px, py)
    rr = _render(cs, probe, dataclasses.replace(cfg, nee_rr=0.2), cam, px, py)
    mb = float(_rgb(base).mean()) / cfg.samples_per_launch
    mr = float(_rgb(rr).mean()) / cfg.samples_per_launch
    assert abs(mb - mr) / max(mb, 1e-9) < 0.05, (mb, mr)


def test_rays_traced_fused_matches_unfused_with_final_skip():
    """rays_traced accounting: fused_shadows only changes WHEN shadow rays
    ride a sweep, never how many are traced — so the reported count must
    match the unfused mode exactly, including under nee_final_bounce=False
    (the peeled final sweep still traces the previous bounce's pending
    shadow rays and must count them)."""
    cs, probe, cfg, cam, px, py = _setup()
    for nee_final in (True, False):
        a = _render(cs, probe, dataclasses.replace(
            cfg, fused_shadows=False, nee_final_bounce=nee_final), cam, px, py)
        b = _render(cs, probe, dataclasses.replace(
            cfg, fused_shadows=True, nee_final_bounce=nee_final), cam, px, py)
        assert float(a.rays_traced) == float(b.rays_traced), (
            f"nee_final_bounce={nee_final}: unfused {float(a.rays_traced)} "
            f"vs fused {float(b.rays_traced)}"
        )
