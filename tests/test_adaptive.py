"""Variance-guided adaptive sampling (engine/adaptive.py).

Three claims: (1) the estimator is CORRECT — with the budget covering every
tile, adaptive rounds reproduce the uniform renderer's mean (same per-pixel
RNG streams, so equal samples => equal estimate up to accumulation-order
float noise); (2) it is ADAPTIVE — refinement rounds concentrate samples on
the high-variance tiles, not uniformly; (3) it PAYS — at an equal total-ray
budget, the adaptive image has lower RMSE against a converged reference
than the uniform one on a variance-concentrated scene.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from golden_scenes import _cam, _open_scene, _sky_probe
from optixpathtracer.builder import compile_scene
from optixpathtracer.engine.adaptive import AdaptiveRenderer, _tile_layout
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig

W, H = 64, 48


def _setup(spp=2, depth=2):
    hs = _open_scene()
    cs = compile_scene(hs)
    probe = _sky_probe()
    cfg = RenderConfig(
        width=W, height=H, samples_per_launch=spp, max_depth=depth,
        clamp_radiance=1e30,
    )
    cam = _cam((3, 2, 4), (0, 0.4, 0))
    cam.aspect_ratio = W / H
    return cs, probe, cfg, cam


def test_tile_layout_covers_frame_once():
    tx, ty, px, py, valid = _tile_layout(50, 30)
    assert tx == -(-50 // 16) and ty == -(-30 // 8)
    pix = py[valid] * 50 + px[valid]
    assert pix.size == 50 * 30
    assert np.array_equal(np.sort(pix), np.arange(50 * 30))
    assert not np.any((px[~valid] < 50) & (py[~valid] < 30))


@pytest.mark.slow
def test_full_coverage_matches_uniform_renderer():
    """refine_fraction=1.0 + equal spp == the uniform renderer's mean.

    Identical tea streams per (pixel, sample index), so after the same
    number of samples the two estimators average the SAME sample values —
    only the accumulation order differs (running lerp vs sum/count)."""
    cs, probe, cfg, cam = _setup(spp=2)
    uni = Renderer(cs, probe, cfg, cam)
    for _ in range(3):  # 3 launches x 2 spp
        uni.render(download=False)
    ada = AdaptiveRenderer(
        cs, probe, cfg, cam, warmup_spp=2, refine_spp=2, refine_fraction=1.0
    )
    for _ in range(3):
        ada.render()
    a, u = ada.accum_image(), uni.accum_image()
    assert a.shape == u.shape == (H, W, 3)
    np.testing.assert_allclose(a, u, rtol=2e-5, atol=2e-6)
    st = ada.stats()
    assert st["spp_min"] == st["spp_max"] == 6


@pytest.mark.slow
def test_refinement_concentrates_samples():
    cs, probe, cfg, cam = _setup(spp=2)
    ada = AdaptiveRenderer(
        cs, probe, cfg, cam, warmup_spp=1, refine_spp=4, refine_fraction=0.2
    )
    ada.render()  # warmup: everything at 1 spp
    assert ada.stats()["spp_min"] == ada.stats()["spp_max"] == 1
    for _ in range(3):
        ada.render()
    st = ada.stats()
    assert st["spp_min"] == 1  # quiet tiles untouched
    assert st["spp_max"] > 1  # noisy tiles refined
    smap = ada.sample_map()
    assert smap.shape == (H, W)
    assert smap.min() >= 1
    # refined region is a strict subset of the frame
    assert (smap > 1).any() and not (smap > 1).all()
    # error map exists and is finite
    emap = ada.error_map()
    assert np.all(np.isfinite(emap))


@pytest.mark.slow
def test_adaptive_beats_uniform_at_equal_rays():
    """Equal-ray-budget RMSE vs a converged reference: adaptive wins on a
    scene whose variance is concentrated (glass + metal + sun probe)."""
    cs, probe, cfg, cam = _setup(spp=2, depth=3)

    # converged reference: 64 spp uniform
    ref_cfg = dataclasses.replace(cfg, samples_per_launch=8)
    ref = Renderer(cs, probe, ref_cfg, cam)
    for _ in range(8):
        ref.render(download=False)
    ref_img = ref.accum_image()

    ada = AdaptiveRenderer(
        cs, probe, cfg, cam, warmup_spp=2, refine_spp=4, refine_fraction=0.15
    )
    rounds = 6
    for _ in range(rounds):
        ada.render()
    ada_samples = ada.stats()["total_samples"]

    # uniform at the same TOTAL sample budget (rounded up — bias in
    # uniform's favor)
    per_launch = 2
    uni = Renderer(cs, probe, cfg, cam)
    launches = -(-ada_samples // (W * H * per_launch))
    for _ in range(launches):
        uni.render(download=False)
    uni_samples = launches * W * H * per_launch
    assert uni_samples >= ada_samples

    def rmse(img):
        return float(np.sqrt(np.mean((img - ref_img) ** 2)))

    r_ada, r_uni = rmse(ada.accum_image()), rmse(uni.accum_image())
    assert r_ada < r_uni, (
        f"adaptive {r_ada:.5f} (n={ada_samples}) should beat "
        f"uniform {r_uni:.5f} (n={uni_samples})"
    )
