"""The bench quality track's composed pipeline — mechanics pinned at test scale.

bench.py quality_track row 2 composes three subsystems: Owen-scrambled Sobol
sampling + variance-guided adaptive top-K refinement + demodulated
variance-guided A-Trous denoising. Its headline (equal-quality >=3x over
uniform PT) is a BENCH-SCALE claim, driver-verified against the committed
4096-spp reference (scenes/ref_city_600x400.npz, BENCH_LOCAL_r4.json) — at
tiny test frames it is measurably false: the A-Trous bias floor is
~0.17 sqrt-RMSE at 64x48 (kernel support is a large fraction of the frame),
above uniform PT's 4-spp noise, so an equal-budget assertion here would pin
an accident of scale, not the pipeline.

What IS scale-invariant, and what this pins, is the composition mechanics
the bench row depends on:
  * the adaptive renderer's tile rows scatter back to a correct frame
    (pixel permutation + count normalization);
  * the tracked per-pixel variance buffer drives the denoiser (the exact
    rmse_pipeline path bench.py jits);
  * denoising the adaptive sobol render IMPROVES it against a converged
    reference (the stage earns its cost even at tiny scale);
  * the pipeline conserves energy (demodulated filtering must not create
    or destroy mean radiance).

Reference behavior: the sv4 variant's quality-vs-fps deliverable
(HelloPathtracing_sv4_vmv23/SimplePathtracer.cpp:135-215, final_fps.dat).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from golden_scenes import _cam, _open_scene, _sky_probe
from optixpathtracer.builder import compile_scene
from optixpathtracer.engine.adaptive import AdaptiveRenderer
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.ops.denoise import atrous_denoise

W, H = 64, 48


def _pipeline_images(ar):
    """The bench quality track's pipeline images: scatter the adaptive tile
    rows back to the frame, then demodulated variance-guided A-Trous
    (bench.py quality_track rmse_pipeline, measured-best denoiser config).
    Returns (raw_accum_image, denoised_image) as numpy (H, W, 3)."""
    yx_np = np.asarray(ar._py) * W + np.asarray(ar._px)
    yx = jnp.asarray(np.where(np.asarray(ar._valid), yx_np, W * H))
    nf1 = jnp.maximum(ar.count.astype(jnp.float32), 1.0)
    nf = nf1[:, None]

    def img(v):
        rows = jnp.stack([v.x, v.y, v.z], -1) / nf
        buf = jnp.zeros((W * H + 1, 3), jnp.float32).at[yx].set(
            rows, mode="promise_in_bounds")
        return buf[: W * H].reshape(H, W, 3)

    mean_l = ar.lum_sum / nf1
    var = jnp.maximum(ar.lum2_sum / nf1 - mean_l * mean_l, 0.0) / nf1
    vbuf = jnp.zeros((W * H + 1,), jnp.float32).at[yx].set(
        var, mode="promise_in_bounds")
    raw = img(ar.col_sum)
    dn = atrous_denoise(raw, img(ar.nrm_sum), img(ar.alb_sum),
                        sigma_color=4.0, sigma_albedo=1.0,
                        variance=vbuf[: W * H].reshape(H, W),
                        var_boost=256.0, demodulate=True)
    return np.asarray(raw), np.asarray(dn)


def test_denoise_stage_improves_adaptive_sobol_render():
    hs = _open_scene()
    cs = compile_scene(hs)
    probe = _sky_probe()
    cfg = RenderConfig(width=W, height=H, samples_per_launch=2, max_depth=3,
                       clamp_radiance=1e30)
    cam = _cam((3, 2, 4), (0, 0.4, 0))
    cam.aspect_ratio = W / H

    # converged reference: 64-spp uniform accumulation
    ref = Renderer(cs, probe,
                   dataclasses.replace(cfg, samples_per_launch=8), cam)
    for _ in range(8):
        ref.render(download=False)
    # sqrt (gamma-ish) space, as the bench's RMSE target is defined
    ref_img = np.sqrt(np.clip(ref.accum_image(), 0, None))

    ar = AdaptiveRenderer(cs, probe,
                          dataclasses.replace(cfg, sampling="sobol"), cam,
                          warmup_spp=2, refine_spp=4, refine_fraction=0.25)
    for _ in range(3):
        ar.render()
    raw, dn = _pipeline_images(ar)

    def rmse(img):
        return float(np.sqrt(np.mean(
            (np.sqrt(np.clip(img, 0, None)) - ref_img) ** 2)))

    r_raw, r_dn = rmse(raw), rmse(dn)
    # the denoise stage must pay for itself on its own input (measured here:
    # ~0.217 raw -> ~0.166 denoised; require a real, not epsilon, margin)
    assert r_dn < 0.9 * r_raw, (
        f"denoised {r_dn:.5f} should improve on raw adaptive {r_raw:.5f}")

    # scatter correctness: every valid tile row landed on its own pixel, so
    # the raw accumulation's mean energy matches the reference's closely
    # (both are unbiased estimators of the same image)
    m_raw, m_ref = float(raw.mean()), float(ref.accum_image().mean())
    assert abs(m_raw - m_ref) < 0.12 * m_ref, (m_raw, m_ref)

    # energy conservation through demodulated filtering: smoothing must not
    # create or destroy mean radiance beyond edge-clamp leakage
    m_dn = float(dn.mean())
    assert abs(m_dn - m_raw) < 0.1 * m_raw, (m_dn, m_raw)

    assert np.isfinite(dn).all()


@pytest.mark.slow
@pytest.mark.xfail(
    reason="measured honestly: at 160x120 the equal-budget direction is "
    "FALSE — uniform 6 spp RMSE 0.101 vs pipeline 0.168 (raw adaptive 4 spp "
    "0.219; denoise iterations 2-4 / var_boost 64-256 all land 0.168-0.178). "
    "The pipeline's win needs the high-resolution regime where the A-Trous "
    "footprint spans many independent pixels (bench.py quality track at "
    "600x400). Kept as an honest record of where the crossover is NOT yet "
    "reached at CPU test sizes.",
    strict=False)
def test_equal_budget_pipeline_beats_uniform_medium_res():
    """The >=3x bench headline's DIRECTION verified on the CPU at a
    resolution where the A-Trous kernel support is a small fraction of the
    frame (160x120): at an equal sample budget the composed pipeline's
    sqrt-space RMSE must beat uniform PT's. (The magnitude of the win stays
    a bench-scale, driver-verified claim.)"""
    mw, mh = 160, 120
    hs = _open_scene()
    cs = compile_scene(hs)
    probe = _sky_probe()
    cfg = RenderConfig(width=mw, height=mh, samples_per_launch=2,
                       max_depth=3, clamp_radiance=1e30)
    cam = _cam((3, 2, 4), (0, 0.4, 0))
    cam.aspect_ratio = mw / mh

    # converged reference: 96-spp uniform accumulation
    ref = Renderer(cs, probe,
                   dataclasses.replace(cfg, samples_per_launch=8), cam)
    for _ in range(12):
        ref.render(download=False)
    ref_img = np.sqrt(np.clip(ref.accum_image(), 0, None))

    # uniform at a 6-spp budget
    uni = Renderer(cs, probe, cfg, cam)
    for _ in range(3):
        uni.render(download=False)
    uni_img = uni.accum_image()

    # pipeline at the same mean budget: warmup 2 + 2 refine rounds of
    # refine_spp 4 over a 0.25 fraction => mean spp = 2 + 2*4*0.25 = 4 < 6
    # (the pipeline gets FEWER samples and must still win)
    gw, gh = mw, mh

    ar = AdaptiveRenderer(cs, probe,
                          dataclasses.replace(cfg, sampling="sobol"), cam,
                          warmup_spp=2, refine_spp=4, refine_fraction=0.25)
    for _ in range(3):
        ar.render()
    mean_spp = float(np.asarray(ar.count, np.float32).sum()) / (gw * gh)
    assert mean_spp <= 6.0 + 1e-3, mean_spp

    yx_np = np.asarray(ar._py) * gw + np.asarray(ar._px)
    yx = jnp.asarray(np.where(np.asarray(ar._valid), yx_np, gw * gh))
    nf1 = jnp.maximum(ar.count.astype(jnp.float32), 1.0)
    nf = nf1[:, None]

    def img(v):
        rows = jnp.stack([v.x, v.y, v.z], -1) / nf
        buf = jnp.zeros((gw * gh + 1, 3), jnp.float32).at[yx].set(
            rows, mode="promise_in_bounds")
        return buf[: gw * gh].reshape(gh, gw, 3)

    mean_l = ar.lum_sum / nf1
    var = jnp.maximum(ar.lum2_sum / nf1 - mean_l * mean_l, 0.0) / nf1
    vbuf = jnp.zeros((gw * gh + 1,), jnp.float32).at[yx].set(
        var, mode="promise_in_bounds")
    dn = np.asarray(atrous_denoise(
        img(ar.col_sum), img(ar.nrm_sum), img(ar.alb_sum),
        sigma_color=4.0, sigma_albedo=1.0,
        variance=vbuf[: gw * gh].reshape(gh, gw),
        var_boost=256.0, demodulate=True))

    def rmse(im):
        return float(np.sqrt(np.mean(
            (np.sqrt(np.clip(im, 0, None)) - ref_img) ** 2)))

    r_uni, r_dn = rmse(uni_img), rmse(dn)
    assert r_dn < r_uni, (
        f"pipeline {r_dn:.5f} (at {mean_spp:.1f} spp) should beat uniform "
        f"{r_uni:.5f} (at 6 spp)")
