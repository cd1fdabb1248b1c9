"""AOV-guided denoiser: edge-avoiding À-Trous wavelet filtering.

Replaces the reference's OptixDenoiser wrapper, whose init()/exec() are empty
stubs (HelloPathtracing_original/OptixDenoiser.cpp:15-43) while the renderer
still allocates and fills the color/albedo/normal guide buffers
(SimplePathtracer.cpp:124-136, deviceProgram.cu:472-474). Here the same three
guides drive a real filter (Dammertz et al. 2010 edge-avoiding À-Trous):
per-iteration 5x5 B3-spline taps with exponentially growing dilation, tap
weights modulated by color/normal/albedo similarity.

Taps are static shifts (pad + slice) over the (H, W) planes — pure dense
work that XLA fuses; no gather/scatter.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

Array = jax.Array

# 5-tap B3-spline, separable (python floats: static weights under jit)
_B3 = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)


def _shift2d(x: Array, dy: int, dx: int) -> Array:
    """Shift with edge clamp (replicate padding), static offsets."""
    h, w = x.shape[:2]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    pad = [(py0, py1), (px0, px1)] + [(0, 0)] * (x.ndim - 2)
    xp = jnp.pad(x, pad, mode="edge")
    return xp[py1 : py1 + h, px1 : px1 + w]


@partial(jax.jit, static_argnames=("iterations", "demodulate"))
def atrous_denoise(
    color: Array,  # (H, W, 3) linear radiance
    normal: Array,  # (H, W, 3)
    albedo: Array,  # (H, W, 3)
    iterations: int = 4,
    sigma_color=0.5,
    sigma_normal: float = 0.25,
    sigma_albedo=0.25,
    variance: Array | None = None,  # (H, W) variance of the per-pixel MEAN
    var_boost=64.0,
    depth: Array | None = None,  # (H, W) first-hit distance (0 = miss)
    sigma_depth=0.1,
    demodulate: bool = False,  # filter ILLUMINATION (color / albedo) and
    #   re-modulate: illumination is smooth across material boundaries, so
    #   the filter can average over differently-colored surfaces that the
    #   albedo edge-stop would otherwise isolate (SVGF demodulation)
) -> Array:
    """Edge-avoiding À-Trous filter; returns denoised (H, W, 3).

    variance (optional): per-pixel variance of the running-mean luminance
    estimate (the adaptive renderer tracks it exactly). The color
    edge-stopping denominator scales with the LOCAL noise level,
    SVGF-style: where the estimate is still noisy the filter smooths
    through what a fixed sigma would misread as edges, and as variance
    shrinks the filter sharpens back to the guided baseline.

    depth (optional): first-hit distance guide — stops the filter at
    geometry discontinuities between surfaces whose normal AND albedo
    agree (parallel rooftops, ground planes behind walls), which are
    exactly where the normal/albedo-guided filter bleeds. The distance
    term is RELATIVE (|zp - zq| / max(zp, zq)) so it is scene-scale-free;
    misses carry depth 0 and smooth freely among themselves.

    sigma_color / var_boost / sigma_depth may be traced scalars (tunable
    without recompiling)."""
    out = color
    if demodulate:
        mod = jnp.maximum(albedo, 1e-3)
        out = color / mod
    if variance is not None:
        var = jnp.maximum(variance, 0.0)[..., None]
    if depth is not None:
        z = depth[..., None]
    for it in range(iterations):
        step = 1 << it
        accum = jnp.zeros_like(out)
        wsum = jnp.zeros(out.shape[:2] + (1,), out.dtype)
        denom_c = sigma_color * sigma_color
        if variance is not None:
            denom_c = denom_c * (1.0 + var_boost * var)
        for i in range(5):
            for j in range(5):
                dy = (i - 2) * step
                dx = (j - 2) * step
                k = float(_B3[i] * _B3[j])
                c = _shift2d(out, dy, dx)
                nn = _shift2d(normal, dy, dx)
                aa = _shift2d(albedo, dy, dx)
                dc = jnp.sum((c - out) ** 2, -1, keepdims=True)
                dn = jnp.sum((nn - normal) ** 2, -1, keepdims=True)
                da = jnp.sum((aa - albedo) ** 2, -1, keepdims=True)
                e = (
                    -dc / denom_c
                    - dn / (sigma_normal * sigma_normal)
                    - da / (sigma_albedo * sigma_albedo)
                )
                if depth is not None:
                    zz = _shift2d(z, dy, dx)
                    dz = (zz - z) / jnp.maximum(jnp.maximum(zz, z), 1e-6)
                    e = e - dz * dz / (sigma_depth * sigma_depth)
                wgt = k * jnp.exp(e)
                accum = accum + c * wgt
                wsum = wsum + wgt
        out = accum / jnp.maximum(wsum, 1e-8)
    if demodulate:
        out = out * mod
    return out


def bilateral_denoise(color: Array, sigma_space: int = 2, sigma_color: float = 0.4) -> Array:
    """Single-pass joint bilateral (no guides) — cheap fallback."""
    r = sigma_space
    accum = jnp.zeros_like(color)
    wsum = jnp.zeros(color.shape[:2] + (1,), color.dtype)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            c = _shift2d(color, dy, dx)
            spatial = jnp.exp(-(dy * dy + dx * dx) / (2.0 * r * r))
            dc = jnp.sum((c - color) ** 2, -1, keepdims=True)
            wgt = spatial * jnp.exp(-dc / (sigma_color * sigma_color))
            accum = accum + c * wgt
            wsum = wsum + wgt
    return accum / jnp.maximum(wsum, 1e-8)
