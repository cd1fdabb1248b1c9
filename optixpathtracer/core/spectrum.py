"""Hero-wavelength spectral rendering support.

Reference: HelloPathtracing_sv3/spectrum.h — an 81-bin 380-720nm
SampledSpectrum with multi-lobe Gaussian CIE fits (:508-523, the Wyman et al.
2013 analytic approximations), XYZ->sRGB (:399-416), and a Smits-style
white/cyan/magenta/yellow/red/green/blue RGB->spectrum basis decomposition
(:585-636). NOTE: the reference ships this header but never wires it into a
renderer (no #include anywhere, SURVEY.md §2); here it is implemented for
real and driven by engine/spectral.py.

Formulation: no 81-bin tables — reflectance spectra are evaluated
ANALYTICALLY at the hero wavelength and its rotated companions (PBRT-style),
so a ray carries a (4,) spectral throughput instead of RGB. The Smits basis
is built from smooth analytic band windows, calibrated so white round-trips
exactly; CIE matching functions use the same Gaussian fits as the reference.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .math import Vec3

Array = jax.Array

LAMBDA_MIN = 380.0
LAMBDA_MAX = 720.0
LAMBDA_RANGE = LAMBDA_MAX - LAMBDA_MIN
N_HERO = 4  # hero wavelength + 3 rotations


def gauss(x: Array, mu: float, s1: float, s2: float) -> Array:
    """Piecewise two-sided Gaussian (Wyman 2013 / spectrum.h:508-511)."""
    s = jnp.where(x < mu, s1, s2)
    t = (x - mu) / s
    return jnp.exp(-0.5 * t * t)


def cie_x(lam: Array) -> Array:
    return (
        1.056 * gauss(lam, 599.8, 37.9, 31.0)
        + 0.362 * gauss(lam, 442.0, 16.0, 26.7)
        - 0.065 * gauss(lam, 501.1, 20.4, 26.2)
    )


def cie_y(lam: Array) -> Array:
    return 0.821 * gauss(lam, 568.8, 46.9, 40.5) + 0.286 * gauss(lam, 530.9, 16.3, 31.1)


def cie_z(lam: Array) -> Array:
    return 1.217 * gauss(lam, 437.0, 11.8, 36.0) + 0.681 * gauss(lam, 459.0, 26.0, 13.8)


# integral of cie_y over [LAMBDA_MIN, LAMBDA_MAX] (for normalization);
# computed once numerically at import (cheap, numpy-free via jnp on trace)
_lam_grid = jnp.linspace(LAMBDA_MIN, LAMBDA_MAX, 256)
CIE_Y_INTEGRAL = float(jnp.trapezoid(cie_y(_lam_grid), _lam_grid))


def xyz_to_srgb_linear(x: Array, y: Array, z: Array) -> Vec3:
    """CIE XYZ -> linear sRGB (same matrix as spectrum.h XYZToSRGB)."""
    r = 3.2404542 * x - 1.5371385 * y - 0.4985314 * z
    g = -0.9692660 * x + 1.8760108 * y + 0.0415560 * z
    b = 0.0556434 * x - 0.2040259 * y + 1.0572252 * z
    return Vec3(r, g, b)


# ---- Smits-style analytic basis ---------------------------------------------

def _band(lam: Array, lo: float, hi: float, soft: float = 12.0) -> Array:
    """Smooth box window over [lo, hi] nm."""
    return jax.nn.sigmoid((lam - lo) / soft) * jax.nn.sigmoid((hi - lam) / soft)


def _basis(lam: Array) -> dict[str, Array]:
    blue = _band(lam, 340.0, 490.0)
    green = _band(lam, 490.0, 595.0)
    red = _band(lam, 595.0, 760.0)
    return dict(
        white=jnp.ones_like(lam),
        red=red,
        green=green,
        blue=blue,
        cyan=jnp.clip(green + blue, 0.0, 1.05),
        magenta=jnp.clip(red + blue, 0.0, 1.05),
        yellow=jnp.clip(red + green, 0.0, 1.05),
    )


def rgb_to_spectrum(rgb: Vec3, lam: Array) -> Array:
    """Evaluate the reflectance spectrum of an RGB albedo at wavelengths lam.

    Smits decomposition (spectrum.h rgb2spectrum :585-636): the smallest
    channel contributes white, then the secondary/primary bases fill the
    rest. rgb components broadcast against lam (shapes must be compatible).
    """
    b = _basis(lam)

    def expand(c):
        c = jnp.asarray(c)
        while c.ndim < jnp.ndim(lam):
            c = c[..., None]
        return c

    r, g, bl = expand(rgb.x), expand(rgb.y), expand(rgb.z)

    # branchless reformulation of the 6-way ordering
    m = jnp.minimum(r, jnp.minimum(g, bl))
    out = b["white"] * m

    r_min = (r <= g) & (r <= bl)
    g_min = (g < r) & (g <= bl)
    # case r smallest: cyan covers min(g,b)-r, then blue/green remainder
    c1 = jnp.minimum(g, bl) - r
    rem_gb = jnp.abs(g - bl)
    case_r = b["cyan"] * jnp.maximum(c1, 0.0) + jnp.where(
        g <= bl, b["blue"] * rem_gb, b["green"] * rem_gb
    )
    # case g smallest
    c2 = jnp.minimum(r, bl) - g
    rem_rb = jnp.abs(r - bl)
    case_g = b["magenta"] * jnp.maximum(c2, 0.0) + jnp.where(
        r <= bl, b["blue"] * rem_rb, b["red"] * rem_rb
    )
    # case b smallest
    c3 = jnp.minimum(r, g) - bl
    rem_rg = jnp.abs(r - g)
    case_b = b["yellow"] * jnp.maximum(c3, 0.0) + jnp.where(
        r <= g, b["green"] * rem_rg, b["red"] * rem_rg
    )

    out = out + jnp.where(r_min, case_r, jnp.where(g_min, case_g, case_b))
    return out


def sample_hero_wavelengths(u: Array) -> Array:
    """u (N,) uniform -> (N, N_HERO) wavelengths: hero + equally rotated
    companions (pdf = 1/LAMBDA_RANGE each)."""
    hero = LAMBDA_MIN + u * LAMBDA_RANGE
    k = jnp.arange(N_HERO, dtype=jnp.float32) / N_HERO
    lam = hero[:, None] + k[None, :] * LAMBDA_RANGE
    return jnp.where(lam > LAMBDA_MAX, lam - LAMBDA_RANGE, lam)


def spectral_to_rgb(radiance: Array, lam: Array) -> Vec3:
    """MC estimate: (N, H) spectral radiance + wavelengths -> linear sRGB.

    Divides by the uniform pdf (1/range) and averages the H hero samples,
    then integrates against the CIE curves and converts (spectrum.h:236-258).
    """
    w = LAMBDA_RANGE / lam.shape[-1] / CIE_Y_INTEGRAL
    x = jnp.sum(radiance * cie_x(lam), axis=-1) * w
    y = jnp.sum(radiance * cie_y(lam), axis=-1) * w
    z = jnp.sum(radiance * cie_z(lam), axis=-1) * w
    return xyz_to_srgb_linear(x, y, z)


# white-point calibration: scale so that a perfect white reflector lit by an
# equal-energy illuminant round-trips to rgb == (1,1,1)
_w = spectral_to_rgb(jnp.ones((1, 256)), jnp.linspace(LAMBDA_MIN, LAMBDA_MAX, 256)[None, :])
WHITE_SCALE = (1.0 / float(_w.x[0]), 1.0 / float(_w.y[0]), 1.0 / float(_w.z[0]))


def spectral_to_rgb_calibrated(radiance: Array, lam: Array) -> Vec3:
    c = spectral_to_rgb(radiance, lam)
    return Vec3(c.x * WHITE_SCALE[0], c.y * WHITE_SCALE[1], c.z * WHITE_SCALE[2])
