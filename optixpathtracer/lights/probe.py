"""HDR environment probe with 2D luminance-CDF importance sampling.

Reference: HelloPathtracing_original/Probe.h BuildCDF (:29-77) — per-row
conditional pdf/cdf over luminance plus a row marginal — and Probe.cuh device
sampling: ProbeDirToUV (:38-46), ProbeUVToDir (:48-58), ProbeEval (:61-67),
ProbePdf with the sin(theta) Jacobian (:69-93), and ProbeSample via CDF binary
search (:119-169).

Mapping: BuildCDF becomes two jnp.cumsum calls; the per-ray binary
search becomes a batched jnp.searchsorted (the row CDFs are rows of one 2D
array, searched with vmap-free gather arithmetic); evaluation is a gather.
The lat-long parameterization and pdf conventions match the reference exactly
so MIS weights agree.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math import INV_PI, PI, TWO_PI, Vec3, luminance
from ..core.rng import RngState, randf2

Array = jax.Array


class Probe(NamedTuple):
    """Device-resident probe (SoA image + sampling tables)."""

    r: Array  # (H, W) float32 radiance
    g: Array
    b: Array
    pdf_x: Array  # (H, W) conditional pdf of column given row
    cdf_x: Array  # (H, W) inclusive cdf per row
    pdf_y: Array  # (H,) marginal pdf of row
    cdf_y: Array  # (H,) inclusive cdf
    offset: Vec3  # world-space warp offset (Probe.h:15, unused by the apps)
    rgbp: Array | None = None  # (H*W, 4) wide rows [r, g, b, joint pdf
    #   pdf_x*pdf_y] — texel lookups gather THIS (one wide-row gather instead
    #   of four narrow ones)

    @property
    def width(self) -> int:
        return self.r.shape[1]

    @property
    def height(self) -> int:
        return self.r.shape[0]


def build_probe(
    image: np.ndarray | Array,
    offset=(0.0, 0.0, 0.0),
    gaussian_prefilter: bool = False,
) -> Probe:
    """BuildCDF equivalent: (H, W, 3) float32 HDR image -> Probe tables.

    gaussian_prefilter: smooth the luminance with a 3x3 binomial kernel
    before building the CDF (OptixUtils/Texture.cpp:5-40) — de-spikes the
    importance sampling around single hot texels. The pdf tables describe
    the FILTERED density actually sampled, so the estimator stays unbiased;
    only sampling quality changes.
    """
    img = jnp.asarray(image, jnp.float32)
    h, w = img.shape[:2]
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    weight = luminance(Vec3(r, g, b))  # (H, W), reference luminance weights
    if gaussian_prefilter:
        # 3x3 binomial, wrapping in longitude, clamping at the poles
        wx = jnp.roll(weight, 1, axis=1) + 2.0 * weight + jnp.roll(weight, -1, axis=1)
        up = jnp.concatenate([wx[:1], wx[:-1]], axis=0)
        dn = jnp.concatenate([wx[1:], wx[-1:]], axis=0)
        weight = (up + 2.0 * wx + dn) * (1.0 / 16.0)

    row_total = jnp.sum(weight, axis=1, keepdims=True)  # (H, 1)
    safe_row = jnp.maximum(row_total, 1e-20)
    pdf_x = weight / safe_row
    cdf_x = jnp.cumsum(weight, axis=1) / safe_row

    col_weight = row_total[:, 0]  # (H,)
    total = jnp.maximum(jnp.sum(col_weight), 1e-20)
    pdf_y = col_weight / total
    cdf_y = jnp.cumsum(col_weight) / total

    off = np.asarray(offset, np.float32)
    joint = pdf_x * pdf_y[:, None]  # (H, W) texel pdf over the 2D table
    rgbp = jnp.stack(
        [r.reshape(-1), g.reshape(-1), b.reshape(-1), joint.reshape(-1)], axis=1
    )
    return Probe(
        r=r,
        g=g,
        b=b,
        pdf_x=pdf_x,
        cdf_x=cdf_x,
        pdf_y=pdf_y,
        cdf_y=cdf_y,
        offset=Vec3(jnp.float32(off[0]), jnp.float32(off[1]), jnp.float32(off[2])),
        rgbp=rgbp,
    )


def dir_to_uv(d: Vec3) -> tuple[Array, Array]:
    """Lat-long mapping with the reference's axis convention (Probe.cuh:38-46):
    theta from +Y, phi = atan2(z, x), u = (pi + phi) / 2pi."""
    theta = jnp.arccos(jnp.clip(d.y, -1.0, 1.0))
    phi = jnp.where((d.x == 0.0) & (d.z == 0.0), 0.0, jnp.arctan2(d.z, d.x))
    u = (PI + phi) * INV_PI * 0.5
    v = theta * INV_PI
    return u, v


def uv_to_dir(u: Array, v: Array) -> Vec3:
    """Inverse mapping (Probe.cuh:48-58): note the negated x/z sin terms."""
    theta = v * PI
    phi = u * TWO_PI
    st = jnp.sin(theta)
    return Vec3(-st * jnp.cos(phi), jnp.cos(theta), -st * jnp.sin(phi))


def probe_eval(p: Probe, u: Array, v: Array) -> Vec3:
    """Nearest-texel radiance lookup (ProbeEval, Probe.cuh:61-67)."""
    x = jnp.clip((u * p.width).astype(jnp.int32), 0, p.width - 1)
    y = jnp.clip((v * p.height).astype(jnp.int32), 0, p.height - 1)
    if p.rgbp is None:
        return Vec3(p.r[y, x], p.g[y, x], p.b[y, x])
    row = p.rgbp[y * p.width + x]  # ONE wide-row gather
    return Vec3(row[..., 0], row[..., 1], row[..., 2])


def probe_eval_dir(p: Probe, d: Vec3) -> Vec3:
    u, v = dir_to_uv(d)
    return probe_eval(p, u, v)


def probe_pdf(p: Probe, d: Vec3) -> Array:
    """Solid-angle pdf of sampling direction d (ProbePdf, Probe.cuh:69-93)."""
    u, v = dir_to_uv(d)
    col = jnp.clip((u * p.width).astype(jnp.int32), 0, p.width - 1)
    row = jnp.clip((v * p.height).astype(jnp.int32), 0, p.height - 1)
    if p.rgbp is None:
        pdf = p.pdf_x[row, col] * p.pdf_y[row]
    else:
        pdf = p.rgbp[row * p.width + col][..., 3]
    sin_theta = jnp.sin(v * PI)
    scale = p.width * p.height / (2.0 * PI * PI * jnp.maximum(jnp.abs(sin_theta), 1e-8))
    return jnp.where(jnp.abs(sin_theta) < 1e-4, 0.0, pdf * scale)


def probe_sample_texel(
    p: Probe, state: RngState, u12=None
) -> tuple[RngState, Vec3, Vec3, Array, Array, Array]:
    """probe_sample that also returns the chosen (row, col) texel (for tests).

    u12 (optional (u1, u2)): caller-supplied uniforms replacing the internal
    randf2 draw — the engine's stratified/blue-noise sampling strategy
    (RenderConfig.sampling; reference sample.h:238-289 Sample2D) feeds its
    low-discrepancy pair through here. The state is NOT advanced then (the
    caller drew its jitter from the same stream)."""
    if u12 is None:
        state, r1, r2 = randf2(state)
    else:
        r1, r2 = u12
    # lower_bound == searchsorted(side='left') == count of cdf entries < r.
    # A batched dense compare+sum instead of binary search: searchsorted
    # lowers to a log(W) while-loop of narrow per-ray gathers; the
    # (N, H)+(N, W) compare is one dense fusion.
    row = jnp.sum(
        p.cdf_y < r1[..., None], axis=-1, dtype=jnp.int32
    )
    row = jnp.clip(row, 0, p.height - 1)

    # optimization_barrier keeps the row gather OUT of the compare fusion:
    # fused, XLA lowers it to per-element loads; as a standalone bulk
    # gather the (N, W) rows move as whole rows
    rows_cdf = jax.lax.optimization_barrier(p.cdf_x[row])  # (N, W)
    col = jnp.sum(rows_cdf < r2[..., None], axis=-1, dtype=jnp.int32)
    col = jnp.clip(col, 0, p.width - 1)

    if p.rgbp is None:
        color = Vec3(p.r[row, col], p.g[row, col], p.b[row, col])
        pdf = p.pdf_x[row, col] * p.pdf_y[row]
    else:
        texel = jax.lax.optimization_barrier(p.rgbp[row * p.width + col])
        color = Vec3(texel[..., 0], texel[..., 1], texel[..., 2])
        pdf = texel[..., 3]

    u = col.astype(jnp.float32) / p.width
    v = row.astype(jnp.float32) / p.height
    sin_theta = jnp.sin(v * PI)
    scale = p.width * p.height / (2.0 * PI * PI * jnp.maximum(sin_theta, 1e-8))
    pdf = jnp.where(sin_theta == 0.0, 0.0, pdf * scale)
    return state, uv_to_dir(u, v), color, pdf, row, col


def probe_sample(
    p: Probe, state: RngState, u12=None
) -> tuple[RngState, Vec3, Vec3, Array]:
    """Draw (direction, radiance, pdf) by inverse-CDF (ProbeSample, Probe.cuh:138-169).

    Batched over the RNG state's shape. The row search is a searchsorted over
    the marginal; the column search indexes the per-row CDF matrix.
    u12: optional caller-supplied uniform pair (see probe_sample_texel).
    """
    state, d, color, pdf, _, _ = probe_sample_texel(p, state, u12=u12)
    return state, d, color, pdf


def make_test_probe(width: int = 128, height: int = 64, axis=(0.0, 1.0, 0.0), power: float = 10.0) -> Probe:
    """Disc-light test probe (semantics of the commented ProbeCreateTest,
    Probe.cuh:207-242): bright disc around `axis`, black elsewhere."""
    us, vs = np.meshgrid(
        (np.arange(width) + 0.5) / width, (np.arange(height) + 0.5) / height
    )
    theta = vs * np.pi
    phi = us * 2 * np.pi
    st = np.sin(theta)
    d = np.stack([-st * np.cos(phi), np.cos(theta), -st * np.sin(phi)], -1)
    a = np.asarray(axis, np.float32)
    a = a / np.linalg.norm(a)
    mask = (d @ a) >= 0.95
    img = np.where(mask[..., None], power, 0.0).astype(np.float32)
    img = np.repeat(img[..., :1], 3, axis=-1) + 1e-4  # tiny floor avoids 0-row cdfs
    return build_probe(img)
