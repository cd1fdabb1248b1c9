"""BSDF visualization harness — lobe images + sample splats.

Realization of the reference's (commented-out) BSDFTest
(HelloPathtracing_original/Disney.cuh:430-503): for a fixed outgoing
direction wo, render a lat-long (probe-UV) image whose pixels hold
(f.x, pdf, 0.5) for the incoming direction wi at that UV, then splat
N BSDF-sampled directions as pure-red pixels. Eyeball check: red dots
should concentrate exactly where the green (pdf) channel is bright.

Unlike the reference's per-pixel CPU loop, the whole image is ONE
vectorized bsdf_eval/bsdf_pdf over all W*H directions, and the splat is a
scatter — no Python loops, jit-friendly.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.materials import build_table, make_material
from ..core.math import Vec3, basis_from_vector, dot
from ..core.rng import RngState, tea
from ..lights.probe import dir_to_uv, uv_to_dir
from . import disney

Array = jax.Array


def bsdf_maps(
    material: dict,
    wo_theta: float = np.pi / 2.05,
    width: int = 512,
    height: int = 256,
    normal=(1.0, 0.0, 0.0),
):
    """Dense lobe maps over the lat-long sphere of incoming directions.

    Returns (f_img, pdf_img): two (height, width) float32 numpy arrays —
    the BSDF's first channel and its solid-angle pdf for every wi, with wo
    fixed at angle wo_theta from the shading normal (Disney.cuh:446-484).
    """
    mat1 = build_table([material]).take(jnp.zeros((1,), jnp.int32))
    n_np = np.asarray(normal, np.float32)
    n_np = n_np / np.linalg.norm(n_np)

    npix = width * height
    mat = jax.tree.map(lambda a: jnp.broadcast_to(a, (npix,) + a.shape[1:]), mat1)
    nv = Vec3(*(jnp.full((npix,), c) for c in n_np))
    tb, bb = basis_from_vector(nv)
    # wo = frame * (0, -sin, cos): in the (u, v, n) frame of the normal
    st, ct = np.sin(wo_theta), np.cos(wo_theta)
    wo = Vec3(
        -st * bb.x + ct * nv.x,
        -st * bb.y + ct * nv.y,
        -st * bb.z + ct * nv.z,
    )

    ii, jj = np.meshgrid(np.arange(width), np.arange(height))
    u = jnp.asarray((ii.ravel() + 0.5) / width, jnp.float32)
    v = jnp.asarray((jj.ravel() + 0.5) / height, jnp.float32)
    wi = uv_to_dir(u, v)

    eta = jnp.ones((npix,))
    albedo = mat.color
    f = disney.bsdf_eval(mat, albedo, eta, eta, nv, wo, wi)
    pdf = disney.bsdf_pdf(mat, eta, eta, nv, wo, wi)
    return (
        np.asarray(f.x).reshape(height, width),
        np.asarray(pdf).reshape(height, width),
    )


def bsdf_sample_splat(
    material: dict,
    wo_theta: float = np.pi / 2.05,
    width: int = 512,
    height: int = 256,
    n_samples: int = 1000,
    normal=(1.0, 0.0, 0.0),
    seed: int = 0,
):
    """Histogram of BSDF-sampled directions on the same lat-long grid.

    Returns an (height, width) int32 numpy array counting how many of
    n_samples BSDF samples landed in each pixel (the reference splats them
    as red dots, Disney.cuh:485-501).
    """
    mat1 = build_table([material]).take(jnp.zeros((1,), jnp.int32))
    n_np = np.asarray(normal, np.float32)
    n_np = n_np / np.linalg.norm(n_np)

    mat = jax.tree.map(lambda a: jnp.broadcast_to(a, (n_samples,) + a.shape[1:]), mat1)
    nv = Vec3(*(jnp.full((n_samples,), c) for c in n_np))
    tb, bb = basis_from_vector(nv)
    st, ct = np.sin(wo_theta), np.cos(wo_theta)
    wo = Vec3(
        -st * bb.x + ct * nv.x,
        -st * bb.y + ct * nv.y,
        -st * bb.z + ct * nv.z,
    )
    eta = jnp.ones((n_samples,))
    state = RngState.seed(
        tea(jnp.arange(n_samples, dtype=jnp.uint32), jnp.uint32(seed))
    )
    _, res = disney.bsdf_sample(mat, eta, eta, tb, bb, nv, wo, state)
    valid = res.pdf > 0.0

    u, v = dir_to_uv(res.light)
    px = jnp.clip((u * width).astype(jnp.int32), 0, width - 1)
    py = jnp.clip((v * height).astype(jnp.int32), 0, height - 1)
    flat = py * width + px
    hist = jnp.zeros((height * width,), jnp.int32).at[flat].add(
        valid.astype(jnp.int32)
    )
    return np.asarray(hist).reshape(height, width)


def bsdf_test_image(
    material: dict | None = None,
    wo_theta: float = np.pi / 2.05,
    width: int = 512,
    height: int = 256,
    n_samples: int = 1000,
    normal=(1.0, 0.0, 0.0),
    seed: int = 0,
) -> np.ndarray:
    """The reference's BSDFTest composite: (f.x, pdf, 0.5) per pixel, with
    sampled directions overwritten as (1, 0, 0). Returns (H, W, 3) float32;
    save with io.image.save_pfm (the reference writes BSDFtest.pfm) or
    tone-map + save_png.

    Default material mirrors the reference's example block
    (Disney.cuh:433-443): near-white, specular 1.0, roughness 0.025.
    """
    if material is None:
        material = make_material(
            color=(0.95, 0.9, 0.9), specular=1.0, roughness=0.025, metallic=0.0
        )
    f_img, pdf_img = bsdf_maps(material, wo_theta, width, height, normal)
    hist = bsdf_sample_splat(
        material, wo_theta, width, height, n_samples, normal, seed
    )
    img = np.stack(
        [f_img, pdf_img, np.full_like(f_img, 0.5)], axis=-1
    ).astype(np.float32)
    img[hist > 0] = (1.0, 0.0, 0.0)
    return img
