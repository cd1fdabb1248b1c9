"""Sample warping library (array-native equivalent of maths.h warps + sample.h).

Reference: HelloPathtracing_original/maths.h UniformSampleSphere (:228),
UniformSampleHemisphere (:241), UniformSampleDisc (:254),
UniformSampleTriangle (:262), CosineSampleHemisphere (:269);
sample.h Stratified/Uniform 1D/2D (:6-45) and the Sample1D/Sample2D strategy
switch (:238-289).

All warps are pure functions of uniforms -> directions, batched over the
leading shape (SoA). The sampling *strategy* (random / stratified /
jittered-uniform) is a config knob instead of a compile-time #define.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from .math import PI, TWO_PI, Vec3
from .rng import RngState, randf, randf2

Array = jnp.ndarray


def uniform_sample_sphere(u1: Array, u2: Array) -> Vec3:
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = TWO_PI * u2
    return Vec3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def uniform_sample_hemisphere(u1: Array, u2: Array) -> Vec3:
    """z in [0,1), pdf = 1/(2*pi). (maths.h:241-252 draws z directly.)"""
    z = u1
    w = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = TWO_PI * u2
    return Vec3(jnp.cos(phi) * w, jnp.sin(phi) * w, z)


def uniform_sample_disc(u1: Array, u2: Array) -> Tuple[Array, Array]:
    r = jnp.sqrt(u1)
    theta = TWO_PI * u2
    return r * jnp.cos(theta), r * jnp.sin(theta)


def uniform_sample_triangle(u1: Array, u2: Array) -> Tuple[Array, Array]:
    r = jnp.sqrt(u1)
    return 1.0 - r, u2 * r


def cosine_sample_hemisphere(u1: Array, u2: Array) -> Vec3:
    """pdf = cos(theta)/pi."""
    x, y = uniform_sample_disc(u1, u2)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - x * x - y * y))
    return Vec3(x, y, z)


def stratified_sample_1d(c: Array, dx: int, state: RngState) -> Tuple[RngState, Array]:
    x = (c % dx).astype(jnp.float32)
    state, j = randf(state)
    return state, (x + j) / dx


def stratified_sample_2d(
    c: Array, dx: int, dy: int, state: RngState
) -> Tuple[RngState, Array, Array]:
    x = (c % dx).astype(jnp.float32)
    y = ((c // dx) % dy).astype(jnp.float32)
    state, j1, j2 = randf2(state)
    return state, (x + j1) / dx, (y + j2) / dy


def uniform_grid_sample_2d(c: Array, dx: int, dy: int) -> Tuple[Array, Array]:
    x = (c % dx).astype(jnp.float32)
    y = ((c // dx) % dy).astype(jnp.float32)
    return x / dx, y / dy


def best_candidate_blue_noise(n_points: int, dim: int = 2, candidates: int = 16, seed: int = 0):
    """Host-side best-candidate blue-noise point set (sample.h BestCandidate
    :80-131 semantics): each point is the candidate farthest (toroidal) from
    the existing set. Returns (n_points, dim) float32 in [0, 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pts = np.empty((n_points, dim), np.float32)
    pts[0] = rng.random(dim)
    for i in range(1, n_points):
        cand = rng.random((candidates, dim)).astype(np.float32)
        delta = np.abs(cand[:, None, :] - pts[None, :i, :])
        delta = np.minimum(delta, 1.0 - delta)  # toroidal wrap
        d = (delta**2).sum(-1).min(axis=1)
        pts[i] = cand[int(d.argmax())]
    return pts


def projective_blue_noise(n_points: int, dim: int = 2, candidates: int = 16, seed: int = 0):
    """Projective variant (sample.h ProjectiveBlueNoise :133-214): candidates
    maximize the minimum over full-D distance AND each 1-D projection."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pts = np.empty((n_points, dim), np.float32)
    pts[0] = rng.random(dim)
    for i in range(1, n_points):
        cand = rng.random((candidates, dim)).astype(np.float32)
        delta = np.abs(cand[:, None, :] - pts[None, :i, :])
        delta = np.minimum(delta, 1.0 - delta)
        full = (delta**2).sum(-1).min(axis=1) / dim
        proj = (delta**2).min(axis=1).min(axis=-1)  # worst 1-D projection
        score = np.minimum(full, proj)
        pts[i] = cand[int(score.argmax())]
    return pts


def power_heuristic(nf: Array, f_pdf: Array, ng: Array, g_pdf: Array) -> Array:
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / jnp.maximum(f * f + g * g, 1e-20)


def balance_heuristic(nf: Array, f_pdf: Array, ng: Array, g_pdf: Array) -> Array:
    """The reference's MIS weight shape (deviceProgram.cu:279-287)."""
    f = nf * f_pdf
    g = ng * g_pdf
    return f / jnp.maximum(f + g, 1e-20)
