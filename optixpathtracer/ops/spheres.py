"""Sphere primitive set with dense (all-rays x all-spheres) intersection.

Reference: cuda/sphere.cu __intersection__sphere (:37-96) — the custom
primitive the Whitted config traces. A whitted scene's handful of analytic
spheres doesn't need an acceleration structure at all: testing every ray
against every sphere is one dense broadcasted computation with no gathers.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.materials import MaterialTable, build_table
from ..core.math import Vec3

Array = jax.Array

BIG_T = 1e30


class SphereScene(NamedTuple):
    center: Vec3  # (S,)
    radius: Array  # (S,)
    material_id: Array  # (S,) int32
    materials: MaterialTable

    @property
    def count(self) -> int:
        return self.radius.shape[0]


def build_spheres(spheres: list[tuple], materials: list[dict]) -> SphereScene:
    """spheres: list of (center(3,), radius, material_index)."""
    c = np.array([s[0] for s in spheres], np.float32)
    r = np.array([s[1] for s in spheres], np.float32)
    m = np.array([s[2] for s in spheres], np.int32)
    return SphereScene(
        center=Vec3(jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1]), jnp.asarray(c[:, 2])),
        radius=jnp.asarray(r),
        material_id=jnp.asarray(m),
        materials=build_table(materials),
    )


class SphereHitRecord(NamedTuple):
    t: Array  # (N,), BIG_T on miss
    sphere: Array  # (N,) int32, -1 on miss
    nx: Array  # outward geometric normal at hit
    ny: Array
    nz: Array

    @property
    def hit(self) -> Array:
        return self.sphere >= 0


def closest_hit_spheres(
    ss: SphereScene, o: Vec3, d: Vec3, t_min, t_max
) -> SphereHitRecord:
    """Dense closest-hit: (N, S) quadratic solve, argmin over spheres."""
    n = o.x.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    ocx = o.x[:, None] - ss.center.x[None, :]
    ocy = o.y[:, None] - ss.center.y[None, :]
    ocz = o.z[:, None] - ss.center.z[None, :]
    dd = d.x * d.x + d.y * d.y + d.z * d.z  # (N,)
    inv_len = jax.lax.rsqrt(jnp.maximum(dd, 1e-30))[:, None]
    dxn = d.x[:, None] * inv_len
    dyn = d.y[:, None] * inv_len
    dzn = d.z[:, None] * inv_len
    b = ocx * dxn + ocy * dyn + ocz * dzn
    c = ocx * ocx + ocy * ocy + ocz * ocz - ss.radius[None, :] ** 2
    disc = b * b - c
    s = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-b - s) * inv_len
    t2 = (-b + s) * inv_len
    ok1 = (disc > 0) & (t1 > t_min[:, None]) & (t1 < t_max[:, None])
    ok2 = (disc > 0) & (t2 > t_min[:, None]) & (t2 < t_max[:, None])
    t = jnp.where(ok1, t1, jnp.where(ok2, t2, BIG_T))

    j = jnp.argmin(t, axis=1)
    tb = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
    hit = tb < BIG_T
    cx = ss.center.x[j]
    cy = ss.center.y[j]
    cz = ss.center.z[j]
    rad = jnp.maximum(ss.radius[j], 1e-20)
    px = o.x + d.x * tb
    py = o.y + d.y * tb
    pz = o.z + d.z * tb
    return SphereHitRecord(
        t=tb,
        sphere=jnp.where(hit, j.astype(jnp.int32), -1),
        nx=(px - cx) / rad,
        ny=(py - cy) / rad,
        nz=(pz - cz) / rad,
    )


def any_hit_spheres(ss: SphereScene, o: Vec3, d: Vec3, t_min, t_max) -> Array:
    rec = closest_hit_spheres(ss, o, d, t_min, t_max)
    return rec.hit
