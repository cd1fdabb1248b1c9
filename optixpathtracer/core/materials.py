"""Disney/principled material model as a structure-of-arrays table.

Reference: HelloPathtracing_original/Material.h (:11-69) — same parameter set
and defaults (color 0.6, specular 0.5, roughness 1.0, clearcoatGloss 1.0,
eta=0 meaning "infer IoR from specular"), same MATERIAL_FLAG_SHADOW_CATCHER
bit (Material.h:9). Instead of one POD per SBT record, materials live in a
device table indexed by per-triangle material id — hit shading gathers rows,
which replaces OptiX's function-pointer/SBT dispatch with a dense gather.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .math import Vec3

Array = jax.Array

MATERIAL_FLAG_NONE = 0
MATERIAL_FLAG_SHADOW_CATCHER = 1 << 0


class MaterialTable(NamedTuple):
    """One row per material; every field shape (M,) (Vec3 fields are SoA)."""

    color: Vec3
    emission: Vec3
    absorption: Vec3
    eta: Array
    metallic: Array
    subsurface: Array
    specular: Array
    roughness: Array
    specular_tint: Array
    anisotropic: Array
    sheen: Array
    sheen_tint: Array
    clearcoat: Array
    clearcoat_gloss: Array
    transmission: Array
    flags: Array  # int32 bitfield
    texture_id: Array  # int32, -1 = untextured
    rows: Array | None = None  # (M, 24) f32 packed copy of every field —
    #   take() gathers THIS (one wide-row gather) instead of ~17 narrow
    #   4-byte-row gathers. int fields ride as exact small floats.

    @property
    def count(self) -> int:
        return self.eta.shape[0]

    def take(self, idx: Array) -> "MaterialTable":
        """Gather per-hit material rows (the SBT-record fetch equivalent)."""
        if self.rows is None:
            return jax.tree.map(lambda a: a[idx], self)
        # barrier: keep the bulk row gather OUT of the consumer fusion —
        # fused, XLA lowers it to per-element loads
        r = jax.lax.optimization_barrier(self.rows[idx])  # (N, 24) — ONE gather
        v3 = lambda c: Vec3(r[..., c], r[..., c + 1], r[..., c + 2])
        return MaterialTable(
            color=v3(0), emission=v3(3), absorption=v3(6),
            eta=r[..., 9], metallic=r[..., 10], subsurface=r[..., 11],
            specular=r[..., 12], roughness=r[..., 13],
            specular_tint=r[..., 14], anisotropic=r[..., 15],
            sheen=r[..., 16], sheen_tint=r[..., 17], clearcoat=r[..., 18],
            clearcoat_gloss=r[..., 19], transmission=r[..., 20],
            flags=r[..., 21].astype(jnp.int32),
            texture_id=r[..., 22].astype(jnp.int32),
            rows=None,
        )

    def index_of_refraction(self) -> Array:
        """Material.h GetIndexOfRefraction (:39-45): eta==0 infers IoR from specular."""
        inferred = 2.0 / (1.0 - jnp.sqrt(0.08 * self.specular)) - 1.0
        return jnp.where(self.eta == 0.0, inferred, self.eta)


_DEFAULTS = dict(
    color=(0.6, 0.6, 0.6),
    emission=(0.0, 0.0, 0.0),
    absorption=(0.0, 0.0, 0.0),
    eta=0.0,
    metallic=0.0,
    subsurface=0.0,
    specular=0.5,
    roughness=1.0,
    specular_tint=0.0,
    anisotropic=0.0,
    sheen=0.0,
    sheen_tint=0.0,
    clearcoat=0.0,
    clearcoat_gloss=1.0,
    transmission=0.0,
    flags=0,
    texture_id=-1,
)


def make_material(**overrides) -> dict:
    """A single material spec as a plain dict with reference defaults."""
    mat = dict(_DEFAULTS)
    for k, v in overrides.items():
        if k not in mat:
            raise KeyError(f"unknown material field: {k}")
        mat[k] = v
    return mat


def build_table(materials: list[dict]) -> MaterialTable:
    """Pack a list of material dicts into a device SoA table."""
    if not materials:
        materials = [make_material()]

    def vec3_field(name):
        a = np.array([m[name] for m in materials], np.float32)
        return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))

    def f32_field(name):
        return jnp.asarray(np.array([m[name] for m in materials], np.float32))

    def i32_field(name):
        return jnp.asarray(np.array([m[name] for m in materials], np.int32))

    packed = np.zeros((len(materials), 24), np.float32)
    order = [
        "color", "emission", "absorption",  # vec3s at 0/3/6
    ]
    for j, name in enumerate(order):
        packed[:, 3 * j : 3 * j + 3] = np.array(
            [m[name] for m in materials], np.float32
        )
    scalars = [
        "eta", "metallic", "subsurface", "specular", "roughness",
        "specular_tint", "anisotropic", "sheen", "sheen_tint", "clearcoat",
        "clearcoat_gloss", "transmission", "flags", "texture_id",
    ]
    for j, name in enumerate(scalars):
        packed[:, 9 + j] = np.array([m[name] for m in materials], np.float32)

    return MaterialTable(
        rows=jnp.asarray(packed),
        color=vec3_field("color"),
        emission=vec3_field("emission"),
        absorption=vec3_field("absorption"),
        eta=f32_field("eta"),
        metallic=f32_field("metallic"),
        subsurface=f32_field("subsurface"),
        specular=f32_field("specular"),
        roughness=f32_field("roughness"),
        specular_tint=f32_field("specular_tint"),
        anisotropic=f32_field("anisotropic"),
        sheen=f32_field("sheen"),
        sheen_tint=f32_field("sheen_tint"),
        clearcoat=f32_field("clearcoat"),
        clearcoat_gloss=f32_field("clearcoat_gloss"),
        transmission=f32_field("transmission"),
        flags=i32_field("flags"),
        texture_id=i32_field("texture_id"),
    )
