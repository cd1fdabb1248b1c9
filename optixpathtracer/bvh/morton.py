"""Morton (Z-order) codes + integer bit utilities (jnp and numpy variants).

Part of the replacement for the reference's hardware BVH build
(optixAccelBuild, HelloPathtracing_original/SimplePathtracer.cpp:457-601).
30-bit codes: 10 bits per axis, centroids quantized against the scene AABB.
The numpy variants back the host-side scene build (bvh/lbvh.py), which runs
in pure numpy so it can never accidentally dispatch eager ops through a
remote accelerator backend.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array
_U32 = jnp.uint32


def np_morton_codes(centroids: np.ndarray) -> np.ndarray:
    """(T, 3) float centroids -> (T,) uint32 30-bit Morton codes (numpy)."""
    c = np.asarray(centroids, np.float64)
    lo = c.min(axis=0)
    extent = np.maximum(c.max(axis=0) - lo, 1e-9)
    q = np.clip(((c - lo) / extent * 1024.0), 0.0, 1023.0).astype(np.uint32)

    def spread(v):
        v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
        v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
        v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
        v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
        return v

    return (
        (spread(q[:, 0]) << np.uint32(2))
        | (spread(q[:, 1]) << np.uint32(1))
        | spread(q[:, 2])
    )


def np_clz32(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of uint32 lanes (32 for 0), numpy."""
    x = x.astype(np.uint32)
    x = x | (x >> np.uint32(1))
    x = x | (x >> np.uint32(2))
    x = x | (x >> np.uint32(4))
    x = x | (x >> np.uint32(8))
    x = x | (x >> np.uint32(16))
    y = ~x
    y = y - ((y >> np.uint32(1)) & np.uint32(0x55555555))
    y = (y & np.uint32(0x33333333)) + ((y >> np.uint32(2)) & np.uint32(0x33333333))
    y = (y + (y >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((y * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int32)


def expand_bits_10(v: Array) -> Array:
    """Spread the low 10 bits of each lane out to every third bit."""
    v = v.astype(_U32)
    v = (v * _U32(0x00010001)) & _U32(0xFF0000FF)
    v = (v * _U32(0x00000101)) & _U32(0x0F00F00F)
    v = (v * _U32(0x00000011)) & _U32(0xC30C30C3)
    v = (v * _U32(0x00000005)) & _U32(0x49249249)
    return v


def morton3d(x: Array, y: Array, z: Array) -> Array:
    """30-bit Morton code from coordinates already scaled to [0, 1024)."""
    xi = jnp.clip(x, 0.0, 1023.0).astype(_U32)
    yi = jnp.clip(y, 0.0, 1023.0).astype(_U32)
    zi = jnp.clip(z, 0.0, 1023.0).astype(_U32)
    return (expand_bits_10(xi) << _U32(2)) | (expand_bits_10(yi) << _U32(1)) | expand_bits_10(zi)


def popcount32(x: Array) -> Array:
    x = x.astype(_U32)
    x = x - ((x >> _U32(1)) & _U32(0x55555555))
    x = (x & _U32(0x33333333)) + ((x >> _U32(2)) & _U32(0x33333333))
    x = (x + (x >> _U32(4))) & _U32(0x0F0F0F0F)
    return ((x * _U32(0x01010101)) >> _U32(24)).astype(jnp.int32)


def clz32(x: Array) -> Array:
    """Count leading zeros (32 for x == 0)."""
    x = x.astype(_U32)
    x = x | (x >> _U32(1))
    x = x | (x >> _U32(2))
    x = x | (x >> _U32(4))
    x = x | (x >> _U32(8))
    x = x | (x >> _U32(16))
    return popcount32(~x)


def morton_codes(cx: Array, cy: Array, cz: Array) -> Array:
    """Morton codes for centroid arrays, normalized by their joint AABB."""
    mins = jnp.stack([cx.min(), cy.min(), cz.min()])
    maxs = jnp.stack([cx.max(), cy.max(), cz.max()])
    extent = jnp.maximum(maxs - mins, 1e-9)
    qx = (cx - mins[0]) / extent[0] * 1024.0
    qy = (cy - mins[1]) / extent[1] * 1024.0
    qz = (cz - mins[2]) / extent[2] * 1024.0
    return morton3d(qx, qy, qz)
