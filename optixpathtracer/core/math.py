"""Vector math core (array-native equivalent of the reference's maths.h / sutil/vec_math.h).

Reference: HelloPathtracing_original/maths.h, sutil/vec_math.h.

Design: structure-of-arrays. A `Vec3` holds three independent arrays (x, y, z) of
identical shape. This keeps every vector op a dense elementwise op over flat
arrays, instead of a trailing length-3 axis that strides every load. All
functions are
batched over the leading shape — there is no per-ray Python; `vmap` is never
needed for these.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

Array = jax.Array
Scalar = Union[float, Array]

PI = 3.14159265358979323846
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI
INV_TWO_PI = 1.0 / TWO_PI


class Vec3(NamedTuple):
    """SoA 3-vector batch. Each component is an array of the same shape."""

    x: Array
    y: Array
    z: Array

    # -- constructors ------------------------------------------------------
    @staticmethod
    def full(shape, value: float, dtype=jnp.float32) -> "Vec3":
        v = jnp.full(shape, value, dtype)
        return Vec3(v, v, v)

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "Vec3":
        return Vec3.full(shape, 0.0, dtype)

    @staticmethod
    def ones(shape, dtype=jnp.float32) -> "Vec3":
        return Vec3.full(shape, 1.0, dtype)

    @staticmethod
    def of(x: Scalar, y: Scalar, z: Scalar, dtype=jnp.float32) -> "Vec3":
        return Vec3(jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype))

    @staticmethod
    def from_array(a: Array) -> "Vec3":
        """(..., 3) array -> Vec3."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> Array:
        """Vec3 -> (..., 3) array (host/IO boundary only — avoid in kernels)."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __rtruediv__(self, o):
        return Vec3(o / self.x, o / self.y, o / self.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- shape helpers -----------------------------------------------------
    @property
    def shape(self):
        return jnp.shape(self.x)

    def reshape(self, *shape) -> "Vec3":
        return Vec3(self.x.reshape(*shape), self.y.reshape(*shape), self.z.reshape(*shape))

    def astype(self, dtype) -> "Vec3":
        return Vec3(self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype))

    def broadcast_to(self, shape) -> "Vec3":
        return Vec3(
            jnp.broadcast_to(self.x, shape),
            jnp.broadcast_to(self.y, shape),
            jnp.broadcast_to(self.z, shape),
        )

    def take(self, idx: Array) -> "Vec3":
        """Gather components at integer indices (leading axis)."""
        return Vec3(self.x[idx], self.y[idx], self.z[idx])


# -- free functions --------------------------------------------------------

def dot(a: Vec3, b: Vec3) -> Array:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length_sq(a: Vec3) -> Array:
    return dot(a, a)


def length(a: Vec3) -> Array:
    return jnp.sqrt(length_sq(a))


def normalize(a: Vec3, eps: float = 0.0) -> Vec3:
    inv = jax.lax.rsqrt(jnp.maximum(length_sq(a), eps if eps else 1e-30))
    return a * inv


def safe_normalize(a: Vec3, fallback: Vec3 | None = None) -> Vec3:
    """maths.h SafeNormalize: return `fallback` (default 0) for near-zero vectors."""
    m = length_sq(a)
    ok = m > 0.0
    inv = jax.lax.rsqrt(jnp.where(ok, m, 1.0))
    out = a * inv
    if fallback is None:
        fallback = Vec3.zeros(jnp.shape(m))
    return where(ok, out, fallback)


def where(mask: Array, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def lerp(a, b, t):
    """Works on scalars and Vec3 (matches sutil lerp(a,b,t) = a + t*(b-a))."""
    if isinstance(a, Vec3) or isinstance(b, Vec3):
        return a + (b - a) * t
    return a + (b - a) * t


def clamp(a, lo, hi):
    if isinstance(a, Vec3):
        return Vec3(jnp.clip(a.x, lo, hi), jnp.clip(a.y, lo, hi), jnp.clip(a.z, lo, hi))
    return jnp.clip(a, lo, hi)


def vmin(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.minimum(a.x, b.x), jnp.minimum(a.y, b.y), jnp.minimum(a.z, b.z))


def vmax(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.maximum(a.x, b.x), jnp.maximum(a.y, b.y), jnp.maximum(a.z, b.z))


def min_component(a: Vec3) -> Array:
    return jnp.minimum(a.x, jnp.minimum(a.y, a.z))


def max_component(a: Vec3) -> Array:
    return jnp.maximum(a.x, jnp.maximum(a.y, a.z))


def vabs(a: Vec3) -> Vec3:
    return Vec3(jnp.abs(a.x), jnp.abs(a.y), jnp.abs(a.z))


def vexp(a: Vec3) -> Vec3:
    return Vec3(jnp.exp(a.x), jnp.exp(a.y), jnp.exp(a.z))


def vsqrt(a: Vec3) -> Vec3:
    return Vec3(jnp.sqrt(a.x), jnp.sqrt(a.y), jnp.sqrt(a.z))


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """Mirror direction: i points *toward* the surface (GLSL convention)."""
    return i - n * (2.0 * dot(i, n))


def faceforward(n: Vec3, i: Vec3, nref: Vec3) -> Vec3:
    """sutil faceforward: n flipped so it faces the direction of i."""
    return n * jnp.where(dot(i, nref) > 0.0, 1.0, -1.0)


def luminance(c: Vec3) -> Array:
    """Reference Luminance(): 0.3/0.6/0.1 weights (maths.h:165-168)."""
    return c.x * 0.3 + c.y * 0.6 + c.z * 0.1


def basis_from_vector(n: Vec3) -> tuple[Vec3, Vec3]:
    """Build a right-handed orthonormal basis (u, v) around unit normal n.

    Branchless Frisvad/Duff-style ONB — equivalent role to maths.h
    BasisFromVector (maths.h:94-108) and deviceProgram.cu's Onb (:77-108),
    but numerically stable without data-dependent control flow.
    """
    s = jnp.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    u = Vec3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    v = Vec3(b, s + n.y * n.y * a, -n.y)
    return u, v


def local_to_world(local: Vec3, u: Vec3, v: Vec3, n: Vec3) -> Vec3:
    """Map tangent-space direction (x,y,z) into the (u,v,n) world frame."""
    return u * local.x + v * local.y + n * local.z


def refract(wi: Vec3, n: Vec3, eta: Scalar) -> tuple[Vec3, Array]:
    """Snell refraction of incident direction `wi` (pointing away from surface).

    Matches Disney.cuh Refract (Disney.cuh:35-48): returns (wt, ok) where
    ok=False flags total internal reflection (wt undefined there).
    """
    cos_i = dot(n, wi)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta * eta * sin2_i
    ok = sin2_t < 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    wt = (-wi) * eta + n * (eta * cos_i - cos_t)
    return wt, ok
