"""B-spline curve-primitive helpers (array-native equivalent of cuda/curve.h).

Reference spec: /root/reference/cuda/curve.h:37-396 — per-segment polynomial
interpolators (linear/quadratic/cubic uniform b-splines with per-control-point
radius in the w channel), radius extrema over a parameter interval, and the
curve-surface normal / tangent reconstruction used by OptiX curve primitives.
The reference evaluates one segment per thread; here every function is batched
over N segments x arbitrary u-shapes as dense elementwise ops (no vmap, no per-segment
Python), following the SoA conventions of core/math.py.

Data model: a segment batch is one array `p` of shape (N, K, 4) holding the
PRE-TRANSFORMED polynomial coefficients (the reference's `p[]` member), where
K-1 is the degree; columns are [x, y, z, radius]. Build it from raw uniform
b-spline control points with `from_bspline` (reference initializeFromBSpline),
and invert with `export_bspline` (reference export2BSpline).

The reference ships no curve intersector (OptiX hardware supplies it) and no
app uses curve.h; these helpers complete the parity surface and serve any
future curve-primitive backend.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .math import Vec3, dot, length, normalize

Array = jax.Array

# normal-reconstruction variants (reference curve.h:269-271)
NORMAL_CYLINDRICAL = 0  # correct if radius' == 0
NORMAL_CONIC = 1  # correct if curve'' == 0
NORMAL_EXACT = 2  # bona fide offset-surface normal


def _degree(p: Array) -> int:
    k = p.shape[-2] - 1
    if k not in (1, 2, 3):
        raise ValueError(f"curve batch must have 2..4 control rows, got {k + 1}")
    return k


def from_bspline(q: Array) -> Array:
    """Pre-transform uniform b-spline control points for fast evaluation.

    q: (N, K, 4) with K in {2, 3, 4} (degree 1/2/3). Matches the reference's
    initialize / initializeFromBSpline (curve.h:42-46, 85-91, 141-148).
    """
    q = jnp.asarray(q, jnp.float32)
    k = _degree(q)
    if k == 1:
        return jnp.stack([q[:, 0], q[:, 1] - q[:, 0]], axis=1)
    if k == 2:
        return jnp.stack(
            [
                0.5 * (q[:, 1] + q[:, 0]),
                q[:, 1] - q[:, 0],
                0.5 * q[:, 0] - q[:, 1] + 0.5 * q[:, 2],
            ],
            axis=1,
        )
    return jnp.stack(
        [
            (q[:, 2] + q[:, 0]) / 6.0 + (4.0 / 6.0) * q[:, 1],
            q[:, 2] - q[:, 0],
            q[:, 2] - q[:, 1],
            q[:, 3] - q[:, 1],
        ],
        axis=1,
    )


def export_bspline(p: Array) -> Array:
    """Inverse of `from_bspline` (reference export2BSpline, curve.h:93-98,
    150-157). Returns the original (N, K, 4) b-spline control points."""
    p = jnp.asarray(p, jnp.float32)
    k = _degree(p)
    if k == 1:
        return jnp.stack([p[:, 0], p[:, 0] + p[:, 1]], axis=1)
    if k == 2:
        return jnp.stack(
            [
                p[:, 0] - 0.5 * p[:, 1],
                p[:, 0] + 0.5 * p[:, 1],
                p[:, 0] + 1.5 * p[:, 1] + 2.0 * p[:, 2],
            ],
            axis=1,
        )
    return jnp.stack(
        [
            p[:, 0] + (4.0 * p[:, 2] - 5.0 * p[:, 1]) / 6.0,
            p[:, 0] + (p[:, 1] - 2.0 * p[:, 2]) / 6.0,
            p[:, 0] + (p[:, 1] + 4.0 * p[:, 2]) / 6.0,
            p[:, 0] + p[:, 3] + (p[:, 1] - 2.0 * p[:, 2]) / 6.0,
        ],
        axis=1,
    )


def _u(u, n: int) -> Array:
    return jnp.broadcast_to(jnp.asarray(u, jnp.float32), (n,))


def position4(p: Array, u) -> Array:
    """(N, 4) curve point [x, y, z, radius] at parameter u (curve.h position4)."""
    k = _degree(p)
    uu = _u(u, p.shape[0])[:, None]
    if k == 1:
        return p[:, 0] + uu * p[:, 1]
    if k == 2:
        return p[:, 0] + uu * (p[:, 1] + uu * p[:, 2])
    # cubic basis in the reference's pre-transformed coordinates
    # (curve.h:159-175): q = (u^3/6 + (u - u^2)/2, u^2 - 4 u^3/6, u^3/6)
    u2 = uu * uu
    u3 = (1.0 / 6.0) * u2 * uu
    return (
        p[:, 0]
        + (u3 + 0.5 * (uu - u2)) * p[:, 1]
        + (u2 - 4.0 * u3) * p[:, 2]
        + u3 * p[:, 3]
    )


def velocity4(p: Array, u) -> Array:
    """(N, 4) first derivative d/du of position4 (curve.h velocity4).

    Cubic parameters are nudged off the exact 0/1 endpoints, as the reference
    does to sidestep triple-knot degeneracy (curve.h:239-248)."""
    k = _degree(p)
    uu = _u(u, p.shape[0])[:, None]
    if k == 1:
        return jnp.broadcast_to(p[:, 1], (p.shape[0], 4))
    if k == 2:
        return p[:, 1] + 2.0 * uu * p[:, 2]
    uu = jnp.clip(uu, 1e-6, 1.0 - 1e-6)
    v = 1.0 - uu
    return 0.5 * v * v * p[:, 1] + 2.0 * v * uu * p[:, 2] + 0.5 * uu * uu * p[:, 3]


def acceleration4(p: Array, u) -> Array:
    """(N, 4) second derivative (curve.h acceleration4)."""
    k = _degree(p)
    uu = _u(u, p.shape[0])[:, None]
    if k == 1:
        return jnp.zeros((p.shape[0], 4), jnp.float32)
    if k == 2:
        return jnp.broadcast_to(2.0 * p[:, 2], (p.shape[0], 4))
    return 2.0 * p[:, 2] - p[:, 1] + (p[:, 1] - 4.0 * p[:, 2] + p[:, 3]) * uu


def position3(p: Array, u) -> Vec3:
    q = position4(p, u)
    return Vec3(q[:, 0], q[:, 1], q[:, 2])


def velocity3(p: Array, u) -> Vec3:
    q = velocity4(p, u)
    return Vec3(q[:, 0], q[:, 1], q[:, 2])


def acceleration3(p: Array, u) -> Vec3:
    q = acceleration4(p, u)
    return Vec3(q[:, 0], q[:, 1], q[:, 2])


def radius(p: Array, u) -> Array:
    """(N,) interpolated curve radius (curve.h radius)."""
    return position4(p, u)[:, 3]


def derivative_of_radius(p: Array, u) -> Array:
    return velocity4(p, u)[:, 3]


def _radius_extremum_candidates(p: Array, u1, u2) -> Array:
    """(N, R) parameter values to probe for radius extrema over [u1, u2]:
    the endpoints plus the clamped interior critical points of the radius
    polynomial (curve.h min_radius/max_radius, :53-63, 108-120, 182-226)."""
    k = _degree(p)
    n = p.shape[0]
    u1 = _u(u1, n)
    u2 = _u(u2, n)
    if k == 1:
        return jnp.stack([u1, u2], axis=1)
    if k == 2:
        # radius' = p1.w + 2 u p2.w -> root at -p1.w / (2 p2.w)
        den = 2.0 * p[:, 2, 3]
        safe = jnp.where(jnp.abs(den) > 1e-30, den, 1.0)
        root = jnp.where(
            jnp.abs(den) > 1e-30, jnp.clip(-p[:, 1, 3] / safe, u1, u2), u1
        )
        return jnp.stack([u1, u2, root], axis=1)
    # cubic: radius' proportional to a + 2 b u - c u^2 (reference's naming)
    a = p[:, 1, 3]
    b = 2.0 * p[:, 2, 3] - p[:, 1, 3]
    c = 4.0 * p[:, 2, 3] - p[:, 1, 3] - p[:, 3, 3]
    lin = jnp.abs(c) < 1e-5
    safe_b = jnp.where(jnp.abs(b) > 1e-30, b, 1.0)
    root_lin = jnp.where(jnp.abs(b) > 1e-30, -0.5 * a / safe_b, u1)
    det = jnp.sqrt(jnp.maximum(b * b + a * c, 0.0))
    safe_c = jnp.where(lin, 1.0, c)
    r1 = jnp.where(lin, root_lin, (b + det) / safe_c)
    r2 = jnp.where(lin, root_lin, (b - det) / safe_c)
    return jnp.stack(
        [u1, u2, jnp.clip(r1, u1, u2), jnp.clip(r2, u1, u2)], axis=1
    )


def min_radius(p: Array, u1, u2) -> Array:
    """(N,) exact minimum of the radius over [u1, u2]."""
    cand = _radius_extremum_candidates(p, u1, u2)  # (N, R)
    vals = jnp.stack([radius(p, cand[:, j]) for j in range(cand.shape[1])], axis=1)
    return jnp.min(vals, axis=1)


def max_radius(p: Array, u1, u2) -> Array:
    """(N,) exact maximum of the radius over [u1, u2]."""
    cand = _radius_extremum_candidates(p, u1, u2)
    vals = jnp.stack([radius(p, cand[:, j]) for j in range(cand.shape[1])], axis=1)
    return jnp.max(vals, axis=1)


def curve_tangent(p: Array, u) -> Vec3:
    """Unit tangent along the curve axis (curve.h curveTangent, :391-396)."""
    return normalize(velocity3(p, u))


def surface_normal(
    p: Array, u, ps: Vec3, kind: int = NORMAL_EXACT
) -> tuple[Vec3, Vec3]:
    """Object-space surface normal of the swept-sphere curve primitive.

    Batched re-derivation of curve.h surfaceNormal (:285-380). `ps` is the
    near-surface hit point (ray origin + t * dir); it is projected exactly
    onto the offset surface and the corrected point is returned alongside the
    normal — the reference mutates `ps` in place.

    Endcap handling matches the reference: parameters at u==0 / u==1 use flat
    endcap normals (-velocity / +velocity) for degree >= 2 and round endcap
    normals (ps - endpoint) for linear segments.
    """
    k = _degree(p)
    n = p.shape[0]
    uu = _u(u, n)

    p4 = position4(p, uu)
    c = Vec3(p4[:, 0], p4[:, 1], p4[:, 2])
    r = p4[:, 3]
    d4 = velocity4(p, uu)
    d = Vec3(d4[:, 0], d4[:, 1], d4[:, 2])
    dr = d4[:, 3]
    dd = dot(d, d)

    # project ps to the plane(c, d), then drop it radially to the surface
    o1 = ps - c
    o1 = o1 - d * (dot(o1, d) / dd)
    o1_len = jnp.maximum(length(o1), 1e-30)
    o1 = o1 * (r / o1_len)
    ps_fixed = c + o1

    if kind == NORMAL_CYLINDRICAL:
        body = o1
    elif kind == NORMAL_CONIC or k == 1:
        body = o1 * dd - d * (dr * r)
    else:
        dd_adj = dd - dot(acceleration3(p, uu), o1)
        body = o1 * dd_adj - d * (dr * r)

    at0 = uu == 0.0
    at1 = uu >= 1.0
    if k == 1:
        # round endcaps: normal points from the segment endpoint to ps
        p0 = Vec3(p[:, 0, 0], p[:, 0, 1], p[:, 0, 2])
        p1 = p0 + Vec3(p[:, 1, 0], p[:, 1, 1], p[:, 1, 2])
        cap0 = ps - p0
        cap1 = ps - p1
    else:
        # flat endcaps: +/- the axis tangent
        v0 = velocity3(p, jnp.zeros_like(uu))
        v1 = velocity3(p, jnp.ones_like(uu))
        cap0 = -v0
        cap1 = v1

    def sel(a: Vec3, b: Vec3, m) -> Vec3:
        return Vec3(
            jnp.where(m, a.x, b.x), jnp.where(m, a.y, b.y), jnp.where(m, a.z, b.z)
        )

    normal = sel(cap0, sel(cap1, body, at1), at0)
    ps_out = sel(ps, sel(ps, ps_fixed, at1), at0)
    return normalize(normal), ps_out
