"""Tests for core/curves.py against independent uniform b-spline math.

The reference (cuda/curve.h) pre-transforms control points into polynomial
coefficients; these tests check the composition from_bspline + position4
against the textbook uniform b-spline basis evaluated directly, plus
derivative/extrema/normal identities the reference's geometry relies on.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from optixpathtracer.core import curves
from optixpathtracer.core.math import Vec3, dot, length


def _basis(k: int, u: np.ndarray) -> np.ndarray:
    """Uniform b-spline basis values B_i(u), shape (len(u), k+1)."""
    if k == 1:
        return np.stack([1 - u, u], axis=1)
    if k == 2:
        return np.stack(
            [0.5 * (1 - u) ** 2, 0.5 * (-2 * u * u + 2 * u + 1), 0.5 * u * u],
            axis=1,
        )
    return np.stack(
        [
            (1 - u) ** 3 / 6,
            (3 * u**3 - 6 * u * u + 4) / 6,
            (-3 * u**3 + 3 * u * u + 3 * u + 1) / 6,
            u**3 / 6,
        ],
        axis=1,
    )


def _random_q(k: int, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, k + 1, 4)).astype(np.float32)
    q[:, :, 3] = 0.05 + np.abs(q[:, :, 3]) * 0.3  # positive radii
    return q


@pytest.mark.parametrize("k", [1, 2, 3])
def test_position_matches_bspline_basis(k):
    q = _random_q(k, 16, seed=k)
    p = curves.from_bspline(q)
    u = np.linspace(0.0, 1.0, 9).astype(np.float32)
    for ui in u:
        got = np.asarray(curves.position4(p, float(ui)))
        want = np.einsum("j,njc->nc", _basis(k, np.array([ui]))[0], q)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_export_bspline_roundtrip(k):
    q = _random_q(k, 8, seed=10 + k)
    back = np.asarray(curves.export_bspline(curves.from_bspline(q)))
    np.testing.assert_allclose(back, q, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_velocity_acceleration_are_derivatives(k):
    q = _random_q(k, 8, seed=20 + k)
    p = curves.from_bspline(q)
    eps = 1e-3
    for ui in (0.2, 0.5, 0.8):
        v = np.asarray(curves.velocity4(p, ui))
        fd = (
            np.asarray(curves.position4(p, ui + eps))
            - np.asarray(curves.position4(p, ui - eps))
        ) / (2 * eps)
        np.testing.assert_allclose(v, fd, rtol=5e-3, atol=5e-3)
        a = np.asarray(curves.acceleration4(p, ui))
        fd2 = (
            np.asarray(curves.velocity4(p, ui + eps))
            - np.asarray(curves.velocity4(p, ui - eps))
        ) / (2 * eps)
        np.testing.assert_allclose(a, fd2, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_radius_extrema_bound_dense_sampling(k):
    q = _random_q(k, 32, seed=30 + k)
    p = curves.from_bspline(q)
    us = np.linspace(0.0, 1.0, 257).astype(np.float32)
    samples = np.stack(
        [np.asarray(curves.radius(p, float(u))) for u in us], axis=1
    )  # (N, U)
    rmin = np.asarray(curves.min_radius(p, 0.0, 1.0))
    rmax = np.asarray(curves.max_radius(p, 0.0, 1.0))
    # extrema are exact at polynomial critical points: they must bound every
    # sample and touch the sampled extrema to within sampling resolution
    assert (rmin <= samples.min(axis=1) + 1e-5).all()
    assert (rmax >= samples.max(axis=1) - 1e-5).all()
    np.testing.assert_allclose(rmin, samples.min(axis=1), atol=1e-3)
    np.testing.assert_allclose(rmax, samples.max(axis=1), atol=1e-3)


def test_tangent_is_unit_and_along_axis():
    # straight linear segment along +x
    q = np.zeros((1, 2, 4), np.float32)
    q[0, 1, 0] = 2.0
    q[:, :, 3] = 0.5
    p = curves.from_bspline(q)
    t = curves.curve_tangent(p, 0.5)
    np.testing.assert_allclose(
        np.stack([t.x, t.y, t.z]), [[1.0], [0.0], [0.0]], atol=1e-6
    )


def test_cylinder_surface_normal_is_radial():
    # constant-radius straight cubic curve along x: the offset surface is a
    # cylinder; the normal at any interior point must be radial and the
    # corrected ps must lie exactly at distance r from the axis
    q = np.zeros((1, 4, 4), np.float32)
    q[0, :, 0] = [0.0, 1.0, 2.0, 3.0]
    q[:, :, 3] = 0.25
    p = curves.from_bspline(q)
    ps = Vec3(jnp.array([1.5]), jnp.array([0.3]), jnp.array([0.0]))
    n, ps_fixed = curves.surface_normal(p, 0.5, ps)
    np.testing.assert_allclose(float(length(n)[0]), 1.0, rtol=1e-6)
    np.testing.assert_allclose(
        np.stack([n.x, n.y, n.z]), [[0.0], [1.0], [0.0]], atol=1e-5
    )
    np.testing.assert_allclose(float(ps_fixed.y[0]), 0.25, rtol=1e-5)


def test_cone_surface_normal_tilts_against_growth():
    # linearly growing radius along a straight axis: normal gains a -axis
    # component proportional to dr (cone slant), per curve.h:328
    q = np.zeros((1, 2, 4), np.float32)
    q[0, 1, 0] = 1.0
    q[0, 0, 3] = 0.1
    q[0, 1, 3] = 0.4
    p = curves.from_bspline(q)
    ps = Vec3(jnp.array([0.5]), jnp.array([0.3]), jnp.array([0.0]))
    n, _ = curves.surface_normal(p, 0.5, ps)
    assert float(n.x[0]) < -1e-3  # tilts backward against radius growth
    np.testing.assert_allclose(float(length(n)[0]), 1.0, rtol=1e-6)
    # exact cone normal: slope dr/dx = 0.3 -> axis component -sin(atan(0.3))
    slope = 0.3
    np.testing.assert_allclose(
        float(n.x[0]), -slope / np.sqrt(1 + slope * slope), rtol=1e-4
    )


def test_linear_endcap_normals_are_round():
    q = np.zeros((1, 2, 4), np.float32)
    q[0, 1, 0] = 1.0
    q[:, :, 3] = 0.2
    p = curves.from_bspline(q)
    # hit in front of the u=0 endpoint
    ps0 = Vec3(jnp.array([-0.1]), jnp.array([0.05]), jnp.array([0.0]))
    n0, _ = curves.surface_normal(p, 0.0, ps0)
    assert float(n0.x[0]) < 0.0
    # hit beyond the u=1 endpoint
    ps1 = Vec3(jnp.array([1.1]), jnp.array([0.05]), jnp.array([0.0]))
    n1, _ = curves.surface_normal(p, 1.0, ps1)
    assert float(n1.x[0]) > 0.0


def test_cubic_endcap_normals_are_flat():
    q = np.zeros((1, 4, 4), np.float32)
    q[0, :, 0] = [0.0, 1.0, 2.0, 3.0]
    q[:, :, 3] = 0.2
    p = curves.from_bspline(q)
    ps = Vec3(jnp.array([0.5]), jnp.array([0.1]), jnp.array([0.0]))
    n0, _ = curves.surface_normal(p, 0.0, ps)
    n1, _ = curves.surface_normal(p, 1.0, ps)
    # flat caps: +/- the axis direction (+x here)
    np.testing.assert_allclose(float(n0.x[0]), -1.0, atol=1e-5)
    np.testing.assert_allclose(float(n1.x[0]), 1.0, atol=1e-5)


def test_normal_orthogonal_to_tangent_constant_radius():
    # constant radius (swept sphere / tube): exact normal must be orthogonal
    # to the curve tangent at the corrected hit point
    rng = np.random.default_rng(7)
    q = rng.normal(size=(4, 4, 4)).astype(np.float32)
    q[:, :, 3] = 0.3
    p = curves.from_bspline(q)
    u = 0.37
    c = curves.position3(p, u)
    off = Vec3(
        jnp.asarray(rng.normal(size=4).astype(np.float32)),
        jnp.asarray(rng.normal(size=4).astype(np.float32)),
        jnp.asarray(rng.normal(size=4).astype(np.float32)),
    )
    ps = c + off
    n, ps_fixed = curves.surface_normal(p, u, ps)
    tan = curves.curve_tangent(p, u)
    np.testing.assert_allclose(np.asarray(dot(n, tan)), 0.0, atol=2e-4)
    # corrected point lies on the offset surface: |ps - c| == r
    np.testing.assert_allclose(
        np.asarray(length(ps_fixed - c)), 0.3, rtol=1e-4
    )
