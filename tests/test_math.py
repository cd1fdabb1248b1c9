import numpy as np
import jax.numpy as jnp

from optixpathtracer.core import math as m


def _rand_vec3(rng, n):
    a = rng.normal(size=(n, 3)).astype(np.float32)
    return m.Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2])), a


def test_dot_cross_match_numpy(rng):
    va, a = _rand_vec3(rng, 128)
    vb, b = _rand_vec3(rng, 128)
    np.testing.assert_allclose(np.asarray(m.dot(va, vb)), np.sum(a * b, -1), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(m.cross(va, vb).to_array()), np.cross(a, b), rtol=1e-4, atol=1e-5)


def test_normalize_unit_length(rng):
    v, _ = _rand_vec3(rng, 64)
    n = m.normalize(v)
    np.testing.assert_allclose(np.asarray(m.length(n)), 1.0, rtol=1e-5)


def test_safe_normalize_zero_vector():
    v = m.Vec3.zeros((4,))
    out = m.safe_normalize(v)
    assert np.all(np.asarray(out.to_array()) == 0.0)


def test_basis_orthonormal(rng):
    v, _ = _rand_vec3(rng, 256)
    n = m.normalize(v)
    u, w = m.basis_from_vector(n)
    np.testing.assert_allclose(np.asarray(m.dot(u, w)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(m.dot(u, n)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(m.dot(w, n)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(m.length(u)), 1.0, rtol=1e-5)
    # right-handed: u x v == n
    np.testing.assert_allclose(
        np.asarray(m.cross(u, w).to_array()), np.asarray(n.to_array()), atol=1e-5
    )


def test_reflect():
    i = m.Vec3.of([1.0], [-1.0], [0.0])
    n = m.Vec3.of([0.0], [1.0], [0.0])
    r = m.reflect(m.normalize(i), n)
    np.testing.assert_allclose(np.asarray(r.to_array())[0], [2**-0.5, 2**-0.5, 0.0], atol=1e-6)


def test_refract_matches_snell():
    # straight-on ray refracts straight through
    wi = m.Vec3.of([0.0], [1.0], [0.0])
    n = m.Vec3.of([0.0], [1.0], [0.0])
    wt, ok = m.refract(wi, n, 1.0 / 1.5)
    assert bool(np.asarray(ok)[0])
    np.testing.assert_allclose(np.asarray(wt.to_array())[0], [0.0, -1.0, 0.0], atol=1e-6)


def test_refract_tir():
    # grazing ray from dense to sparse medium: total internal reflection
    ang = np.deg2rad(80.0)
    wi = m.Vec3.of([np.sin(ang)], [np.cos(ang)], [0.0])
    n = m.Vec3.of([0.0], [1.0], [0.0])
    _, ok = m.refract(wi, n, 1.5)
    assert not bool(np.asarray(ok)[0])


def test_faceforward():
    n = m.Vec3.of([0.0], [1.0], [0.0])
    i_up = m.Vec3.of([0.0], [1.0], [0.0])
    i_dn = m.Vec3.of([0.0], [-1.0], [0.0])
    assert np.asarray(m.faceforward(n, i_up, n).y)[0] == 1.0
    assert np.asarray(m.faceforward(n, i_dn, n).y)[0] == -1.0


def test_luminance_weights():
    c = m.Vec3.of([1.0], [1.0], [1.0])
    np.testing.assert_allclose(np.asarray(m.luminance(c))[0], 1.0, rtol=1e-6)
