import numpy as np
import jax.numpy as jnp

from optixpathtracer.core import rng as R


def test_tea_matches_reference_scalar():
    # independent reference implementation of tea<4> in python ints
    def tea_ref(v0, v1):
        s = 0
        M = 0xFFFFFFFF
        for _ in range(4):
            s = (s + 0x9E3779B9) & M
            v0 = (v0 + ((((v1 << 4) & M) + 0xA341316C) ^ ((v1 + s) & M) ^ ((v1 >> 5) + 0xC8013EA4))) & M
            v1 = (v1 + ((((v0 << 4) & M) + 0xAD90777D) ^ ((v0 + s) & M) ^ ((v0 >> 5) + 0x7E95761E))) & M
        return v0

    vals = [(0, 0), (1, 0), (123456, 7), (2**31, 99)]
    v0 = jnp.asarray(np.array([a for a, _ in vals], np.uint32))
    v1 = jnp.asarray(np.array([b for _, b in vals], np.uint32))
    got = np.asarray(R.tea(v0, v1))
    want = np.array([tea_ref(a, b) for a, b in vals], np.uint32)
    np.testing.assert_array_equal(got, want)


def test_randf_range_and_determinism():
    st = R.RngState.for_pixels(jnp.arange(1000, dtype=jnp.uint32), 3)
    st2 = R.RngState.for_pixels(jnp.arange(1000, dtype=jnp.uint32), 3)
    _, u = R.randf(st)
    _, u2 = R.randf(st2)
    u = np.asarray(u)
    assert np.all(u >= 0.0) and np.all(u <= 0.999999)
    np.testing.assert_array_equal(u, np.asarray(u2))


def test_stream_decorrelation():
    # different subframes produce different values for the same pixel
    st_a = R.RngState.for_pixels(jnp.arange(512, dtype=jnp.uint32), 0)
    st_b = R.RngState.for_pixels(jnp.arange(512, dtype=jnp.uint32), 1)
    _, ua = R.randf(st_a)
    _, ub = R.randf(st_b)
    assert np.mean(np.asarray(ua) == np.asarray(ub)) < 0.01


def test_uniformity_chi_square():
    import jax

    @jax.jit
    def draw(st):
        def step(st, _):
            st, u = R.randf(st)
            return st, u

        _, us = jax.lax.scan(step, st, None, length=4096)
        return us

    xs = np.asarray(draw(R.RngState.seed(jnp.arange(1, dtype=jnp.uint32)))).ravel()
    hist, _ = np.histogram(xs, bins=16, range=(0, 1))
    expected = len(xs) / 16
    chi2 = np.sum((hist - expected) ** 2 / expected)
    # 15 dof; 99.9th percentile ~ 37.7
    assert chi2 < 40.0, chi2


def test_lcg_rnd_low24():
    st = jnp.asarray(np.array([1234], np.uint32))
    st, val = R.rnd_step(st)
    v = float(np.asarray(val)[0])
    assert 0.0 <= v < 1.0
