import numpy as np
import jax.numpy as jnp

from optixpathtracer.core import spectrum as S
from optixpathtracer.core.math import Vec3


def test_cie_y_peak_near_555():
    lam = jnp.linspace(380.0, 720.0, 500)
    y = np.asarray(S.cie_y(lam))
    assert 540 < float(lam[y.argmax()]) < 570
    assert y.max() > 0.9


def test_hero_wavelengths_in_range_and_rotated():
    u = jnp.asarray(np.linspace(0, 0.999, 64, dtype=np.float32))
    lam = np.asarray(S.sample_hero_wavelengths(u))
    assert lam.shape == (64, S.N_HERO)
    assert lam.min() >= S.LAMBDA_MIN - 1e-3
    assert lam.max() <= S.LAMBDA_MAX + 1e-3
    # rotations are range/4 apart modulo range
    d = np.sort((lam - lam[:, :1]) % S.LAMBDA_RANGE, axis=1)
    np.testing.assert_allclose(d[:, 1], S.LAMBDA_RANGE / 4, atol=1.0)


def test_white_roundtrip_exact():
    lam = jnp.linspace(S.LAMBDA_MIN, S.LAMBDA_MAX, 512)[None, :]
    white = Vec3(jnp.ones(()), jnp.ones(()), jnp.ones(()))
    spec = S.rgb_to_spectrum(white, lam)
    rgb = S.spectral_to_rgb_calibrated(spec, lam)
    np.testing.assert_allclose(
        [float(rgb.x[0]), float(rgb.y[0]), float(rgb.z[0])], 1.0, rtol=2e-2
    )


def test_primary_roundtrip_hue_preserved():
    lam = jnp.linspace(S.LAMBDA_MIN, S.LAMBDA_MAX, 512)[None, :]
    for rgb_in, dominant in [((1, 0.1, 0.1), 0), ((0.1, 1, 0.1), 1), ((0.1, 0.1, 1), 2)]:
        c = Vec3(jnp.float32(rgb_in[0]), jnp.float32(rgb_in[1]), jnp.float32(rgb_in[2]))
        spec = S.rgb_to_spectrum(c, lam)
        out = S.spectral_to_rgb_calibrated(spec, lam)
        vals = [float(out.x[0]), float(out.y[0]), float(out.z[0])]
        assert int(np.argmax(vals)) == dominant, (rgb_in, vals)
        # dominant channel should carry most energy
        assert vals[dominant] > 0.5


def test_spectrum_nonnegative_bounded():
    lam = jnp.linspace(S.LAMBDA_MIN, S.LAMBDA_MAX, 256)[None, :]
    rng = np.random.default_rng(0)
    for _ in range(16):
        r, g, b = rng.random(3)
        spec = np.asarray(
            S.rgb_to_spectrum(Vec3(jnp.float32(r), jnp.float32(g), jnp.float32(b)), lam)
        )
        assert spec.min() >= -1e-4
        assert spec.max() <= 2.2  # smits bases can mildly exceed 1


def test_mc_estimator_matches_dense_integration():
    """MC hero-wavelength estimate of a known spectrum == dense integration."""
    rng = np.random.default_rng(1)
    c = Vec3(jnp.float32(0.7), jnp.float32(0.4), jnp.float32(0.2))
    # dense reference
    lam_d = jnp.linspace(S.LAMBDA_MIN, S.LAMBDA_MAX, 2048)[None, :]
    ref = S.spectral_to_rgb_calibrated(S.rgb_to_spectrum(c, lam_d), lam_d)
    # MC with many hero draws
    u = jnp.asarray(rng.random(8192, dtype=np.float32))
    lam = S.sample_hero_wavelengths(u)
    spec = S.rgb_to_spectrum(c, lam)
    out = S.spectral_to_rgb_calibrated(spec, lam)
    got = [float(jnp.mean(out.x)), float(jnp.mean(out.y)), float(jnp.mean(out.z))]
    want = [float(ref.x[0]), float(ref.y[0]), float(ref.z[0])]
    np.testing.assert_allclose(got, want, rtol=0.05)
