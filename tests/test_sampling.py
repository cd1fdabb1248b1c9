import numpy as np
import jax.numpy as jnp

from optixpathtracer.core import sampling as S
from optixpathtracer.core.rng import RngState, randf2


def _uniforms(n, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.random(n, dtype=np.float32)), jnp.asarray(
        rng.random(n, dtype=np.float32)
    )


def test_sphere_warp_on_unit_sphere():
    u1, u2 = _uniforms(4096)
    d = S.uniform_sample_sphere(u1, u2)
    r = np.asarray(d.x) ** 2 + np.asarray(d.y) ** 2 + np.asarray(d.z) ** 2
    np.testing.assert_allclose(r, 1.0, atol=1e-5)
    # mean should be ~0 on every axis
    assert abs(float(jnp.mean(d.z))) < 0.05


def test_hemisphere_warp_upper():
    u1, u2 = _uniforms(4096)
    d = S.uniform_sample_hemisphere(u1, u2)
    assert float(jnp.min(d.z)) >= 0.0


def test_cosine_hemisphere_distribution():
    u1, u2 = _uniforms(1 << 16)
    d = S.cosine_sample_hemisphere(u1, u2)
    # E[cos theta] under pdf cos/pi is 2/3
    assert abs(float(jnp.mean(d.z)) - 2.0 / 3.0) < 0.01


def test_triangle_warp_inside():
    u1, u2 = _uniforms(4096)
    u, v = S.uniform_sample_triangle(u1, u2)
    u = np.asarray(u)
    v = np.asarray(v)
    assert np.all(u >= 0) and np.all(v >= 0) and np.all(u + v <= 1.0 + 1e-6)


def test_stratified_2d_strata():
    st = RngState.seed(jnp.arange(64, dtype=jnp.uint32))
    c = jnp.arange(64, dtype=jnp.int32)
    _, r1, r2 = S.stratified_sample_2d(c, 8, 8, st)
    # sample c lands in stratum (c%8, (c//8)%8)
    np.testing.assert_array_equal(
        np.floor(np.asarray(r1) * 8).astype(int), np.arange(64) % 8
    )
    np.testing.assert_array_equal(
        np.floor(np.asarray(r2) * 8).astype(int), (np.arange(64) // 8) % 8
    )


def test_blue_noise_spacing_beats_random():
    """Best-candidate sets must have a larger minimum pairwise distance than
    white noise (the whole point of sample.h's generators)."""
    from optixpathtracer.core.sampling import best_candidate_blue_noise

    pts = best_candidate_blue_noise(128, candidates=24, seed=0)
    rng = np.random.default_rng(0)
    rand = rng.random((128, 2)).astype(np.float32)

    def min_dist(p):
        d = np.abs(p[:, None] - p[None, :])
        d = np.minimum(d, 1 - d)
        dist = (d**2).sum(-1)
        np.fill_diagonal(dist, np.inf)
        return np.sqrt(dist.min())

    assert min_dist(pts) > 2.0 * min_dist(rand)


def test_mis_weights_partition_of_unity():
    u1, u2 = _uniforms(128)
    pf = u1 * 5 + 0.1
    pg = u2 * 3 + 0.2
    wf = S.balance_heuristic(1.0, pf, 1.0, pg)
    wg = S.balance_heuristic(1.0, pg, 1.0, pf)
    np.testing.assert_allclose(np.asarray(wf + wg), 1.0, rtol=1e-5)
