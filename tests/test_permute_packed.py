"""permute_packed (engine/wavefront): the packed-row permutation that
replaces wide variadic sorts — must be an
EXACT reorder for every carried dtype, including full-range uint32 RNG
words that do not survive a float round-trip."""
import jax
import jax.numpy as jnp
import numpy as np

from optixpathtracer.engine.wavefront import permute_packed


def test_exact_roundtrip_all_dtypes():
    n = 257
    rng = np.random.default_rng(0)
    perm = jnp.asarray(rng.permutation(n).astype(np.uint32))
    f = jnp.asarray(rng.standard_normal(n).astype(np.float32)) * 1e30
    b = jnp.asarray(rng.integers(0, 2, n).astype(bool))
    i = jnp.asarray(rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32))
    u = jnp.asarray(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32))
    special = jnp.asarray(
        np.array([np.nan, np.inf, -np.inf, -0.0] * 65, np.float32)[:n]
    )

    out = permute_packed([f, b, i, u, special], perm)
    p = np.asarray(perm)
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(f)[p])
    np.testing.assert_array_equal(np.asarray(out[1]), np.asarray(b)[p])
    np.testing.assert_array_equal(np.asarray(out[2]), np.asarray(i)[p])
    np.testing.assert_array_equal(np.asarray(out[3]), np.asarray(u)[p])
    # NaN/inf payloads move as raw bytes — bit-exact, no arithmetic
    np.testing.assert_array_equal(
        np.asarray(out[4]).view(np.uint32), np.asarray(special).view(np.uint32)[p]
    )
    for o, src in zip(out, (f, b, i, u, special)):
        assert o.dtype == src.dtype


def test_jit_and_inverse():
    n = 64
    rng = np.random.default_rng(1)
    perm = jnp.asarray(rng.permutation(n).astype(np.uint32))
    inv = jnp.asarray(np.argsort(np.asarray(perm)).astype(np.uint32))
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))

    @jax.jit
    def roundtrip(x, perm, inv):
        (y,) = permute_packed([x], perm)
        (z,) = permute_packed([y], inv)
        return z

    np.testing.assert_array_equal(np.asarray(roundtrip(x, perm, inv)), np.asarray(x))
