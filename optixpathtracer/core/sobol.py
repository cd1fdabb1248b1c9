"""Padded, hash-shuffled, Owen-scrambled Sobol (0,2)-sequence sampling.

The reference ships (dormant) stratified / best-candidate blue-noise
machinery behind a compile-time strategy switch
(HelloPathtracing_original/sample.h:80-214, 238-289); the wavefront engine already
wires those in as runtime strategies (RenderConfig.sampling). This module
adds the strategy the reference never had: a full low-discrepancy sequence
covering EVERY path dimension pair at EVERY bounce.

Construction (Burley, "Practical Hash-based Owen Scrambling", JCGT 2020):

* Base points are the first two Sobol dimensions — a (0,2)-sequence: every
  power-of-2-aligned block of indices places exactly one point in every
  elementary interval. Strictly stronger than jittered strata (stratified at
  ALL dyadic scales at once, not just one grid).
* Each (pixel, dimension-pair) gets its own sequence by hash-based Owen
  scrambling: the INDEX is shuffled with a nested uniform scramble (aligned
  blocks map to aligned blocks, so prefix stratification survives) and each
  output dimension is independently nested-uniform scrambled. All three
  seeds derive from (pixel, pair) hashes.
* "Padded": every 2D pair along the path (AA, NEE at depth d, BSDF at depth
  d) uses the SAME two Sobol dimensions with independent shuffles/scrambles,
  so no direction-number tables and no dynamic-dimension gathers are needed
  — exactly 2 static dimensions, unrolled to ~200 u32 vector ops per draw.

Everything is pure element-wise uint32 math on (N,) lanes: ideal XLA.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

Array = jax.Array
_U32 = jnp.uint32


def _dim2_directions() -> np.ndarray:
    """Direction numbers for Sobol dimension 2 (primitive polynomial x+1):
    m_1 = 1, m_k = 2 m_{k-1} xor m_{k-1}; v_k = m_k << (32-k)."""
    m = [1]
    for _ in range(31):
        m.append((2 * m[-1]) ^ m[-1])
    return np.array([mk << (32 - k - 1) for k, mk in enumerate(m)], np.uint32)


_V2 = _dim2_directions()  # (32,) uint32


def reverse_bits32(x: Array) -> Array:
    x = x.astype(_U32)
    x = ((x >> _U32(1)) & _U32(0x55555555)) | ((x & _U32(0x55555555)) << _U32(1))
    x = ((x >> _U32(2)) & _U32(0x33333333)) | ((x & _U32(0x33333333)) << _U32(2))
    x = ((x >> _U32(4)) & _U32(0x0F0F0F0F)) | ((x & _U32(0x0F0F0F0F)) << _U32(4))
    x = ((x >> _U32(8)) & _U32(0x00FF00FF)) | ((x & _U32(0x00FF00FF)) << _U32(8))
    return (x >> _U32(16)) | (x << _U32(16))


def _laine_karras(x: Array, seed: Array) -> Array:
    """Laine-Karras style hash: a random bit-b flip may depend only on bits
    BELOW b, which after the surrounding bit-reversals realizes a nested
    uniform (Owen) scramble. Constants from Burley JCGT 2020."""
    x = x + seed
    x = x ^ (x * _U32(0x6C50B47C))
    x = x ^ (x * _U32(0xB82F1E52))
    x = x ^ (x * _U32(0xC7AFE638))
    x = x ^ (x * _U32(0x8D22F6E6))
    return x


def nested_uniform_scramble(x: Array, seed: Array) -> Array:
    """Hash-based Owen scramble of a uint32 (binary-tree subtree swaps keyed
    on the path from the MSB). Aligned dyadic blocks map to aligned blocks."""
    return reverse_bits32(_laine_karras(reverse_bits32(x), seed))


def _sobol_dim2(index: Array) -> Array:
    """Second Sobol dimension: XOR of direction numbers over set index bits
    (static 32-step unroll of pure vector selects)."""
    index = index.astype(_U32)
    out = jnp.zeros_like(index)
    for b in range(32):
        out = out ^ jnp.where(
            (index >> _U32(b)) & _U32(1), _U32(int(_V2[b])), _U32(0)
        )
    return out


def _u32_to_unit(bits: Array) -> Array:
    """uint32 -> [0, 1) float32 (matches the engine's clamp convention)."""
    return jnp.minimum(
        bits.astype(jnp.float32) * jnp.float32(1.0 / 4294967296.0),
        jnp.float32(0.999999),
    )


def sobol02_bits(index: Array, shuffle_seed: Array, seed_x: Array,
                 seed_y: Array) -> tuple[Array, Array]:
    """Shuffled + scrambled (0,2)-point for `index`, as raw uint32 bits."""
    i = nested_uniform_scramble(index.astype(_U32), shuffle_seed.astype(_U32))
    x = reverse_bits32(i)  # Sobol dim 1 == van der Corput
    y = _sobol_dim2(i)
    x = nested_uniform_scramble(x, seed_x.astype(_U32))
    y = nested_uniform_scramble(y, seed_y.astype(_U32))
    return x, y


def sobol02_point(index: Array, shuffle_seed: Array, seed_x: Array,
                  seed_y: Array) -> tuple[Array, Array]:
    """Shuffled + scrambled (0,2)-point in [0,1)^2."""
    x, y = sobol02_bits(index, shuffle_seed, seed_x, seed_y)
    return _u32_to_unit(x), _u32_to_unit(y)
