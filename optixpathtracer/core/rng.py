"""Counter-based per-ray RNG (array-native equivalent of cuda/random.h + maths.h Random).

Reference: cuda/random.h tea<N> (:34-49), lcg/rnd (:53-99);
HelloPathtracing_original/maths.h Random class (:170-225).
Seeding discipline matches the reference: seed = tea4(pixel_index, subframe)
(deviceProgram.cu:357), so every (pixel, frame) pair gets an independent,
deterministic stream — renders are reproducible and restartable by construction.

The stream state is a pair of uint32 SoA arrays threaded explicitly through the
wavefront loops (no Python-side state), so the whole image advances its RNG in
one fused elementwise op. This fills the role of jax.random without the key-splitting
overhead in the innermost bounce loop.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array

_U32 = jnp.uint32


def tea(val0: Array, val1: Array, rounds: int = 4) -> Array:
    """TEA hash of two uint32 streams (cuda/random.h:34-49 semantics)."""
    v0 = jnp.asarray(val0).astype(_U32)
    v1 = jnp.asarray(val1).astype(_U32)
    s = jnp.zeros_like(v0)
    delta = _U32(0x9E3779B9)
    for _ in range(rounds):
        s = s + delta
        v0 = v0 + (((v1 << 4) + _U32(0xA341316C)) ^ (v1 + s) ^ ((v1 >> 5) + _U32(0xC8013EA4)))
        v1 = v1 + (((v0 << 4) + _U32(0xAD90777D)) ^ (v0 + s) ^ ((v0 >> 5) + _U32(0x7E95761E)))
    return v0


def lcg(prev: Array) -> Tuple[Array, Array]:
    """LCG step (cuda/random.h:53-59): returns (new_state, low-24-bit value)."""
    prev = prev.astype(_U32)
    nxt = (_U32(1664525) * prev + _U32(1013904223)) & _U32(0x00FFFFFF)
    return nxt, nxt


def rnd_step(seed: Array) -> Tuple[Array, Array]:
    """cuda/random.h rnd(): uniform in [0,1) from an LCG, advancing the seed."""
    nxt, bits = lcg(seed)
    return nxt, bits.astype(jnp.float32) / jnp.float32(1 << 24)


class RngState(NamedTuple):
    """Two-seed xorshift/rotate generator state (maths.h Random, :170-225)."""

    s1: Array
    s2: Array

    @staticmethod
    def seed(seed: Array) -> "RngState":
        """Random(seed) ctor: s1 = 315645664 + seed, s2 = s1 ^ 0x13ab45fe."""
        s1 = (_U32(315645664) + jnp.asarray(seed).astype(_U32)).astype(_U32)
        s2 = s1 ^ _U32(0x13AB45FE)
        return RngState(s1, s2)

    @staticmethod
    def for_pixels(pixel_index: Array, subframe: Array | int) -> "RngState":
        """Per-pixel stream: Random(tea4(pixel_index, subframe))."""
        sub = jnp.asarray(subframe, _U32)
        return RngState.seed(tea(pixel_index, jnp.broadcast_to(sub, jnp.shape(pixel_index))))


def _rotl(x: Array, k: int) -> Array:
    return (x << _U32(k)) | (x >> _U32(32 - k))


def rand_bits(state: RngState) -> Tuple[RngState, Array]:
    """One generator step; returns (next_state, uint32 bits). maths.h Rand()."""
    s1, s2 = state
    s1n = (s2 ^ _rotl(s1, 5)) ^ (s1 * s2)
    s2n = s1n ^ _rotl(s2, 12)
    return RngState(s1n, s2n), s1n


def randf(state: RngState) -> Tuple[RngState, Array]:
    """Uniform float in [0, 0.999999] (maths.h Randf clamps the top)."""
    state, bits = rand_bits(state)
    u = bits.astype(jnp.float32) * jnp.float32(1.0 / 4294967295.0)
    return state, jnp.clip(u, 0.0, 0.999999)


def randf2(state: RngState) -> Tuple[RngState, Array, Array]:
    """Two uniforms — the reference's Sample2D with USE_RANDOM=1 (sample.h:238-289)."""
    state, u1 = randf(state)
    state, u2 = randf(state)
    return state, u1, u2
