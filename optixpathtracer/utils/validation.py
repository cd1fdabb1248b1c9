"""Numeric validation / debug checks (the Validate()/isfinite machinery).

Reference: maths.h Validate/ValidateImpl (:122-163, compiled out in release;
device printf on non-finite) and the commented asserts in Disney.cuh:181-183.
SURVEY.md §5 'Race detection / sanitizers': the equivalents here are
deterministic-by-construction RNG (core/rng.py) plus these explicit checks
and jax's global debug_nans mode.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp

from ..core.math import Vec3


def validate(x, name: str = "value"):
    """Debug-mode finite check inside jit (jax.debug.check when enabled)."""
    import os

    if os.environ.get("OPTIXPT_VALIDATE", "0") != "1":
        return x
    if isinstance(x, Vec3):
        for comp, arr in zip("xyz", (x.x, x.y, x.z)):
            jax.debug.check(
                jnp.all(jnp.isfinite(arr)), "non-finite {} in " + name + "." + comp,
                jnp.sum(~jnp.isfinite(arr)),
            )
        return x
    jax.debug.check(
        jnp.all(jnp.isfinite(x)), "non-finite values in " + name + ": {}",
        jnp.sum(~jnp.isfinite(x)),
    )
    return x


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped jax debug-nans (the 'sanitizer' switch)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def assert_image_ok(img, what: str = "frame") -> None:
    """Host-side frame sanity: finite and non-negative (failure detection)."""
    import numpy as np

    arr = np.asarray(img)
    if not np.isfinite(arr).all():
        raise FloatingPointError(f"{what}: non-finite pixels ({(~np.isfinite(arr)).sum()})")
    if arr.dtype.kind == "f" and arr.min() < -1e-4:
        raise FloatingPointError(f"{what}: negative radiance (min {arr.min()})")
