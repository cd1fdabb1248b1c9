"""The one place that maps the JAX platform to render defaults.

A GPU traces with the per-ray CUDA kernel (ops/traverse_gpu.py); the CPU
with the lockstep wavefront loop (ops/traverse.py). Any other platform is
an error: no path carries on silently on a device it was not built for.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import jax

if TYPE_CHECKING:
    from ..engine.wavefront import RenderConfig

# platform -> (traversal, sort_rays); the GPU row follows the H100
# measurement of kernel vs lockstep and sorted vs unsorted rays (PERF.md)
DEFAULTS = {
    "gpu": ("gpu", True),
    "cpu": ("lockstep", False),
}


def device_platform() -> str:
    return jax.devices()[0].platform


def platform_defaults(platform: str | None = None) -> tuple[str, bool]:
    """(traversal, sort_rays) for `platform` (default: the first device's)."""
    platform = platform or device_platform()
    if platform not in DEFAULTS:
        raise RuntimeError(
            f"no traversal for JAX platform {platform!r}; "
            f"supported: {', '.join(sorted(DEFAULTS))}"
        )
    return DEFAULTS[platform]


def default_traversal(platform: str | None = None) -> str:
    return platform_defaults(platform)[0]


def auto_tune(cfg: RenderConfig, num_triangles: int | None = None) -> RenderConfig:
    """Set the platform's traversal and ray sorting; one dispatch per launch."""
    del num_triangles  # one traversal per platform at every size measured
    traversal, sort_rays = platform_defaults()
    return dataclasses.replace(
        cfg, traversal=traversal, sort_rays=sort_rays, dispatch_tiles=1
    )
