"""Backend-dispatching trace entry points.

Every engine/preset that needs a closest-hit or occlusion query should call
these instead of binding a specific backend, so each platform gets its fast
exact path (utils/platform.py decides which).
"""
from __future__ import annotations

from ..core.math import Vec3
from ..utils.platform import default_traversal
from . import traverse_gpu
from .traverse import HitRecord, any_hit, closest_hit
from .traverse_bfs import any_hit_bfs, closest_hit_bfs


def trace_closest(
    cs, o: Vec3, d: Vec3, t_min=1e-3, t_max=1e16, traversal: str | None = None
) -> HitRecord:
    """Closest-hit on the platform-appropriate backend (optixTrace role)."""
    tr = traversal or default_traversal()
    if tr == "gpu":
        return traverse_gpu.closest_hit(cs.packed, o, d, t_min, t_max)
    if tr == "bfs":
        return closest_hit_bfs(cs.wide, o, d, t_min, t_max).record
    if tr == "dense":
        from .dense import closest_hit_dense

        return closest_hit_dense(cs.wide, o, d, t_min, t_max)
    return closest_hit(cs.bvh, cs.scene, o, d, t_min, t_max)


def trace_occluded(
    cs, o: Vec3, d: Vec3, t_min=1e-2, t_max=1e16, traversal: str | None = None
):
    """Terminate-on-first-hit occlusion on the platform backend."""
    tr = traversal or default_traversal()
    if tr == "gpu":
        return traverse_gpu.any_hit(cs.packed, o, d, t_min, t_max)
    if tr == "bfs":
        return any_hit_bfs(cs.wide, o, d, t_min, t_max)[0]
    if tr == "dense":
        from .dense import any_hit_dense

        return any_hit_dense(cs.wide, o, d, t_min, t_max)
    return any_hit(cs.bvh, cs.scene, o, d, t_min, t_max)
