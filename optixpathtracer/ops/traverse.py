"""Lockstep wavefront BVH traversal — the CPU backend, and the plain
reference for the GPU kernel (ops/traverse_gpu.py).

Reference behavior being replaced: hardware closest-hit traversal
(deviceProgram.cu traceRadiance :152-178) and first-hit occlusion traversal
(traceOcclusion :181-204, OPTIX_RAY_FLAG_TERMINATE_ON_FIRST_HIT).

Design (whole-wavefront array code, not a per-thread loop):
* The whole ray wavefront traverses in lockstep SoA form. Each ray owns a
  fixed-depth stack stored as rows of an (N, S) int32 array; every loop
  iteration pops one entry per ray, gathers that node's 2-child AABB record
  (child boxes live at the parent, so it's ONE gather), slab-tests both
  children against the ray's current best t, and pushes/descends near-first.
* Leaf references (negative entries) trigger a contiguous K-triangle
  Möller–Trumbore block — the leaf's triangles are adjacent in memory by
  construction (bvh/lbvh.py), so the "gather" is K unit-stride loads.
* Everything is masked, fixed-shape, and runs under one lax.while_loop whose
  condition is "any ray still has stack entries" — XLA-friendly divergence
  handling instead of SIMT per-thread loops.

The public entry points mirror the two OptiX ray types:
  closest_hit(...)  -> full hit record (t, tri, u, v)
  any_hit(...)      -> boolean occlusion (early-exits when every ray resolved)
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..bvh.lbvh import TRAVERSAL_STACK_DEPTH, BVH
from ..core.math import Vec3
from ..core.scene import SceneData
from .intersect import BIG_T, ray_aabb, ray_triangle

Array = jax.Array
_I32 = jnp.int32

STACK_DEPTH = TRAVERSAL_STACK_DEPTH  # build_bvh asserts tree depth fits this
ROOT_REF = 0  # internal node 0 is always the Karras root


class HitRecord(NamedTuple):
    """SoA closest-hit payload (replaces the 2-register PRD pointer packing)."""

    t: Array  # (N,) BIG_T on miss
    tri: Array  # (N,) int32 sorted-triangle index, -1 on miss
    u: Array  # (N,) barycentric
    v: Array  # (N,)

    @property
    def hit(self) -> Array:
        return self.tri >= 0


def _gather_node(bvh: BVH, node: Array):
    node = jnp.clip(node, 0, bvh.num_internal - 1)
    return (
        bvh.child_left[node],
        bvh.child_right[node],
        bvh.left_min.take(node),
        bvh.left_max.take(node),
        bvh.right_min.take(node),
        bvh.right_max.take(node),
    )


def _leaf_tris(scene: SceneData, leaf_id: Array, k: int):
    """Contiguous K-triangle slice per ray: indices leaf_id*K + [0..K)."""
    base = leaf_id[:, None] * k + jnp.arange(k, dtype=_I32)[None, :]  # (N, K)
    return (
        scene.v0.take(base),
        scene.v1.take(base),
        scene.v2.take(base),
        base,
    )


def _traverse(
    bvh: BVH,
    scene: SceneData,
    o: Vec3,
    d: Vec3,
    t_min: Array,
    t_max: Array,
    any_hit: bool,
):
    n = o.x.shape[0]
    k = bvh.leaf_size
    inv_d = Vec3(
        1.0 / jnp.where(jnp.abs(d.x) > 1e-20, d.x, 1e-20),
        1.0 / jnp.where(jnp.abs(d.y) > 1e-20, d.y, 1e-20),
        1.0 / jnp.where(jnp.abs(d.z) > 1e-20, d.z, 1e-20),
    )

    # initial carries are derived from the ray inputs so that under
    # shard_map (manual axes) they inherit the inputs' device-varying type —
    # a literal jnp.zeros carry would be device-invariant and fail to match
    # the varying loop outputs.
    zero_f = (o.x + d.x) * 0.0  # d carries the device-varying pixel dependence
    zero_i = zero_f.astype(_I32)
    stack = jnp.zeros((n, STACK_DEPTH), _I32) + zero_i[:, None]
    # stack[:, 0] pre-seeded with the root internal node (ref 0)
    sp = zero_i + 1  # stack pointer; 0 == done

    state = dict(
        stack=stack,
        sp=sp,
        best_t=jnp.broadcast_to(t_max, (n,)).astype(jnp.float32) + zero_f,
        best_tri=zero_i - 1,
        best_u=zero_f,
        best_v=zero_f,
    )

    t_min = jnp.broadcast_to(t_min, (n,)).astype(jnp.float32)

    def cond(s):
        active = s["sp"] > 0
        if any_hit:
            active = active & (s["best_tri"] < 0)
        return jnp.any(active)

    def body(s):
        active = s["sp"] > 0
        if any_hit:
            active = active & (s["best_tri"] < 0)
        sp1 = s["sp"] - 1
        ref = jnp.take_along_axis(s["stack"], jnp.maximum(sp1, 0)[:, None], axis=1)[:, 0]
        sp = jnp.where(active, sp1, s["sp"])

        is_leaf = ref < 0
        do_node = active & ~is_leaf
        do_leaf = active & is_leaf

        # ---- internal node step: test both children, push near-first ----
        cl, cr, lmin, lmax, rmin, rmax = _gather_node(bvh, ref)
        hit_l = do_node & ray_aabb(o, inv_d, lmin, lmax, t_min, s["best_t"])
        hit_r = do_node & ray_aabb(o, inv_d, rmin, rmax, t_min, s["best_t"])

        # near-child ordering by slab entry distance along the dominant axis:
        # cheap heuristic — compare child box entry t on all axes via center
        lcx = (lmin.x + lmax.x) * 0.5
        lcy = (lmin.y + lmax.y) * 0.5
        lcz = (lmin.z + lmax.z) * 0.5
        rcx = (rmin.x + rmax.x) * 0.5
        rcy = (rmin.y + rmax.y) * 0.5
        rcz = (rmin.z + rmax.z) * 0.5
        dist_l = (lcx - o.x) * d.x + (lcy - o.y) * d.y + (lcz - o.z) * d.z
        dist_r = (rcx - o.x) * d.x + (rcy - o.y) * d.y + (rcz - o.z) * d.z
        left_near = dist_l <= dist_r

        near_ref = jnp.where(left_near, cl, cr)
        far_ref = jnp.where(left_near, cr, cl)
        hit_near = jnp.where(left_near, hit_l, hit_r)
        hit_far = jnp.where(left_near, hit_r, hit_l)

        # push far first, then near (near popped first)
        stack = s["stack"]

        rows = jnp.arange(stack.shape[0], dtype=_I32)

        def push(stack, sp, ref_to_push, mask):
            idx = jnp.minimum(sp, STACK_DEPTH - 1)
            cur = jnp.take_along_axis(stack, idx[:, None], axis=1)[:, 0]
            new = jnp.where(mask, ref_to_push, cur)
            stack = stack.at[rows, idx].set(new, mode="promise_in_bounds")
            sp = jnp.where(mask, jnp.minimum(sp + 1, STACK_DEPTH - 1), sp)
            return stack, sp

        stack, sp = push(stack, sp, far_ref, hit_far)
        stack, sp = push(stack, sp, near_ref, hit_near)

        # ---- leaf step: K contiguous triangle tests ----
        leaf_id = jnp.clip(-(ref + 1), 0, bvh.num_leaves - 1)
        v0, v1, v2, tri_idx = _leaf_tris(scene, leaf_id, k)
        ob = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
        db = Vec3(d.x[:, None], d.y[:, None], d.z[:, None])
        h, t, u, v = ray_triangle(
            ob, db, v0, v1, v2, t_min[:, None], s["best_t"][:, None]
        )
        h = h & do_leaf[:, None]
        t = jnp.where(h, t, BIG_T)
        j = jnp.argmin(t, axis=1)
        tb = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
        ub = jnp.take_along_axis(u, j[:, None], axis=1)[:, 0]
        vb = jnp.take_along_axis(v, j[:, None], axis=1)[:, 0]
        trib = jnp.take_along_axis(tri_idx, j[:, None], axis=1)[:, 0]
        better = tb < s["best_t"]
        best_t = jnp.where(better, tb, s["best_t"])
        best_tri = jnp.where(better, trib, s["best_tri"])
        best_u = jnp.where(better, ub, s["best_u"])
        best_v = jnp.where(better, vb, s["best_v"])

        return dict(
            stack=stack,
            sp=sp,
            best_t=best_t,
            best_tri=best_tri,
            best_u=best_u,
            best_v=best_v,
        )

    out = jax.lax.while_loop(cond, body, state)
    return HitRecord(t=out["best_t"], tri=out["best_tri"], u=out["best_u"], v=out["best_v"])


def closest_hit(
    bvh: BVH,
    scene: SceneData,
    o: Vec3,
    d: Vec3,
    t_min: Array | float = 0.001,
    t_max: Array | float = 1e16,
) -> HitRecord:
    """Full closest-hit query (RAY_TYPE_RADIANCE equivalent)."""
    return _traverse(bvh, scene, o, d, jnp.asarray(t_min, jnp.float32), jnp.asarray(t_max, jnp.float32), any_hit=False)


def any_hit(
    bvh: BVH,
    scene: SceneData,
    o: Vec3,
    d: Vec3,
    t_min: Array | float = 0.01,
    t_max: Array | float = 1e16,
) -> Array:
    """Occlusion query, terminate-on-first-hit (RAY_TYPE_OCCLUSION equivalent)."""
    rec = _traverse(bvh, scene, o, d, jnp.asarray(t_min, jnp.float32), jnp.asarray(t_max, jnp.float32), any_hit=True)
    return rec.hit


def brute_force_closest_hit(
    scene: SceneData,
    o: Vec3,
    d: Vec3,
    t_min: Array | float = 0.001,
    t_max: Array | float = 1e16,
    num_valid: int | None = None,
    ray_chunk: int | None = None,
) -> HitRecord:
    """O(N*T) reference oracle: every ray against every triangle. On a tie
    in t the lowest triangle id wins. ray_chunk bounds the (rays, tris)
    intermediates: rays are traced ray_chunk at a time under lax.map."""
    nt = scene.num_triangles if num_valid is None else num_valid
    n = o.x.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    v0 = Vec3(scene.v0.x[None, :nt], scene.v0.y[None, :nt], scene.v0.z[None, :nt])
    v1 = Vec3(scene.v1.x[None, :nt], scene.v1.y[None, :nt], scene.v1.z[None, :nt])
    v2 = Vec3(scene.v2.x[None, :nt], scene.v2.y[None, :nt], scene.v2.z[None, :nt])

    def trace(rays):
        ox, oy, oz, dx, dy, dz, lo, hi = rays
        ob = Vec3(ox[:, None], oy[:, None], oz[:, None])
        db = Vec3(dx[:, None], dy[:, None], dz[:, None])
        h, t, u, v = ray_triangle(ob, db, v0, v1, v2, lo[:, None], hi[:, None])
        t = jnp.where(h, t, BIG_T)
        j = jnp.argmin(t, axis=1)
        tb = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
        ub = jnp.take_along_axis(u, j[:, None], axis=1)[:, 0]
        vb = jnp.take_along_axis(v, j[:, None], axis=1)[:, 0]
        return tb, jnp.where(tb < BIG_T, j.astype(_I32), -1), ub, vb

    rays = (o.x, o.y, o.z, d.x, d.y, d.z, t_min, t_max)
    if ray_chunk is None or n <= ray_chunk:
        return HitRecord(*trace(rays))
    c = -(-n // ray_chunk)
    pad = c * ray_chunk - n
    rays = tuple(
        jnp.concatenate([a, jnp.broadcast_to(a[:1], (pad,))]).reshape(c, ray_chunk)
        for a in rays
    )
    out = jax.lax.map(trace, rays)
    return HitRecord(*(a.reshape(-1)[:n] for a in out))
