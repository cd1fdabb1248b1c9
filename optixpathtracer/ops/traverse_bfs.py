"""Level-synchronous BFS traversal over the wide BVH.

Where every bulk gather has a large fixed cost, per-ray lockstep loops
(ops/traverse.py) pay it hundreds of times per trace. This backend pays it
O(wide-tree depth) times for the WHOLE wavefront:

  worklist of (ray, node-ref) pairs, fixed capacity C = cap_factor * N
  per level (static python loop over wbvh.depth):
    1. ONE gather of wide-node rows (child bboxes + refs packed per row)
    2. ONE gather of leaf rows (K triangles packed per row) for leaf refs
    3. ONE gather of per-ray rows (origin/dir/t interval/best-t, rebuilt
       densely each level so pruning uses fresh best-t)
    4. dense slab tests for all W children + dense Moller-Trumbore for all
       K leaf triangles (pure elementwise math)
    5. leaf hits -> scatter-min into per-ray best-t (+ equality-scatter of
       tri/u/v payload)
    6. child candidates compacted with ONE variadic lax.sort (payload rides
       the sort; no gather) into next level's worklist

Exactness: identical results to brute force PROVIDED the worklist never
overflows its capacity; the returned `overflow` counter is 0 in that case
(tests assert it). Overflowing candidates are the ones dropped LAST in
far-to-near order, so even under overflow the nearest subtrees survive.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..bvh.wide import WideBVH
from ..core.math import Vec3
from .intersect import BIG_T
from .traverse import HitRecord

Array = jax.Array
_I32 = jnp.int32
EMPTY = jnp.int32(0x7FFFFFFF)


class BFSResult(NamedTuple):
    record: HitRecord
    overflow: Array  # scalar: candidates dropped due to capacity (0 == exact)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _traverse_bfs(
    wb: WideBVH,
    o: Vec3,
    d: Vec3,
    t_min: Array,
    t_max: Array,
    any_hit: bool,
    cap_factor: int,
):
    n = o.x.shape[0]
    w = wb.width
    k = wb.leaf_size
    cap = _round_up(cap_factor * n, 1024)

    zf = (o.x + d.x) * 0.0
    t_min = jnp.broadcast_to(t_min, (n,)).astype(jnp.float32) + zf
    t_max = jnp.broadcast_to(t_max, (n,)).astype(jnp.float32) + zf

    # worklist: one root entry per ray
    pad = cap - n
    ray_ids = jnp.concatenate([jnp.arange(n, dtype=_I32) + (zf.astype(_I32)), jnp.zeros(pad, _I32)])
    refs = jnp.concatenate(
        [jnp.zeros(n, _I32) + zf.astype(_I32), jnp.full(pad, EMPTY, _I32)]
    )
    refs = jnp.where(jnp.arange(cap) < n, refs, EMPTY)

    best_t = t_max
    best_tri = jnp.full((n,), -1, _I32) + zf.astype(_I32)
    best_u = zf
    best_v = zf
    occluded = zf > 1.0
    overflow = jnp.zeros((), jnp.float32) + jnp.sum(zf) * 0.0

    nb = wb.table.shape[0]
    nl = wb.leaf_rows.shape[0]

    for _level in range(wb.depth):
        valid = refs != EMPTY
        is_leaf = valid & (refs < 0)
        is_node = valid & (refs >= 0)

        # ---- per-pair ray rows (fresh best_t for pruning) ----
        stop = occluded if any_hit else (zf > 1.0)
        ray_rows = jnp.stack(
            [o.x, o.y, o.z, d.x, d.y, d.z, t_min,
             jnp.where(stop, -1.0, best_t)],
            axis=1,
        )  # (N, 8)
        rr = ray_rows[ray_ids]  # ONE gather (C, 8)
        ox, oy, oz = rr[:, 0], rr[:, 1], rr[:, 2]
        dxl, dyl, dzl = rr[:, 3], rr[:, 4], rr[:, 5]
        p_tmin, p_tmax = rr[:, 6], rr[:, 7]
        ix = 1.0 / jnp.where(jnp.abs(dxl) > 1e-20, dxl, 1e-20)
        iy = 1.0 / jnp.where(jnp.abs(dyl) > 1e-20, dyl, 1e-20)
        iz = 1.0 / jnp.where(jnp.abs(dzl) > 1e-20, dzl, 1e-20)

        # ---- internal nodes: ONE gather, W slab tests ----
        if wb.compressed:
            nrows = wb.table[jnp.clip(refs, 0, nb - 1)]  # (C, 4W)
            child_refs = jax.lax.bitcast_convert_type(
                nrows[:, 3 * w :], jnp.int32
            )  # (C, W)
            # unpack bf16 pairs: slot bits = (hi<<16 | lo), both bf16 payloads
            bits = jax.lax.bitcast_convert_type(
                nrows[:, : 3 * w].reshape(-1, w, 3), jnp.uint32
            )
            hi = jax.lax.bitcast_convert_type(
                bits & jnp.uint32(0xFFFF0000), jnp.float32
            )  # (C, W, 3): minx, minz, maxy
            lo = jax.lax.bitcast_convert_type(bits << jnp.uint32(16), jnp.float32)
            # slots: [minx|miny], [minz|maxx], [maxy|maxz]
            bb = jnp.stack(
                [hi[..., 0], lo[..., 0], hi[..., 1], lo[..., 1], hi[..., 2], lo[..., 2]],
                axis=-1,
            )  # (C, W, 6) = [minx, miny, minz, maxx, maxy, maxz]
        else:
            nrows = wb.table[jnp.clip(refs, 0, nb - 1)]  # (C, 7W)
            child_refs = jax.lax.bitcast_convert_type(
                nrows[:, 6 * w :], jnp.int32
            )  # (C, W)
            bb = nrows[:, : 6 * w].reshape(-1, w, 6)
        t0x = (bb[:, :, 0] - ox[:, None]) * ix[:, None]
        t1x = (bb[:, :, 3] - ox[:, None]) * ix[:, None]
        t0y = (bb[:, :, 1] - oy[:, None]) * iy[:, None]
        t1y = (bb[:, :, 4] - oy[:, None]) * iy[:, None]
        t0z = (bb[:, :, 2] - oz[:, None]) * iz[:, None]
        t1z = (bb[:, :, 5] - oz[:, None]) * iz[:, None]
        near = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.maximum(jnp.minimum(t0z, t1z), p_tmin[:, None]),
        )
        far = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.minimum(jnp.maximum(t0z, t1z), p_tmax[:, None]),
        )
        cand_ok = is_node[:, None] & (near <= far) & (child_refs != EMPTY)

        # ---- leaves: ONE gather, K triangle tests ----
        leaf_id = jnp.clip(-(refs + 1), 0, nl - 1)
        lrows = wb.leaf_rows[leaf_id]  # (C, K*9)
        tv = lrows.reshape(-1, k, 9)
        e1x = tv[:, :, 3] - tv[:, :, 0]
        e1y = tv[:, :, 4] - tv[:, :, 1]
        e1z = tv[:, :, 5] - tv[:, :, 2]
        e2x = tv[:, :, 6] - tv[:, :, 0]
        e2y = tv[:, :, 7] - tv[:, :, 1]
        e2z = tv[:, :, 8] - tv[:, :, 2]
        px = dyl[:, None] * e2z - dzl[:, None] * e2y
        py = dzl[:, None] * e2x - dxl[:, None] * e2z
        pz = dxl[:, None] * e2y - dyl[:, None] * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tx = ox[:, None] - tv[:, :, 0]
        ty = oy[:, None] - tv[:, :, 1]
        tz = oz[:, None] - tv[:, :, 2]
        uu = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        vv = (dxl[:, None] * qx + dyl[:, None] * qy + dzl[:, None] * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        tri_hit = (
            is_leaf[:, None]
            & (jnp.abs(det) > 1e-12)
            & (uu >= 0.0)
            & (vv >= 0.0)
            & (uu + vv <= 1.0)
            & (tt > p_tmin[:, None])
            & (tt < p_tmax[:, None])
        )
        tt = jnp.where(tri_hit, tt, BIG_T)
        # best triangle within this pair's leaf
        jbest = jnp.argmin(tt, axis=1)
        t_pair = jnp.take_along_axis(tt, jbest[:, None], axis=1)[:, 0]
        u_pair = jnp.take_along_axis(uu, jbest[:, None], axis=1)[:, 0]
        v_pair = jnp.take_along_axis(vv, jbest[:, None], axis=1)[:, 0]
        tri_pair = wb.leaf_tri0[leaf_id] + jbest.astype(_I32)
        hit_pair = t_pair < BIG_T

        if any_hit:
            occ_i = jnp.zeros((n,), _I32).at[ray_ids].max(
                hit_pair.astype(_I32), mode="drop"
            )
            occluded = occluded | (occ_i > 0)
        else:
            best_t = best_t.at[ray_ids].min(
                jnp.where(hit_pair, t_pair, BIG_T), mode="drop"
            )
            # attach payload where we won the min; losers scatter out of
            # bounds and are dropped (a masked "write current value" would
            # race with the winner's write)
            won = hit_pair & (t_pair <= best_t[ray_ids])
            win_idx = jnp.where(won, ray_ids, n)
            best_tri = best_tri.at[win_idx].set(tri_pair, mode="drop")
            best_u = best_u.at[win_idx].set(u_pair, mode="drop")
            best_v = best_v.at[win_idx].set(v_pair, mode="drop")

        # ---- compaction: (C*W) candidates -> C slots ----
        # primary key: the candidate's NEAR-RANK WITHIN ITS OWN PAIR, so that
        # under overflow every pair keeps its nearest children before any
        # pair keeps its second-nearest — global t ordering alone starves
        # rays whose geometry is farther (e.g. image corners in an enclosed
        # scene render with a circular hole). Secondary key: t_near.
        near_masked = jnp.where(cand_ok, near, jnp.inf)
        rank = jnp.argsort(jnp.argsort(near_masked, axis=1), axis=1).astype(jnp.int32)
        cand_refs = jnp.where(cand_ok, child_refs, EMPTY).reshape(-1)
        cand_rays = jnp.broadcast_to(ray_ids[:, None], (cap, w)).reshape(-1)
        cand_near = near_masked.reshape(-1)
        cand_rank = jnp.where(cand_ok, rank, jnp.int32(w)).reshape(-1)
        srt = jax.lax.sort(
            [cand_rank, cand_near, cand_refs, cand_rays], num_keys=2
        )
        refs = srt[2][:cap]
        ray_ids = srt[3][:cap]
        n_valid = jnp.sum((srt[2] != EMPTY).astype(jnp.float32))
        overflow = overflow + jnp.maximum(n_valid - cap, 0.0)

    if any_hit:
        rec = HitRecord(
            t=jnp.where(occluded, t_min, t_max),
            tri=jnp.where(occluded, 0, -1).astype(_I32),
            u=zf,
            v=zf,
        )
    else:
        rec = HitRecord(t=best_t, tri=best_tri, u=best_u, v=best_v)
    return BFSResult(record=rec, overflow=overflow)


def closest_hit_bfs(
    wb: WideBVH,
    o: Vec3,
    d: Vec3,
    t_min: Array | float = 0.001,
    t_max: Array | float = 1e16,
    cap_factor: int = 4,
) -> BFSResult:
    return _traverse_bfs(
        wb, o, d, jnp.asarray(t_min, jnp.float32), jnp.asarray(t_max, jnp.float32),
        any_hit=False, cap_factor=cap_factor,
    )


def any_hit_bfs(
    wb: WideBVH,
    o: Vec3,
    d: Vec3,
    t_min: Array | float = 0.01,
    t_max: Array | float = 1e16,
    cap_factor: int = 4,
) -> tuple[Array, Array]:
    """Returns (occluded bool (N,), overflow scalar)."""
    res = _traverse_bfs(
        wb, o, d, jnp.asarray(t_min, jnp.float32), jnp.asarray(t_max, jnp.float32),
        any_hit=True, cap_factor=cap_factor,
    )
    return res.record.hit, res.overflow
