"""Dense (no-BVH) traversal backend for small scenes.

Tests every ray against every triangle as dense blocked math (zero gathers,
zero sorts): exact by construction, with no acceleration structure to walk.
Enclosed small scenes (cornell-style) overflow the BFS worklist since every
ray crosses every wall's bounds; dense does not. It also serves as an
independent exact oracle for the other backends in the tests.

Triangles stream through a lax.scan in fixed blocks so memory stays
(N, BLOCK) regardless of scene size.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..bvh.wide import WideBVH
from ..core.math import Vec3
from .intersect import BIG_T
from .traverse import HitRecord

Array = jax.Array
_I32 = jnp.int32

BLOCK = 512


def _tri_blocks(wb: WideBVH):
    """(L, K*9) leaf rows -> (nblocks, BLOCK, 9) triangle blocks (padded)."""
    tris = wb.leaf_rows.reshape(-1, 9)  # (T, 9) in sorted order
    t = tris.shape[0]
    nb = -(-t // BLOCK)
    pad = nb * BLOCK - t
    if pad:
        # duplicate the last triangle (harmless for closest/any hit)
        tris = jnp.concatenate([tris, jnp.broadcast_to(tris[-1:], (pad, 9))])
    return tris.reshape(nb, BLOCK, 9)


def closest_hit_dense(
    wb: WideBVH,
    o: Vec3,
    d: Vec3,
    t_min: Array | float = 0.001,
    t_max: Array | float = 1e16,
    any_hit: bool = False,
) -> HitRecord:
    n = o.x.shape[0]
    zf = (o.x + d.x) * 0.0
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,)) + zf
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,)) + zf
    blocks = _tri_blocks(wb)

    def body(carry, blk):
        best_t, best_tri, best_u, best_v, base = carry
        tv = blk  # (BLOCK, 9)
        e1x = tv[:, 3] - tv[:, 0]
        e1y = tv[:, 4] - tv[:, 1]
        e1z = tv[:, 5] - tv[:, 2]
        e2x = tv[:, 6] - tv[:, 0]
        e2y = tv[:, 7] - tv[:, 1]
        e2z = tv[:, 8] - tv[:, 2]
        px = d.y[:, None] * e2z[None] - d.z[:, None] * e2y[None]
        py = d.z[:, None] * e2x[None] - d.x[:, None] * e2z[None]
        pz = d.x[:, None] * e2y[None] - d.y[:, None] * e2x[None]
        det = e1x[None] * px + e1y[None] * py + e1z[None] * pz
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tx = o.x[:, None] - tv[None, :, 0]
        ty = o.y[:, None] - tv[None, :, 1]
        tz = o.z[:, None] - tv[None, :, 2]
        uu = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z[None] - tz * e1y[None]
        qy = tz * e1x[None] - tx * e1z[None]
        qz = tx * e1y[None] - ty * e1x[None]
        vv = (d.x[:, None] * qx + d.y[:, None] * qy + d.z[:, None] * qz) * inv_det
        tt = (e2x[None] * qx + e2y[None] * qy + e2z[None] * qz) * inv_det
        ok = (
            (jnp.abs(det) > 1e-12)
            & (uu >= 0.0)
            & (vv >= 0.0)
            & (uu + vv <= 1.0)
            & (tt > t_min[:, None])
            & (tt < jnp.minimum(t_max, best_t)[:, None])
        )
        tt = jnp.where(ok, tt, BIG_T)
        j = jnp.argmin(tt, axis=1)
        tb = jnp.take_along_axis(tt, j[:, None], axis=1)[:, 0]
        better = tb < best_t
        sel = lambda a, b: jnp.where(better, a, b)
        best_t = sel(tb, best_t)
        best_tri = sel(base + j.astype(_I32), best_tri)
        best_u = sel(jnp.take_along_axis(uu, j[:, None], axis=1)[:, 0], best_u)
        best_v = sel(jnp.take_along_axis(vv, j[:, None], axis=1)[:, 0], best_v)
        return (best_t, best_tri, best_u, best_v, base + BLOCK), None

    init = (t_max, jnp.full((n,), -1, _I32) + zf.astype(_I32), zf, zf,
            jnp.zeros((), _I32))
    (best_t, best_tri, best_u, best_v, _), _ = jax.lax.scan(body, init, blocks)
    return HitRecord(t=best_t, tri=best_tri, u=best_u, v=best_v)


def any_hit_dense(wb, o, d, t_min=0.01, t_max=1e16) -> Array:
    return closest_hit_dense(wb, o, d, t_min, t_max).hit
