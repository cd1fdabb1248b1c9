"""Whitted-style renderer: spheres + triangles, recursive reflect/refract,
per-light shadow rays, GGX direct lighting.

Reference config: "cuda/whitted.cu: Whitted spheres — recursive reflect/refract
+ shadow rays" (BASELINE.json config 2). Shading matches the vendored
whitted.cu closest-hit (GGX metallic-roughness direct lighting over
params.lights with occlusion rays, :114-198); raygen/accumulation matches
__raygen__pinhole (:44-103, center-jittered progressive accumulation);
misses return params.miss_color (:106-109). Recursion is realized the
array-native way: the ray set is STATICALLY DOUBLED per bounce (reflection and
refraction branches both continue as dense wavefronts with Fresnel-split
throughputs) — no recursion, no divergence, fixed shapes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np  # noqa: F401 (host-side static extraction)

from ..builder import CompiledScene
from ..core.camera import Camera
from ..core.math import Vec3, dot, faceforward, normalize, reflect, refract, where
from ..core.rng import RngState, randf, tea
from ..lights.lights import LIGHT_AMBIENT, LIGHT_POINT, LightTable
from ..ops.curve_intersect import CurveScene, any_hit_curves, closest_hit_curves
from ..ops.spheres import SphereScene, closest_hit_spheres
from ..ops.dispatch import trace_closest, trace_occluded
from ..shade import pbr
from ..shade.disney import fresnel_dielectric
from .wavefront import CameraParams

Array = jax.Array

BIG_T = 1e30


@dataclasses.dataclass(frozen=True)
class WhittedConfig:
    width: int = 768
    height: int = 576
    max_depth: int = 3  # reflection/refraction recursion depth
    t_min: float = 1e-3
    shadow_t_min: float = 1e-3
    miss_color: tuple = (0.34, 0.55, 0.85)
    antialias: bool = True


class _Hit(NamedTuple):
    t: Array
    n: Vec3
    mat_id: Array  # row into the sphere material table (-1 = tri hit)
    tri: Array  # triangle id (-1 = sphere hit)
    cmat: Array  # row into the curve material table (-1 = not a curve hit)
    hit: Array


def _closest(
    ss: SphereScene | None, cs: CompiledScene | None, o, d, t_min, t_max,
    curves: CurveScene | None = None,
):
    """Combined closest-hit over spheres, curves, and triangle scene."""
    n = o.x.shape[0]
    best = _Hit(
        t=jnp.full((n,), BIG_T) + o.x * 0,
        n=Vec3.zeros((n,)),
        mat_id=jnp.full((n,), -1, jnp.int32),
        tri=jnp.full((n,), -1, jnp.int32),
        cmat=jnp.full((n,), -1, jnp.int32),
        hit=jnp.zeros((n,), bool),
    )
    if ss is not None:
        sh = closest_hit_spheres(ss, o, d, t_min, t_max)
        better = sh.t < best.t
        best = _Hit(
            t=jnp.where(better, sh.t, best.t),
            n=where(better, Vec3(sh.nx, sh.ny, sh.nz), best.n),
            mat_id=jnp.where(better, ss.material_id[jnp.maximum(sh.sphere, 0)], best.mat_id),
            tri=best.tri,
            cmat=best.cmat,
            hit=best.hit | (better & sh.hit),
        )
    if curves is not None:
        ch = closest_hit_curves(curves, o, d, t_min, 1e16)
        better = ch.hit & (ch.t < best.t) & (ch.t < t_max)
        best = _Hit(
            t=jnp.where(better, ch.t, best.t),
            n=where(better, ch.normal, best.n),
            mat_id=jnp.where(better, -1, best.mat_id),
            tri=best.tri,
            cmat=jnp.where(
                better, curves.material_id[jnp.maximum(ch.seg, 0)], best.cmat
            ),
            hit=best.hit | better,
        )
    if cs is not None:
        th = trace_closest(cs, o, d, t_min, t_max)
        tn = cs.scene.geometric_normal(jnp.maximum(th.tri, 0))
        tn = faceforward(tn, -d, tn)
        better = th.hit & (th.t < best.t)
        best = _Hit(
            t=jnp.where(better, th.t, best.t),
            n=where(better, tn, best.n),
            mat_id=jnp.where(better, -1, best.mat_id),
            tri=jnp.where(better, th.tri, best.tri),
            cmat=jnp.where(better, -1, best.cmat),
            hit=best.hit | better,
        )
    return best


def _occluded(ss, cs, o, d, t_min, t_max, curves: CurveScene | None = None):
    occ = jnp.zeros_like(o.x, bool)
    if ss is not None:
        occ = occ | closest_hit_spheres(ss, o, d, t_min, t_max).hit
    if cs is not None:
        occ = occ | trace_occluded(cs, o, d, t_min, t_max)
    if curves is not None:
        occ = occ | any_hit_curves(curves, o, d, t_min, t_max)
    return occ


def light_kinds(lights: LightTable) -> tuple[int, ...]:
    """Host-side static light-kind tuple (the loop structure is compile-time)."""
    return tuple(int(k) for k in np.asarray(lights.kind))


def _shade_direct(ss, cs, lights: LightTable, kinds, cfg, p, nrm, v, base_color, metallic, roughness, hit, curves=None):
    """Direct lighting loop over the light table (whitted.cu:158-195)."""
    n = p.x.shape[0]
    out = Vec3.zeros((n,))
    for li, kind in enumerate(kinds):
        lcol = Vec3(
            jnp.broadcast_to(lights.color.x[li] * lights.intensity[li], (n,)),
            jnp.broadcast_to(lights.color.y[li] * lights.intensity[li], (n,)),
            jnp.broadcast_to(lights.color.z[li] * lights.intensity[li], (n,)),
        )
        if kind == LIGHT_AMBIENT:
            out = out + where(hit, lcol * base_color, Vec3.zeros((n,)))
        elif kind == LIGHT_POINT:
            lpos = Vec3(
                jnp.broadcast_to(lights.position.x[li], (n,)),
                jnp.broadcast_to(lights.position.y[li], (n,)),
                jnp.broadcast_to(lights.position.z[li], (n,)),
            )
            to_l = lpos - p
            dist = jnp.sqrt(jnp.maximum(dot(to_l, to_l), 1e-20))
            l = to_l / dist
            t_max = jnp.where(hit, dist - 1e-3, 0.0)
            occ = _occluded(ss, cs, p, l, cfg.shadow_t_min, t_max, curves)
            contrib = pbr.direct_light(
                base_color, metallic, roughness, nrm, v, l, lcol, ~occ & hit
            )
            # inverse-square falloff (Light.h point lights carry intensity)
            out = out + contrib * (1.0 / jnp.maximum(dist * dist, 1e-6))
    return out


def render_whitted(
    ss: SphereScene | None,
    cs: CompiledScene | None,
    lights: LightTable,
    cfg: WhittedConfig,
    cam: CameraParams,
    pixel_x: Array,
    pixel_y: Array,
    subframe: Array,
    kinds: tuple[int, ...] | None = None,
    curves: CurveScene | None = None,
) -> Vec3:
    """One whitted sample per pixel; returns linear radiance (N,)."""
    if kinds is None:
        kinds = light_kinds(lights)
    n = pixel_x.shape[0]
    w = jnp.float32(cfg.width)
    h = jnp.float32(cfg.height)
    pix = (pixel_y * cfg.width + pixel_x).astype(jnp.uint32)
    state = RngState.seed(tea(pix, subframe))

    if cfg.antialias:
        state, jx = randf(state)
        state, jy = randf(state)
        # first subframe uses pixel centers (whitted.cu:60-62)
        first = subframe == 0
        jx = jnp.where(first, 0.5, jx)
        jy = jnp.where(first, 0.5, jy)
    else:
        jx = jy = jnp.full((n,), 0.5)

    dx = 2.0 * (pixel_x.astype(jnp.float32) + jx) / w - 1.0
    dy = 2.0 * (pixel_y.astype(jnp.float32) + jy) / h - 1.0
    zf = dx * 0.0
    d0 = normalize(cam.u * dx + cam.v * dy + cam.w * 1.0)
    o0 = Vec3(cam.eye.x + zf, cam.eye.y + zf, cam.eye.z + zf)

    # The ray tree doubles per level (slot k -> reflection k, refraction
    # k + m). Rather than tracing each branch as its OWN sweep (2^depth - 1
    # inlined sweeps blow up compile time at full resolutions and leave
    # every sweep small), all branches of a level are CONCATENATED into one
    # batched sweep — program size is O(depth), the sweeps get larger (one
    # launch per level), and each ray's pixel stays j % n, so
    # per-level radiance folds back with one reshape-sum.
    def cat3(a: Vec3, b: Vec3) -> Vec3:
        return Vec3(jnp.concatenate([a.x, b.x]), jnp.concatenate([a.y, b.y]),
                    jnp.concatenate([a.z, b.z]))

    def fold(v: Vec3) -> Vec3:  # (k*n,) per-ray -> (n,) per-pixel
        return Vec3(v.x.reshape(-1, n).sum(0), v.y.reshape(-1, n).sum(0),
                    v.z.reshape(-1, n).sum(0))

    o, d = o0, d0
    tp = Vec3.ones((n,))
    eta = jnp.ones((n,))
    live = zf < 1.0
    radiance = Vec3.zeros((n,))

    for level in range(cfg.max_depth + 1):
        m = o.x.shape[0]
        zeros_m = Vec3.zeros((m,))
        miss = Vec3(jnp.full((m,), cfg.miss_color[0]),
                    jnp.full((m,), cfg.miss_color[1]),
                    jnp.full((m,), cfg.miss_color[2]))
        t_max = jnp.where(live, BIG_T, 0.0)
        hitrec = _closest(ss, cs, o, d, cfg.t_min, t_max, curves)
        hit = hitrec.hit & live
        # miss -> constant radiance (whitted.cu __miss__constant_radiance)
        radiance = radiance + fold(
            where(live & ~hitrec.hit, tp * miss, zeros_m))

        # material fetch
        if ss is not None:
            mats = ss.materials.take(jnp.maximum(hitrec.mat_id, 0))
            base = mats.color
            metallic = mats.metallic
            rough = mats.roughness
            transmission = mats.transmission
            ior = mats.index_of_refraction()
        else:
            base = Vec3.full((m,), 0.7)
            metallic = t_max * 0.0
            rough = t_max * 0.0 + 0.5
            transmission = t_max * 0.0
            ior = t_max * 0.0 + 1.5
        if cs is not None:
            tri_mat = cs.scene.materials.take(
                cs.scene.material_id[jnp.maximum(hitrec.tri, 0)]
            )
            is_tri = hitrec.mat_id < 0
            base = where(is_tri, tri_mat.color, base)
            metallic = jnp.where(is_tri, tri_mat.metallic, metallic)
            rough = jnp.where(is_tri, tri_mat.roughness, rough)
            transmission = jnp.where(is_tri, tri_mat.transmission, transmission)
            ior = jnp.where(is_tri, tri_mat.index_of_refraction(), ior)
        if curves is not None:
            cv_mat = curves.materials.take(jnp.maximum(hitrec.cmat, 0))
            is_cv = hitrec.cmat >= 0
            base = where(is_cv, cv_mat.color, base)
            metallic = jnp.where(is_cv, cv_mat.metallic, metallic)
            rough = jnp.where(is_cv, cv_mat.roughness, rough)
            transmission = jnp.where(is_cv, cv_mat.transmission, transmission)
            ior = jnp.where(is_cv, cv_mat.index_of_refraction(), ior)

        p = o + d * hitrec.t
        nrm = faceforward(hitrec.n, -d, hitrec.n)
        v = -d

        # transmissive surfaces carry (almost) no diffuse term
        direct = _shade_direct(
            ss, cs, lights, kinds, cfg, p, nrm, v,
            base * (1.0 - transmission), metallic, rough, hit, curves,
        )
        radiance = radiance + fold(where(hit, tp * direct, zeros_m))

        if level == cfg.max_depth:
            break

        # Fresnel split (entering vs exiting by the unflipped normal)
        entering = dot(hitrec.n, v) > 0.0
        eta_o = jnp.where(entering, ior, 1.0)
        fr = fresnel_dielectric(jnp.abs(dot(nrm, v)), eta, eta_o)

        # reflection branch: mirror weight = fresnel * (metallic or glass)
        refl_w = jnp.where(transmission > 0.0, fr, metallic)
        r_dir = normalize(reflect(d, nrm))
        one = Vec3.ones((m,))
        refl_tint = one + (base - one) * metallic  # metals tint mirrors

        # refraction branch
        t_dir, ok = refract(v, nrm, eta / eta_o)
        refr_w = jnp.where(ok, (1.0 - fr) * transmission, 0.0)

        o = cat3(p, p)
        d = cat3(r_dir, normalize(t_dir))
        tp = cat3(tp * refl_tint * refl_w, tp * refr_w)
        eta = jnp.concatenate([eta, eta_o])
        live = jnp.concatenate(
            [hit & (refl_w > 1e-3), hit & (refr_w > 1e-3)])

    return radiance
