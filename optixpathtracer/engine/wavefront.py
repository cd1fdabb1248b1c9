"""The wavefront path-trace engine — the replacement for the
reference's per-pixel megakernel.

Reference behavior being reproduced (HelloPathtracing_original/deviceProgram.cu):
__raygen__renderFrame (:340-475): per-pixel spp loop with jittered AA, bounce
loop with DONE/depth-8 termination, direct/indirect accumulation and
backplate-alpha compositing; __closesthit__radiance (:477-594): geometric
faceforward normal, texture albedo, probe NEE with balance-heuristic MIS
(SampleLights :252-292, cbsdf=csky=0.5), shadow-catcher passthrough/shadow
accumulation (SampleShadow :294-334, MATERIAL_FLAG_SHADOW_CATCHER), emission
on primary hits, Disney BSDF continuation with eta/absorption medium
tracking; __miss__radiance (:209-235): terminate (env light contributes only
via NEE + backplate compositing, the miss-shader env add is disabled in the
reference).

Design — this is NOT a thread-per-pixel megakernel:
* The whole frame (or pixel subset) is one SoA wavefront. Each bounce is two
  batched traversal sweeps (radiance + shadow) over every ray at once, then a
  fused vmapless shade pass — dense elementwise work, no per-thread
  divergence outside the traversal kernel.
* Dead rays stay in the wavefront but are masked AND get t_max=0 so the
  traversal loop retires them on the first iteration (cheap, fixed shapes).
* The sample loop is a lax.fori_loop accumulating into per-pixel sums;
  the bounce loop is a lax.fori_loop over max_depth+1 wavefront sweeps.
* RNG: per (pixel, subframe, sample) tea-seeded xorshift streams, threaded
  functionally (decorrelation equivalent to the reference's
  tea<4>(pixel, subframe) + per-sample jitter reseeding).
"""
from __future__ import annotations

import dataclasses
import functools as _functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..builder import CompiledScene
from ..core.materials import MATERIAL_FLAG_SHADOW_CATCHER
from ..core.math import (
    Vec3,
    basis_from_vector,
    cross,
    dot,
    faceforward,
    length,
    luminance,
    normalize,
    where,
)
from ..core.rng import RngState, randf, randf2, tea
from ..lights.probe import (
    Probe,
    dir_to_uv,
    probe_eval,
    probe_eval_dir,
    probe_pdf,
    probe_sample,
)
from ..ops.traverse import any_hit, closest_hit
from ..ops import traverse_gpu
from ..ops.traverse_bfs import any_hit_bfs, closest_hit_bfs
from ..shade import disney

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (compile-time) knobs — the LaunchParams/#define surface of the
    reference turned into one config object."""

    width: int = 1200
    height: int = 1024
    samples_per_launch: int = 32  # main.cpp:134
    max_depth: int = 8  # deviceProgram.cu:429 (4 in sv3/sv4)
    t_min: float = 1e-3  # deviceProgram.cu:420
    t_max: float = 1e16
    shadow_t_min: float = 0.01  # SampleLights trace tmin (:267)
    probe_samples: float = 1.0  # kProbeSamples (:30)
    bsdf_samples: float = 1.0  # kBsdfSamples (:31)
    use_shading_normals: bool = False  # original CH uses geometric normals
    antialias: bool = True  # sv4 USE_ANTIALIASING
    clamp_radiance: float = 10.0  # accumulation clamp (:462)
    traversal: str = "lockstep"  # "lockstep" (exact wavefront loop, the CPU
    #   default), "gpu" (exact per-ray CUDA kernel, the GPU default),
    #   "bfs" (level-synchronous worklist), or "dense" (exact no-BVH)
    bfs_cap_factor: int = 4  # worklist capacity multiple for the bfs backend
    dispatch_tiles: int = 1  # split each launch into this many sequential
    #   dispatches (bounds the device memory of one launch, and the BFS
    #   worklist's)
    batch_spp: bool = False  # trace all samples_per_launch in ONE expanded
    #   wavefront instead of a sequential sample loop: divides the number
    #   of traversal sweeps and launches per frame by spp, at spp times the
    #   path-state memory.
    fused_shadows: bool = False  # trace NEE shadow rays together with the
    #   NEXT bounce's radiance rays in one combined traversal (deferring the
    #   visibility resolve by one sweep) — halves traversal sweeps per bounce;
    #   radiometrically identical (same RNG streams, same estimator).
    env_via_bsdf: bool = False  # add the environment on BSDF-sampled misses
    #   with the matching MIS weight — the OTHER half of the MIS estimator,
    #   which the reference left commented out in __miss__radiance
    #   (deviceProgram.cu:214-224); its renders are darker for it (they
    #   compensate with an exposure hack). Off by default for parity.
    emission_all_bounces: bool = False  # reference adds emission only on
    #   primary hits (deviceProgram.cu:558-560), so closed emissive-lit
    #   scenes (cornell box) render black there; enable for brute-force
    #   emitter lighting through BSDF paths.
    unroll: bool = False  # unroll the (statically-bounded) spp and bounce
    #   loops into straight-line XLA instead of fori_loops — larger programs
    #   and compiles, but removes loop-carry traffic.
    nee_final_bounce: bool = True  # trace NEE shadow rays on the LAST bounce
    #   (depth == max_depth). The reference raygen breaks out of the bounce
    #   loop before accumulating the final sweep's prd.radiance
    #   (deviceProgram.cu:429-437), so its final-bounce NEE work is traced
    #   then DISCARDED. False skips that whole shadow sweep (statically — the
    #   last bounce iteration is peeled out of the loop), trading the small
    #   extra energy our "always accumulate" deviation adds for one fewer
    #   any-hit sweep per sample.
    nee_rr: float = 0.0  # Russian-roulette NEE scheduling threshold (0 = off,
    #   reference behavior: every shaded hit traces a shadow ray even when
    #   the sample contribution is negligible, deviceProgram.cu:264-277).
    #   When > 0, a shadow ray whose potential contribution luminance
    #   (throughput x contrib) is below the threshold is traced only with
    #   probability p = clamp(lum/nee_rr, 0.05, 1) and its contribution
    #   scaled by 1/p — an unbiased estimator that skips most deep-path
    #   shadow rays (they sort to dead blocks and cost ~nothing).
    sampling: str = "random"  # per-sample uniform strategy for the variance-
    #   dominant 2D draws (AA jitter, first-bounce NEE probe pair, first-
    #   bounce BSDF lobe direction) — the reference's Sample1D/Sample2D
    #   compile-time strategy switch (sample.h:238-289) as a runtime knob:
    #   "random"     plain RNG stream (reference USE_RANDOM=1 behavior);
    #   "stratified" per-pixel-scrambled jittered strata: sample index i of a
    #                pixel lands in stratum (i + scramble(pixel)) % m of an
    #                sqrt(m) x sqrt(m) grid, jittered within the stratum —
    #                every consecutive m samples of a pixel cover all strata
    #                exactly once (unbiased; sample.h StratifiedSample2D);
    #   "blue"       projective-blue-noise point set (sample.h
    #                ProjectiveBlueNoise :133-214) with a fresh per-(pixel,
    #                epoch) Cranley-Patterson rotation each m-sample epoch
    #                (rotation by an independent uniform keeps every draw
    #                marginally uniform => unbiased);
    #   "sobol"      padded hash-shuffled Owen-scrambled Sobol (0,2)-sequence
    #                (core/sobol.py, Burley JCGT 2020): EVERY dimension pair
    #                at EVERY bounce (AA + per-depth NEE + per-depth BSDF)
    #                gets its own shuffled/scrambled copy of the sequence —
    #                stratified at all dyadic scales, the strongest strategy
    #                here and one the reference never had.
    #   For stratified/blue, deeper-bounce draws come from the plain stream
    #   (their strata decorrelate too fast to pay); sobol covers all depths.
    sampling_strata: int = 64  # strata / blue-noise points per pixel epoch
    #   (stratified mode needs a perfect square)
    russian_roulette: bool = False  # throughput-proportional Russian-roulette
    #   path termination after rr_start_depth bounces: survive with
    #   p = clamp(luminance(throughput), rr_min_prob, 1), scale throughput by
    #   1/p — the classic unbiased deep-path killer NEITHER the reference NOR
    #   rounds 1-4 had (the reference bounce loop always runs to max depth,
    #   deviceProgram.cu:412-443). Killed rays retire on their first
    #   traversal step (and sort to the back under sort_rays), so the deep
    #   sweeps shrink with the surviving population.
    #   Off by default for reference parity.
    rr_start_depth: int = 2  # first bounce depth at which roulette applies
    rr_min_prob: float = 0.05  # survival-probability floor (variance guard)
    sort_rays: bool = False  # reorder the path wavefront by a spatial
    #   coherence key (dead-bit | origin Morton cell | direction octant |
    #   direction fine bits) before every bounce's traversal, and the NEE
    #   shadow rays by their own key. Neighbouring rays then walk the same
    #   nodes (less warp divergence, more cache hits in a per-ray kernel),
    #   and dead rays sort to the back: live-ray compaction without dynamic
    #   shapes. Results are bit-identical (order is restored at sample
    #   end); costs one sort + one gather of the path state per bounce.


class CameraParams(NamedTuple):
    """Raygen uniforms (LaunchParams.camera, LaunchParams.h:65-70)."""

    eye: Vec3  # scalars
    u: Vec3
    v: Vec3
    w: Vec3

    @staticmethod
    def from_camera(cam) -> "CameraParams":
        import numpy as np

        uu, vv, ww = cam.uvw_frame()
        f32 = jnp.float32
        return CameraParams(
            eye=Vec3(f32(cam.eye[0]), f32(cam.eye[1]), f32(cam.eye[2])),
            u=Vec3(f32(uu[0]), f32(uu[1]), f32(uu[2])),
            v=Vec3(f32(vv[0]), f32(vv[1]), f32(vv[2])),
            w=Vec3(f32(ww[0]), f32(ww[1]), f32(ww[2])),
        )


class SampleOutput(NamedTuple):
    """Per-pixel sums over samples_per_launch (all shapes (N,))."""

    color: Vec3  # backplate-composited radiance sum (pre 1/spp)
    alpha: Vec3  # coverage / shadow-catcher alpha mean
    normal: Vec3  # first-bounce AOV mean
    albedo: Vec3  # first-bounce AOV mean
    depth: Array  # first-bounce hit distance mean (0 on miss) — the
    #   denoiser's depth guide (the reference fills normal/albedo AOVs only,
    #   deviceProgram.cu:472-474; depth stops edge-bleeding between
    #   same-normal same-albedo surfaces at different depths)
    rays_traced: Array  # scalar: exact radiance+shadow ray count (bench metric)
    bfs_overflow: Array  # scalar: BFS worklist candidates dropped (0 == exact
    #   traversal; nonzero means nearest-first truncation occurred)
    tex_usage: Array | None = None  # (num_pages,) bool page-usage bitmap when
    #   a demand_pool was given (feed to DemandTextureManager.process_requests)


def _hit_geometry(
    cs: CompiledScene, rec, ray_dir: Vec3, use_shading: bool,
    demand_pool=None, demand_mask=None, demand_footprint=None,
):
    """Fetch per-hit position/normal/albedo inputs (the SBT-record stage).
    Returns (normal, material, albedo, tex_usage-or-None).

    demand_pool (io.demand.DemandTexturePool, optional): sample albedo from
    the sparse demand-loaded pool instead of the resident TexturePool —
    non-resident hits shade with the texture's fallback color and report
    their page in the returned usage bitmap (the reference's sparse-texture
    shading contract). demand_mask limits usage reporting to real hits.
    demand_footprint (optional (N,) f32, world units): the ray's screen
    footprint at the hit — with a multi-level pool, a mip LOD is derived
    per hit from the triangle's texel density (sqrt of UV-area over
    world-area) and sampling goes trilinear, so minified textures read
    coarse pages (fewer pages resident AND anti-aliased minification)."""
    scene = cs.scene
    tri = jnp.maximum(rec.tri, 0)
    if scene.shade_rows is not None:
        # ONE wide-row gather for the whole shade record (SBT fetch)
        v0, v1, v2, sn0, sn1, sn2, uv6, mat_id, has = scene.take_shade(tri)
        uv0u, uv0v, uv1u, uv1v, uv2u, uv2v = uv6
    else:
        v0 = scene.v0.take(tri)
        v1 = scene.v1.take(tri)
        v2 = scene.v2.take(tri)
        sn0, sn1, sn2 = scene.n0.take(tri), scene.n1.take(tri), scene.n2.take(tri)
        uv0u, uv0v = scene.uv0u[tri], scene.uv0v[tri]
        uv1u, uv1v = scene.uv1u[tri], scene.uv1v[tri]
        uv2u, uv2v = scene.uv2u[tri], scene.uv2v[tri]
        mat_id = scene.material_id[tri]
        has = scene.has_shading_normal[tri]
    n_geom = normalize(cross(v1 - v0, v2 - v0))
    if use_shading:
        w0 = 1.0 - rec.u - rec.v
        ns = sn0 * w0 + sn1 * rec.u + sn2 * rec.v
        n = normalize(where(has, ns, n_geom))
    else:
        n = n_geom
    # faceforward against the incoming ray (deviceProgram.cu:492)
    n = faceforward(n, -ray_dir, n)

    mat = scene.materials.take(mat_id)

    w0 = 1.0 - rec.u - rec.v
    tu = uv0u * w0 + uv1u * rec.u + uv2u * rec.v
    tv = uv0v * w0 + uv1v * rec.u + uv2v * rec.v
    usage = None
    if demand_pool is not None:
        from ..io.demand import sample_demand

        tex_ids = (
            mat.texture_id if demand_mask is None
            else jnp.where(demand_mask, mat.texture_id, -1)
        )
        lod = None
        trilinear = False
        if demand_footprint is not None and demand_pool.page_offset.shape[1] > 1:
            # texel density from this triangle's UV-to-world mapping
            e1, e2 = v1 - v0, v2 - v0
            world_area = length(cross(e1, e2))
            uv_area = jnp.abs(
                (uv1u - uv0u) * (uv2v - uv0v) - (uv2u - uv0u) * (uv1v - uv0v)
            )
            tex_w = demand_pool.width[jnp.maximum(tex_ids, 0), 0]
            texel_per_world = (
                jnp.sqrt(uv_area / jnp.maximum(world_area, 1e-20))
                * tex_w.astype(jnp.float32)
            )
            lod = jnp.log2(
                jnp.maximum(demand_footprint * texel_per_world, 1.0)
            )
            trilinear = True
        tex, _resident, usage = sample_demand(
            demand_pool, tex_ids, tu, tv, lod=lod, trilinear=trilinear
        )
    else:
        tex = scene.textures.sample_bilinear(mat.texture_id, tu, tv)
    albedo = where(mat.texture_id >= 0, tex, mat.color)
    return n, mat, albedo, usage


def _closest_hit2(cs, cfg, o, d, t_min, t_max):
    """Returns (HitRecord, overflow scalar)."""
    if cfg.traversal == "gpu":
        rec = traverse_gpu.closest_hit(cs.packed, o, d, t_min, t_max)
        return rec, jnp.zeros((), jnp.float32)
    if cfg.traversal == "bfs":
        res = closest_hit_bfs(
            cs.wide, o, d, t_min, t_max, cap_factor=cfg.bfs_cap_factor
        )
        return res.record, res.overflow
    if cfg.traversal == "dense":
        from ..ops.dense import closest_hit_dense

        return closest_hit_dense(cs.wide, o, d, t_min, t_max), jnp.zeros((), jnp.float32)
    rec = closest_hit(cs.bvh, cs.scene, o, d, t_min, t_max)
    return rec, jnp.zeros((), jnp.float32)


def _any_hit2(cs, cfg, o, d, t_min, t_max):
    """Returns (occluded bool, overflow scalar)."""
    if cfg.traversal == "gpu":
        occ = traverse_gpu.any_hit(cs.packed, o, d, t_min, t_max)
        return occ, jnp.zeros((), jnp.float32)
    if cfg.traversal == "bfs":
        occ, ovf = any_hit_bfs(cs.wide, o, d, t_min, t_max, cap_factor=cfg.bfs_cap_factor)
        return occ, ovf
    if cfg.traversal == "dense":
        from ..ops.dense import any_hit_dense

        return any_hit_dense(cs.wide, o, d, t_min, t_max), jnp.zeros((), jnp.float32)
    return any_hit(cs.bvh, cs.scene, o, d, t_min, t_max), jnp.zeros((), jnp.float32)


def _closest_hit(cs, cfg, o, d, t_min, t_max):
    return _closest_hit2(cs, cfg, o, d, t_min, t_max)[0]


def _any_hit(cs, cfg, o, d, t_min, t_max):
    return _any_hit2(cs, cfg, o, d, t_min, t_max)[0]


def _spread3(x: Array) -> Array:
    """Spread the low 10 bits of x so consecutive bits land 3 apart."""
    x = x & jnp.uint32(0x3FF)
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def _coherence_key(o: Vec3, d: Vec3, done: Array, aabb: Array) -> Array:
    """Spatial sort key for ray-stream coherence (uint32, ascending = good
    block order): dead(1) | direction octant(3) | origin Morton 18 (6
    bits/axis over the scene AABB) | direction-magnitude Morton (top 10).

    Octant-major: direction sign decides which half of each node split a
    ray visits first; within an octant, rays group by origin cell.
    Camera rays (shared origin, equal octant|origin key) keep their incoming
    pixel-tile order — lax.sort is stable."""

    def q6(a, lo, hi):
        s = 64.0 / jnp.maximum(hi - lo, 1e-6)
        return jnp.clip((a - lo) * s, 0.0, 63.0).astype(jnp.uint32)

    om = (
        _spread3(q6(o.x, aabb[0], aabb[3]))
        | (_spread3(q6(o.y, aabb[1], aabb[4])) << 1)
        | (_spread3(q6(o.z, aabb[2], aabb[5])) << 2)
    )
    oct_ = (
        (d.x < 0).astype(jnp.uint32) * 4
        + (d.y < 0).astype(jnp.uint32) * 2
        + (d.z < 0).astype(jnp.uint32)
    )

    def qd(a):
        return jnp.clip(jnp.abs(a) * 16.0, 0.0, 15.0).astype(jnp.uint32)

    dm = _spread3(qd(d.x)) | (_spread3(qd(d.y)) << 1) | (_spread3(qd(d.z)) << 2)
    return (
        done.astype(jnp.uint32) * jnp.uint32(1 << 31)
        | (oct_ << 28)
        | (om << 10)
        | (dm >> 2)
    )


# distinct salts decorrelate the three stratified dimension-pairs (AA /
# first-bounce NEE / first-bounce BSDF) per pixel
_LD_SALT_AA = 0x51ED270B
_LD_SALT_NEE = 0x85EBCA6B
_LD_SALT_BSDF = 0xC2B2AE35


@_functools.lru_cache(maxsize=4)
def _blue_noise_table(m: int):
    # module-level cache: the dart-throwing construction is a Python loop of
    # m candidate-scoring rounds, and _ld_bases asks for the table once per
    # salt per unrolled sample body — rebuild only per distinct m
    from ..core.sampling import projective_blue_noise

    return projective_blue_noise(m, dim=2, candidates=24, seed=7)


def _u32_to_unit(bits: Array) -> Array:
    """uint32 -> [0, 1) float32."""
    return jnp.minimum(
        bits.astype(jnp.float32) * jnp.float32(1.0 / 4294967296.0),
        jnp.float32(0.999999),
    )


def _sobol_pair(pix: Array, ctr: Array, depth: Array, salt: int):
    """One padded Owen-Sobol dimension pair for sample `ctr` of each pixel
    at bounce `depth` (cfg.sampling == "sobol"). Each (pixel, depth, salt)
    triple keys an independently shuffled + scrambled copy of the
    (0,2)-sequence; `ctr` indexes into it (core/sobol.py)."""
    from ..core.sobol import sobol02_point

    dsalt = (depth.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)) ^ jnp.uint32(salt)
    s0 = tea(pix.astype(jnp.uint32), dsalt)
    return sobol02_point(
        ctr.astype(jnp.uint32), s0,
        tea(s0, jnp.uint32(0x68BC21EB)), tea(s0, jnp.uint32(0x02E5BE93)),
    )


def _ld_bases(cfg: RenderConfig, pix_index: Array, ctr: Array, salt: int):
    """Deterministic low-discrepancy stratum base for sample `ctr` of each
    pixel, for one dimension pair. Returns (b1, b2, scale): the consumer
    draws jitter (j1, j2) from the RNG stream and uses b + j * scale.

    stratified: base = stratum corner, scale = 1/sqrt(m) — jittered strata,
    visited in a per-pixel rotated order so neighboring pixels decorrelate.
    blue: base = CP-rotated blue-noise point, scale = 0 — each m-sample
    epoch applies a fresh per-(pixel, epoch) rotation, so expectations stay
    uniform while each epoch keeps the table's blue spectrum."""
    m = cfg.sampling_strata
    off = tea(pix_index, jnp.uint32(salt))
    idx = (ctr + off) % jnp.uint32(m)
    if cfg.sampling == "stratified":
        dx = int(round(m ** 0.5))
        if dx * dx != m:
            raise ValueError(f"sampling_strata={m} must be a perfect square")
        b1 = (idx % dx).astype(jnp.float32) / dx
        b2 = (idx // dx).astype(jnp.float32) / dx
        return b1, b2, 1.0 / dx
    if cfg.sampling == "blue":
        table = jnp.asarray(_blue_noise_table(m))  # (m, 2) constant
        epoch = (ctr + off) // jnp.uint32(m)
        r1 = _u32_to_unit(tea(pix_index ^ jnp.uint32(salt), epoch * 2))
        r2 = _u32_to_unit(tea(pix_index ^ jnp.uint32(salt), epoch * 2 + 1))
        pt = table[idx]
        b1 = jnp.mod(pt[..., 0] + r1, 1.0)
        b2 = jnp.mod(pt[..., 1] + r2, 1.0)
        return b1, b2, 0.0
    raise ValueError(f"unknown sampling strategy {cfg.sampling!r}")


def _pack_u32(leaves: list[Array]) -> Array:
    """Bit-pack same-shape (N,) leaves of mixed dtype into one (N, F) u32
    matrix (bools widen exactly; f32/i32 bitcast — bytes move, no math)."""
    cols = []
    for l in leaves:
        if l.dtype == jnp.bool_:
            cols.append(l.astype(jnp.uint32))
        elif l.dtype in (jnp.uint32, jnp.int32):
            cols.append(jax.lax.bitcast_convert_type(l, jnp.uint32))
        else:
            cols.append(jax.lax.bitcast_convert_type(l.astype(jnp.float32), jnp.uint32))
    return jnp.stack(cols, axis=1)


def _unpack_u32(packed: Array, protos: list[Array]) -> list[Array]:
    out = []
    for i, p in enumerate(protos):
        col = packed[:, i]
        if p.dtype == jnp.bool_:
            out.append(col != 0)
        elif p.dtype in (jnp.uint32, jnp.int32):
            out.append(jax.lax.bitcast_convert_type(col, p.dtype))
        else:
            out.append(jax.lax.bitcast_convert_type(col, jnp.float32).astype(p.dtype))
    return out


def permute_packed(leaves: list[Array], perm: Array) -> list[Array]:
    """Apply one permutation to many (N,) arrays via a single WIDE-ROW
    gather of the bit-packed (N, F) u32 matrix.

    One wide-row gather instead of ~40 narrow ones or a wide variadic
    lax.sort (same trick as SceneData.shade_rows)."""
    packed = _pack_u32(leaves)
    # barrier on both sides: the pack (a stack relayout) and the bulk row
    # gather must not fuse with element-wise neighbors, or XLA lowers the
    # gather to per-element loads
    moved = jax.lax.optimization_barrier(
        jax.lax.optimization_barrier(packed)[perm]
    )
    return _unpack_u32(moved, leaves)


def _sort_path(path: dict, key: Array) -> dict:
    """Reorder every per-ray leaf of the path state by ascending key:
    ONE (key, iota) sort for the permutation + ONE packed-row gather."""
    scalars = ("rays", "ovf", "tex_usage")  # not per-lane: never permuted
    moving = {k: v for k, v in path.items() if k not in scalars}
    leaves, treedef = jax.tree.flatten(moving)
    n = key.shape[0]
    _, perm = jax.lax.sort(
        [key, jax.lax.iota(jnp.uint32, n)], num_keys=1
    )
    moved = jax.tree.unflatten(treedef, permute_packed(leaves, perm))
    return {**{k: path[k] for k in scalars if k in path}, **moved}


def _nee_sample(cs, probe, cfg, p, n, wo, mat, albedo, eta_i, eta_o, state,
                u12=None):
    """Draw the probe NEE sample and its MIS-weighted contribution WITHOUT
    tracing visibility (SampleLights math, deviceProgram.cu:252-292).
    Returns (state, wi, contrib, valid). u12: optional low-discrepancy
    uniform pair for the probe draw (RenderConfig.sampling)."""
    state, wi, sky_color, sky_pdf = probe_sample(probe, state, u12=u12)

    b_pdf = disney.bsdf_pdf(mat, eta_i, eta_o, n, wo, wi)
    f = disney.bsdf_eval(mat, albedo, eta_i, eta_o, n, wo, wi)

    n_total = cfg.probe_samples + cfg.bsdf_samples
    c_bsdf = cfg.bsdf_samples / n_total
    c_sky = cfg.probe_samples / n_total
    weight = c_sky * sky_pdf / jnp.maximum(c_bsdf * b_pdf + c_sky * sky_pdf, 1e-12)

    valid = (b_pdf > 0.0) & (weight > 0.0) & (sky_pdf > 0.0)
    scale = weight * jnp.abs(dot(wi, n)) / jnp.maximum(sky_pdf, 1e-12) / cfg.probe_samples
    contrib = sky_color * f * scale
    return state, wi, contrib, valid


def _any_hit_sorted(cs, cfg, o: Vec3, d: Vec3, t_min, t_max):
    """Occlusion sweep with its OWN coherence sort.

    NEE shadow rays inherit the radiance wavefront's order (sorted by the
    BOUNCE ray), but their directions are probe-sampled over the whole
    hemisphere, so neighbouring shadow rays are direction-incoherent. One
    extra (key, iota) sort + packed permute + boolean scatter-back groups
    them again. Results are bit-identical (occlusion is per-ray)."""
    if not cfg.sort_rays:
        return _any_hit2(cs, cfg, o, d, t_min, t_max)
    n = o.x.shape[0]
    t_max = jnp.broadcast_to(t_max, (n,))
    dead = t_max <= t_min
    key = _coherence_key(o, d, dead, cs.scene_aabb)
    _, perm = jax.lax.sort([key, jax.lax.iota(jnp.uint32, n)], num_keys=1)
    sx, sy, sz, sdx, sdy, sdz, stm = permute_packed(
        [o.x, o.y, o.z, d.x, d.y, d.z, t_max], perm
    )
    occ, ovf = _any_hit2(
        cs, cfg, Vec3(sx, sy, sz), Vec3(sdx, sdy, sdz), t_min, stm
    )
    occ_u = jnp.zeros((n,), occ.dtype).at[perm].set(occ)
    return occ_u, ovf


def _nee_rr(cfg, state, throughput, contrib, valid):
    """Russian-roulette NEE scheduling (cfg.nee_rr; unbiased): dim potential
    contributions survive with p = clamp(lum/threshold, 0.05, 1) and are
    scaled by 1/p. Returns (state, contrib', valid')."""
    if cfg.nee_rr <= 0.0 or throughput is None:
        return state, contrib, valid
    lum = luminance(throughput * contrib)
    p_surv = jnp.clip(lum / cfg.nee_rr, 0.05, 1.0)
    state, u = randf(state)
    survive = u < p_surv
    return state, contrib * (1.0 / p_surv), valid & survive


def _nee(cs, probe, cfg, p, n, wo, mat, albedo, eta_i, eta_o, active, state,
         throughput=None, u12=None):
    """NEE with immediate visibility trace. Returns (state,
    unshadowed_contrib_if_visible, shadowed_contrib_if_occluded, overflow,
    traced_mask) — `shadowed` feeds the shadow-catcher path (SampleShadow
    :294-334); `traced_mask` is which lanes actually traced a shadow ray
    (the bench ray count)."""
    state, wi, contrib, valid = _nee_sample(
        cs, probe, cfg, p, n, wo, mat, albedo, eta_i, eta_o, state, u12=u12
    )
    if cfg.nee_rr > 0.0:
        state, contrib, valid = _nee_rr(cfg, state, throughput, contrib, valid)
        # under RR scheduling, skipped/invalid lanes genuinely do not trace
        traced = active & valid
    else:
        # reference parity: every shaded hit traces, even invalid samples
        # (deviceProgram.cu:264-277 traces before checking pdfs)
        traced = active
    t_max = jnp.where(traced, cfg.t_max, 0.0)
    occluded, ovf = _any_hit_sorted(cs, cfg, p, wi, cfg.shadow_t_min, t_max)
    zero = Vec3.zeros(jnp.shape(valid))
    lit = where(valid & ~occluded, contrib, zero)
    shadowed = where(valid & occluded, contrib, zero)
    return state, lit, shadowed, ovf, traced


def _quad_nee(cs, cfg, light, p, n, wo, mat, albedo, eta_i, eta_o, active, state):
    """Area-light next-event estimation against the single parallelogram
    light (the reference carries one in LaunchParams but never samples it;
    here it's a real NEE strategy with balance-heuristic MIS against the
    BSDF). Returns (state, contrib, pdf-aware contribution)."""
    from ..lights.lights import sample_parallelogram

    state, q, ln, _area = sample_parallelogram(light.corner, light.v1, light.v2, state)
    nsh = jnp.shape(p.x)
    q = q.broadcast_to(nsh)
    ln = ln.broadcast_to(nsh)
    to_q = q - p
    dist2 = jnp.maximum(dot(to_q, to_q), 1e-12)
    dist = jnp.sqrt(dist2)
    wi = to_q / dist
    cos_l = -dot(wi, ln)  # light faces along -normal toward the shading point
    cos_l = jnp.abs(cos_l)  # two-sided emitter
    pdf_sa = dist2 / jnp.maximum(light.area * cos_l, 1e-9)

    b_pdf = disney.bsdf_pdf(mat, eta_i, eta_o, n, wo, wi)
    f = disney.bsdf_eval(mat, albedo, eta_i, eta_o, n, wo, wi)
    weight = pdf_sa / jnp.maximum(pdf_sa + b_pdf, 1e-12)  # balance heuristic
    valid = (b_pdf > 0.0) & (cos_l > 1e-6) & active

    t_max = jnp.where(valid, dist - 1e-3, 0.0)
    occluded, ovf = _any_hit_sorted(cs, cfg, p, wi, cfg.shadow_t_min, t_max)

    e = light.emission.broadcast_to(nsh)
    contrib = e * f * (weight * jnp.abs(dot(wi, n)) / pdf_sa)
    zero = Vec3.zeros(nsh)
    return state, where(valid & ~occluded, contrib, zero), ovf


def quad_light_pdf(light, p: Vec3, d: Vec3, t_hit: Array) -> Array:
    """Solid-angle pdf of having NEE-sampled the point hit by (p, d, t)."""
    hit_p = p + d * t_hit
    nsh = jnp.shape(p.x)
    ln = light.normal.broadcast_to(nsh)
    cos_l = jnp.abs(dot(d, ln))
    dist2 = t_hit * t_hit
    return dist2 / jnp.maximum(light.area * cos_l, 1e-9)


def trace_wavefront(
    cs: CompiledScene,
    probe: Probe,
    cfg: RenderConfig,
    cam: CameraParams,
    pixel_x: Array,
    pixel_y: Array,
    subframe: Array,
    active_mask: Array | None = None,
    area_light=None,
    sample_lanes: Array | None = None,
    demand_pool=None,
) -> SampleOutput:
    """Render cfg.samples_per_launch paths for each pixel in the wavefront.

    pixel_x/pixel_y: (N,) int32 pixel coordinates (any subset of the frame —
    full frame, sharded tile, or foveation ring). active_mask (optional bool
    (N,)) culls lanes up-front — the foveation annulus test (sv4
    deviceProgram.cu:421-425): culled lanes trace nothing and output zeros.

    demand_pool (optional io.demand.DemandTexturePool): sample textured
    albedo from the sparse demand-loaded pool; the launch's page-usage
    bitmap comes back in SampleOutput.tex_usage for the host pager (the
    reference's launch-prepare/launch-process cycle, DemandLoaderImpl).

    sample_lanes (optional (N,) uint32): explicit per-lane RNG sample counter
    (the value that replaces `subframe * spp + sample_index` in the tea seed).
    When given, each lane is ONE sample the caller expanded itself — lanes of
    different pixels may carry different effective spp (the fused-foveation
    launch concatenates zones of spp 1/2/8 into one wavefront). No spp loop,
    no fold: outputs are per-LANE (color composited at spp=1), and the caller
    aggregates lanes back to pixels. Streams are identical to the unfused
    launches when the caller passes the same counters.
    """
    n_pix = pixel_x.shape[0]
    spp = cfg.samples_per_launch
    fused_lanes = sample_lanes is not None
    # batched-spp mode: expand the wavefront to pixels x samples so the whole
    # launch is ONE set of traversal sweeps (bulk ops are ~size-free, see cfg)
    batch = cfg.batch_spp and spp > 1 and not fused_lanes
    if batch:
        pixel_x = jnp.tile(pixel_x, spp)
        pixel_y = jnp.tile(pixel_y, spp)
        if active_mask is not None:
            active_mask = jnp.tile(active_mask, spp)
        s_lanes = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n_pix)
        loop_spp = 1
    elif fused_lanes:
        s_lanes = None
        loop_spp = 1
    else:
        s_lanes = None
        loop_spp = spp

    n = pixel_x.shape[0]
    w = jnp.float32(cfg.width)
    h = jnp.float32(cfg.height)
    pix_index = (pixel_y * cfg.width + pixel_x).astype(jnp.uint32)

    # tied to the (possibly device-sharded) pixel inputs so loop carries are
    # device-varying under shard_map
    zero_scalar = jnp.sum(pixel_x).astype(jnp.float32) * 0.0
    zf = pixel_x.astype(jnp.float32) * 0.0
    zero = Vec3(zf, zf, zf)

    def sample_body(s, carry):
        (acc_color, acc_alpha, acc_normal, acc_albedo, acc_depth,
         acc_backplate, acc_rays, acc_ovf, acc_usage) = carry
        # per (pixel, subframe, sample) stream
        if fused_lanes:
            seed_ctr = sample_lanes
        else:
            s_eff = s_lanes if s_lanes is not None else s
            seed_ctr = subframe.astype(jnp.uint32) * cfg.samples_per_launch + s_eff
        state = RngState.seed(tea(pix_index, seed_ctr))

        # low-discrepancy strategy (cfg.sampling): deterministic stratum
        # bases per (pixel, sample counter), computed HERE so they ride the
        # path sorts as ordinary per-lane leaves; the within-stratum jitter
        # is drawn from the normal stream at the consumer (stream advance
        # counts stay identical across strategies)
        ld = cfg.sampling != "random"
        sobol = cfg.sampling == "sobol"
        ldsc = 0.0
        ld_leaves = {}
        if sobol:
            # the Sobol draws are recomputed per bounce from (pixel, sample
            # counter), so only those two u32s ride the path sorts
            zu = (zf * 0.0).astype(jnp.uint32)
            ld_leaves = dict(ld_pix=pix_index + zu,
                             ld_ctr=seed_ctr + zu)
        elif ld:
            n1, n2, ldsc = _ld_bases(cfg, pix_index, seed_ctr, _LD_SALT_NEE)
            b1, b2, _ = _ld_bases(cfg, pix_index, seed_ctr, _LD_SALT_BSDF)
            ld_leaves = dict(ld_n1=n1, ld_n2=n2, ld_b1=b1, ld_b2=b2)

        if cfg.antialias:
            state, jx = randf(state)
            state, jy = randf(state)
            if sobol:
                jx, jy = _sobol_pair(
                    pix_index, seed_ctr, jnp.uint32(0), _LD_SALT_AA
                )
            elif ld:
                a1, a2, _ = _ld_bases(cfg, pix_index, seed_ctr, _LD_SALT_AA)
                jx = a1 + jx * ldsc
                jy = a2 + jy * ldsc
        else:
            jx = jnp.full((n,), 0.5)
            jy = jnp.full((n,), 0.5)

        dx = 2.0 * (pixel_x.astype(jnp.float32) + jx) / w - 1.0
        dy = 2.0 * (pixel_y.astype(jnp.float32) + jy) / h - 1.0
        d = normalize(cam.u * dx + cam.v * dy + cam.w * 1.0)
        # zf ties the (replicated) camera origin to the sharded pixel inputs so
        # the bounce-loop carry is device-varying under shard_map
        o = Vec3(cam.eye.x + zf, cam.eye.y + zf, cam.eye.z + zf)

        bu, bv = dir_to_uv(d)
        backplate = probe_eval(probe, bu, bv)

        path = dict(
            o=o,
            d=d,
            throughput=Vec3(zf + 1.0, zf + 1.0, zf + 1.0),
            eta=zf + 1.0,
            radiance=zero,
            alpha=zero,
            normal=zero,
            albedo=zero,
            done=(zf > 1.0) if active_mask is None else ~active_mask,
            secondary=zf > 1.0,
            state=state,
            rays=zero_scalar,
            ovf=zero_scalar,
            depth_aov=zf,
            bsdf_pdf=zf + 1.0,  # RadiancePRD.bsdfPdf init (deviceProgram.cu:381)
            # True after a delta (SPECULAR) event: bsdf_pdf is then a discrete
            # probability, not a solid-angle density, so MIS weights that mix
            # it with area pdfs are meaningless and must be forced to 1
            prev_delta=zf > 1.0,
            **ld_leaves,
        )
        if demand_pool is not None:
            path["tex_usage"] = jnp.zeros(
                (demand_pool.num_pages,), jnp.bool_
            ) & (zero_scalar < 1.0)
            # accumulated path length: drives the mip-LOD footprint when the
            # pool carries mip levels (screen footprint grows with distance)
            path["plen"] = zf
        sorting = cfg.sort_rays
        if sorting:
            # original lane index, so the sample's outputs can be restored to
            # caller order after the bounce loop reorders the wavefront
            path["idx"] = jnp.arange(n, dtype=jnp.uint32) + (zf * 0).astype(jnp.uint32)
        if cfg.fused_shadows:
            path.update(
                sh_o=o,
                sh_d=d,
                pend_contrib=zero,
                pend_valid=zf > 1.0,
                pend_catcher=zf > 1.0,
            )

        def bounce_body(depth, path, skip_nee: bool = False):
            if sorting:
                key = _coherence_key(
                    path["o"], path["d"], path["done"], cs.scene_aabb
                )
                path = _sort_path(path, key)
            # past max_depth the loop only flushes the last pending shadow
            active = ~path["done"] & (depth <= cfg.max_depth)
            t_max = jnp.where(active, cfg.t_max, 0.0)
            if cfg.fused_shadows:
                # ONE combined traversal: this bounce's radiance rays plus the
                # previous bounce's NEE shadow rays (origin = previous hit =
                # this ray's origin, since the path continues from there)
                sh_tmax = jnp.where(path["pend_valid"], cfg.t_max, 0.0)
                o2 = Vec3(
                    jnp.concatenate([path["o"].x, path["sh_o"].x]),
                    jnp.concatenate([path["o"].y, path["sh_o"].y]),
                    jnp.concatenate([path["o"].z, path["sh_o"].z]),
                )
                d2 = Vec3(
                    jnp.concatenate([path["d"].x, path["sh_d"].x]),
                    jnp.concatenate([path["d"].y, path["sh_d"].y]),
                    jnp.concatenate([path["d"].z, path["sh_d"].z]),
                )
                t_min2 = jnp.concatenate(
                    [jnp.full((n,), cfg.t_min), jnp.full((n,), cfg.shadow_t_min)]
                )
                t_max2 = jnp.concatenate([t_max, sh_tmax])
                rec2, trav_ovf = _closest_hit2(cs, cfg, o2, d2, t_min2, t_max2)
                rec = jax.tree.map(lambda a: a[:n], rec2)
                occluded = rec2.tri[n:] >= 0
                # resolve the deferred NEE visibility (SampleLights add)
                radiance0 = path["radiance"] + where(
                    path["pend_valid"] & ~path["pend_catcher"] & ~occluded,
                    path["pend_contrib"],
                    zero,
                )
                alpha0 = path["alpha"] + where(
                    path["pend_valid"] & path["pend_catcher"] & occluded,
                    path["pend_contrib"],
                    zero,
                )
                path = dict(path, radiance=radiance0, alpha=alpha0)
            else:
                rec, trav_ovf = _closest_hit2(
                    cs, cfg, path["o"], path["d"], cfg.t_min, t_max
                )
            hit = rec.hit & active
            ovf = path["ovf"] + trav_ovf

            footprint = None
            if demand_pool is not None:
                # per-pixel angular footprint at the accumulated hit distance
                pix_ang = 2.0 * length(cam.v) / (
                    h * jnp.maximum(length(cam.w), 1e-9)
                )
                dist = path["plen"] + jnp.where(hit, rec.t, 0.0)
                footprint = dist * pix_ang
            n_hit, mat, albedo, tex_usage = _hit_geometry(
                cs, rec, path["d"], cfg.use_shading_normals,
                demand_pool=demand_pool, demand_mask=hit,
                demand_footprint=footprint,
            )
            if demand_pool is not None:
                path = dict(
                    path,
                    tex_usage=path["tex_usage"] | tex_usage,
                    plen=jnp.where(hit, path["plen"] + rec.t, path["plen"]),
                )
            p_hit = path["o"] + path["d"] * rec.t

            is_catcher = (mat.flags & MATERIAL_FLAG_SHADOW_CATCHER) != 0
            catcher_pass = hit & is_catcher & path["secondary"]
            shaded = hit & ~catcher_pass

            # first-bounce AOVs (deviceProgram.cu:424-427; miss zeroes them)
            is_primary_sweep = depth == 0
            aov_n = where(hit, n_hit, zero)
            aov_a = where(hit, albedo, zero)
            normal_aov = where(is_primary_sweep & active, aov_n, path["normal"])
            albedo_aov = where(is_primary_sweep & active, aov_a, path["albedo"])
            depth_aov = jnp.where(
                is_primary_sweep & active, jnp.where(hit, rec.t, 0.0),
                path["depth_aov"],
            )

            # ---- NEE ----
            eta_o = jnp.where(path["eta"] == 1.0, mat.index_of_refraction(), 1.0)
            wo = -path["d"]

            def ld_pair(st, key1, key2, salt):
                """Low-discrepancy pair for this bounce. sobol: a fresh
                shuffled/scrambled (0,2) pair at EVERY depth; stratified/
                blue: stratum base + stream jitter at depth 0, plain stream
                draws deeper. The stream advance is identical across
                strategies so every other consumer's stream stays aligned."""
                st, j1, j2 = randf2(st)
                if sobol:
                    u1, u2 = _sobol_pair(
                        path["ld_pix"], path["ld_ctr"], depth, salt
                    )
                    return st, (u1, u2)
                u1 = jnp.where(is_primary_sweep, path[key1] + j1 * ldsc, j1)
                u2 = jnp.where(is_primary_sweep, path[key2] + j2 * ldsc, j2)
                return st, (u1, u2)

            plain = shaded & ~is_catcher
            catcher_primary = shaded & is_catcher
            if skip_nee:
                # peeled final bounce (cfg.nee_final_bounce=False): the
                # reference discards this sweep's NEE anyway — skip the
                # sample AND the shadow sweep statically
                state = path["state"]
                shadow_traced = zf > 1.0
                pend = (
                    dict(sh_o=p_hit, sh_d=path["d"], pend_contrib=zero,
                         pend_valid=shadow_traced, pend_catcher=shadow_traced)
                    if cfg.fused_shadows else {}
                )
                radiance = path["radiance"]
                alpha = where(plain, Vec3.ones((n,)), path["alpha"])
            elif cfg.fused_shadows:
                # sample NEE now; its shadow ray rides the NEXT traversal
                st = path["state"]
                u12_nee = None
                if ld:
                    st, u12_nee = ld_pair(st, "ld_n1", "ld_n2", _LD_SALT_NEE)
                state, wi, contrib, nee_valid = _nee_sample(
                    cs, probe, cfg, p_hit, n_hit, wo, mat, albedo,
                    path["eta"], eta_o, st, u12=u12_nee,
                )
                if cfg.nee_rr > 0.0:
                    state, contrib, nee_valid = _nee_rr(
                        cfg, state, path["throughput"], contrib, nee_valid
                    )
                    pend_valid = shaded & nee_valid
                else:
                    # trace the shadow ray for every shaded hit (the reference
                    # traces before checking pdfs, deviceProgram.cu:264-277);
                    # zero out the contribution where the sample is invalid
                    pend_valid = shaded
                pend = dict(
                    sh_o=p_hit,
                    sh_d=wi,
                    pend_contrib=where(
                        nee_valid, path["throughput"] * contrib, zero
                    ),
                    pend_valid=pend_valid,
                    pend_catcher=catcher_primary,
                )
                shadow_traced = pend_valid
                radiance = path["radiance"]
                alpha = where(plain, Vec3.ones((n,)), path["alpha"])
            else:
                st = path["state"]
                u12_nee = None
                if ld:
                    st, u12_nee = ld_pair(st, "ld_n1", "ld_n2", _LD_SALT_NEE)
                state, lit, shadowed, nee_ovf, shadow_traced = _nee(
                    cs, probe, cfg, p_hit, n_hit, wo, mat, albedo,
                    path["eta"], eta_o, shaded, st,
                    throughput=path["throughput"], u12=u12_nee,
                )
                ovf = ovf + nee_ovf
                pend = {}
                radiance = path["radiance"] + where(plain, path["throughput"] * lit, zero)
                alpha = where(plain, Vec3.ones((n,)), path["alpha"])
                alpha = alpha + where(catcher_primary, path["throughput"] * shadowed, zero)

            # emission on primary (non-secondary) hits (:558-560); with
            # emission_all_bounces, emitters light the scene through BSDF paths
            if cfg.emission_all_bounces:
                if area_light is not None:
                    # MIS against the quad-NEE strategy: emissive hits on
                    # secondary rays are down-weighted by the probability the
                    # NEE would have sampled the same point. Only hits that
                    # geometrically lie ON the quad compete with quad-NEE —
                    # other emitters keep full weight; and after a delta
                    # (SPECULAR) bounce bsdf_pdf is a discrete probability,
                    # so the weight is forced to 1 (ADVICE r1).
                    q_pdf = quad_light_pdf(area_light, path["o"], path["d"], rec.t)
                    lc = area_light.corner.broadcast_to((n,))
                    l1 = area_light.v1.broadcast_to((n,))
                    l2 = area_light.v2.broadcast_to((n,))
                    ln = area_light.normal.broadcast_to((n,))
                    rel = p_hit - lc
                    s1 = dot(rel, l1) / jnp.maximum(dot(l1, l1), 1e-12)
                    s2 = dot(rel, l2) / jnp.maximum(dot(l2, l2), 1e-12)
                    on_quad = (
                        (jnp.abs(dot(rel, ln)) <= 1e-3 * jnp.sqrt(area_light.area))
                        & (s1 >= -1e-4) & (s1 <= 1.0 + 1e-4)
                        & (s2 >= -1e-4) & (s2 <= 1.0 + 1e-4)
                    )
                    w_emit = jnp.where(
                        path["secondary"] & on_quad & ~path["prev_delta"],
                        path["bsdf_pdf"]
                        / jnp.maximum(path["bsdf_pdf"] + q_pdf, 1e-12),
                        1.0,
                    )
                    radiance = radiance + where(
                        plain, path["throughput"] * mat.emission * w_emit, zero
                    )
                else:
                    radiance = radiance + where(
                        plain, path["throughput"] * mat.emission, zero
                    )
            else:
                radiance = radiance + where(
                    plain & ~path["secondary"], mat.emission, zero
                )

            # parallelogram-light NEE (new capability; LaunchParams.light is
            # never sampled by the reference)
            if area_light is not None and not skip_nee:
                state, quad_contrib, quad_ovf = _quad_nee(
                    cs, cfg, area_light, p_hit, n_hit, wo, mat, albedo,
                    path["eta"], eta_o, plain & (mat.emission.x + mat.emission.y + mat.emission.z == 0.0), state,
                )
                ovf = ovf + quad_ovf
                radiance = radiance + where(
                    plain, path["throughput"] * quad_contrib, zero
                )

            # env on BSDF-sampled misses with MIS (the reference's
            # commented-out __miss__radiance block, deviceProgram.cu:214-224)
            if cfg.env_via_bsdf:
                miss_sec = active & ~rec.hit & path["secondary"]
                sky_pdf = probe_pdf(probe, path["d"])
                nt = cfg.probe_samples + cfg.bsdf_samples
                cb = cfg.bsdf_samples / nt
                csk = cfg.probe_samples / nt
                mw = cb * path["bsdf_pdf"] / jnp.maximum(
                    cb * path["bsdf_pdf"] + csk * sky_pdf, 1e-12
                )
                env = probe_eval_dir(probe, path["d"])
                radiance = radiance + where(
                    miss_sec, path["throughput"] * env * mw, zero
                )

            if skip_nee:
                # peeled final bounce: the continuation state (o/d/throughput/
                # eta/done/bsdf_pdf) is never consumed again, so the Disney
                # sample/eval below is skipped statically as well
                rays = path["rays"] + jnp.sum(active.astype(jnp.float32))
                if cfg.fused_shadows:
                    # the combined sweep still traced the PREVIOUS bounce's
                    # pending shadow rays — count them
                    rays = rays + jnp.sum(path["pend_valid"].astype(jnp.float32))
                out = dict(
                    path, radiance=radiance, alpha=alpha, normal=normal_aov,
                    albedo=albedo_aov, depth_aov=depth_aov, state=state,
                    rays=rays, ovf=ovf,
                )
                out.update(pend)
                return out

            # ---- BSDF continuation ----
            tb, bb = basis_from_vector(n_hit)
            u12_bsdf = None
            if ld:
                state, u12_bsdf = ld_pair(state, "ld_b1", "ld_b2", _LD_SALT_BSDF)
            state, res = disney.bsdf_sample(
                mat, path["eta"], eta_o, tb, bb, n_hit, wo, state, u12=u12_bsdf
            )
            f = disney.bsdf_eval(
                mat, albedo, path["eta"], eta_o, n_hit, wo, res.light
            )
            cos_term = jnp.abs(dot(n_hit, res.light))
            new_tp = path["throughput"] * f * (cos_term / jnp.maximum(res.pdf, 1e-12))
            transmit = dot(res.light, n_hit) <= 0.0
            new_eta = jnp.where(transmit, eta_o, path["eta"])

            bsdf_dead = shaded & (res.pdf <= 0.0)
            cont = shaded & ~bsdf_dead

            rr_kill = jnp.zeros_like(cont)
            if cfg.russian_roulette:
                # unbiased roulette on the CONTINUATION throughput: E[tp/p] =
                # tp; the draw is taken unconditionally so the RNG stream
                # stays lane-uniform (dead lanes just discard it)
                state, u_rr = randf(state)
                p_surv = jnp.clip(luminance(new_tp), cfg.rr_min_prob, 1.0)
                do_rr = cont & (depth >= cfg.rr_start_depth)
                rr_kill = do_rr & (u_rr >= p_surv)
                boost = jnp.where(do_rr & ~rr_kill, 1.0 / p_surv, 1.0)
                new_tp = new_tp * boost
                cont = cont & ~rr_kill

            # shadow-catcher passthrough: continue straight through (:503-508)
            new_o = where(catcher_pass, p_hit, where(cont, p_hit, path["o"]))
            new_d = where(cont, res.light, path["d"])  # passthrough keeps d
            throughput = where(cont, new_tp, path["throughput"])
            eta = jnp.where(cont, new_eta, path["eta"])
            done = path["done"] | (active & ~rec.hit) | bsdf_dead | rr_kill
            secondary = path["secondary"] | cont

            shadow_count = (
                path["pend_valid"] if cfg.fused_shadows else shadow_traced
            )
            rays = path["rays"] + jnp.sum(active.astype(jnp.float32)) + jnp.sum(
                shadow_count.astype(jnp.float32)
            )
            out = dict(
                o=new_o,
                d=new_d,
                throughput=throughput,
                eta=eta,
                radiance=radiance,
                alpha=alpha,
                normal=normal_aov,
                albedo=albedo_aov,
                depth_aov=depth_aov,
                done=done,
                secondary=secondary,
                state=state,
                rays=rays,
                ovf=ovf,
                bsdf_pdf=jnp.where(cont, res.pdf, path["bsdf_pdf"]),
                prev_delta=jnp.where(
                    cont, res.event == disney.SPECULAR, path["prev_delta"]
                ),
            )
            out.update(pend)
            if sorting:
                out["idx"] = path["idx"]
            if ld:
                keys = ("ld_pix", "ld_ctr") if sobol else (
                    "ld_n1", "ld_n2", "ld_b1", "ld_b2")
                for k in keys:
                    out[k] = path[k]
            if demand_pool is not None:
                out["tex_usage"] = path["tex_usage"]
                out["plen"] = path["plen"]
            return out

        # fused mode needs one extra iteration to flush the last shadow rays
        if cfg.nee_final_bounce:
            n_bounce_iters = cfg.max_depth + (2 if cfg.fused_shadows else 1)
            peel = 0
        else:
            # the final bounce is PEELED out of the loop and runs with
            # skip_nee=True (static: its shadow sweep never compiles in);
            # fused mode then needs no flush iteration — the peeled bounce's
            # combined sweep resolves the last pending shadows
            n_bounce_iters = cfg.max_depth
            peel = 1
        if cfg.unroll:
            for _depth in range(n_bounce_iters):
                path = bounce_body(jnp.int32(_depth), path)
        else:
            path = jax.lax.fori_loop(0, n_bounce_iters, bounce_body, path)
        if peel:
            path = bounce_body(jnp.int32(cfg.max_depth), path, skip_nee=True)

        if sorting:
            # restore caller lane order: sort (idx, iota) for the inverse
            # permutation (idx is unique), then one packed-row gather
            _, inv = jax.lax.sort(
                [path["idx"], jax.lax.iota(jnp.uint32, n)], num_keys=1
            )
            outs = [
                path["radiance"].x, path["radiance"].y, path["radiance"].z,
                path["alpha"].x, path["alpha"].y, path["alpha"].z,
                path["normal"].x, path["normal"].y, path["normal"].z,
                path["albedo"].x, path["albedo"].y, path["albedo"].z,
                path["depth_aov"],
            ]
            restored = permute_packed(outs, inv)
            path = dict(
                path,
                radiance=Vec3(*restored[0:3]),
                alpha=Vec3(*restored[3:6]),
                normal=Vec3(*restored[6:9]),
                albedo=Vec3(*restored[9:12]),
                depth_aov=restored[12],
            )

        return (
            acc_color + path["radiance"],
            acc_alpha + path["alpha"],
            acc_normal + path["normal"],
            acc_albedo + path["albedo"],
            acc_depth + path["depth_aov"],
            backplate,  # last sample's backplate, as in the reference
            acc_rays + path["rays"],
            acc_ovf + path["ovf"],
            acc_usage | path["tex_usage"] if demand_pool is not None else acc_usage,
        )

    # tied to the sharded pixel inputs (zero_scalar) so the carry is
    # device-varying under shard_map, like every other accumulator
    usage0 = jnp.zeros(
        (demand_pool.num_pages if demand_pool is not None else 1,), jnp.bool_
    ) & (zero_scalar < 1.0)
    init = (zero, zero, zero, zero, zf, zero, zero_scalar, zero_scalar, usage0)
    if cfg.unroll:
        carry = init
        for _s in range(loop_spp):
            carry = sample_body(jnp.uint32(_s), carry)
        (color, alpha, normal, albedo, depth, backplate, rays, ovf_total,
         usage) = carry
    else:
        (color, alpha, normal, albedo, depth, backplate, rays, ovf_total,
         usage) = jax.lax.fori_loop(0, loop_spp, sample_body, init)

    if batch:
        # fold the expanded lanes back to per-pixel sums
        def fold(v: Vec3, reduce="sum") -> Vec3:
            def f(a):
                r = a.reshape(spp, n_pix)
                return r.sum(0) if reduce == "sum" else r.mean(0)

            return Vec3(f(v.x), f(v.y), f(v.z))

        color = fold(color)
        alpha = fold(alpha)
        normal = fold(normal)
        albedo = fold(albedo)
        depth = depth.reshape(spp, n_pix).sum(0)
        backplate = fold(backplate, reduce="mean")

    # fused-lane launches are per-lane single samples: no spp normalization
    sppf = jnp.float32(1 if fused_lanes else spp)
    alpha = alpha / sppf
    normal = normal / sppf
    albedo = albedo / sppf
    depth = depth / sppf
    # composite over backplate (deviceProgram.cu:454): spp-summed radiance
    # plus backplate weighted by uncovered fraction
    color = backplate * sppf * (1.0 - alpha) + color
    return SampleOutput(
        color=color, alpha=alpha, normal=normal, albedo=albedo, depth=depth,
        rays_traced=rays, bfs_overflow=ovf_total,
        tex_usage=usage if demand_pool is not None else None,
    )


def accumulate(
    prev: Vec3, new_color: Vec3, subframe: Array, spp: int, clamp_val: float
) -> Vec3:
    """Progressive accumulation (deviceProgram.cu:458-467):
    accum = lerp(prev, clamp(new/spp, 0, clamp), 1/(subframe+1))."""
    cur = new_color * (1.0 / spp)
    cur_clamped = Vec3(
        jnp.clip(cur.x, 0.0, clamp_val),
        jnp.clip(cur.y, 0.0, clamp_val),
        jnp.clip(cur.z, 0.0, clamp_val),
    )
    a = 1.0 / (subframe.astype(jnp.float32) + 1.0)
    blended = prev + (cur_clamped - prev) * a
    first = subframe == 0
    return where(jnp.broadcast_to(first, jnp.shape(cur.x)), cur, blended)
