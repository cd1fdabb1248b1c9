"""Curve-primitive intersector tests (ops/curve_intersect.py).

The reference has no curve intersector to compare against (OptiX hardware
supplies it; /root/reference/cuda/curve.h ships only shading helpers), so
correctness is pinned against analytic closed forms (cylinder, sphere) and
a brute-force swept-sphere oracle (dense u-sampling of the exact polynomial).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from optixpathtracer.core.math import Vec3
from optixpathtracer.ops.curve_intersect import (
    CurveScene,
    any_hit_curves,
    build_curves,
    closest_hit_curves,
)

MAT = [{"name": "m"}]


def _mat():
    from optixpathtracer.core.materials import make_material

    return [make_material(color=(0.8, 0.4, 0.2))]


def _rays(origins, dirs):
    o = np.asarray(origins, np.float32)
    d = np.asarray(dirs, np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (
        Vec3(jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]), jnp.asarray(o[:, 2])),
        Vec3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2])),
    )


def test_linear_segment_is_a_capsule():
    # straight segment along x in [0, 2], radius 0.5: a perpendicular ray
    # aimed at its middle from y=+5 must hit at t = 5 - 0.5 exactly
    cp = [[[0, 0, 0, 0.5], [2, 0, 0, 0.5]]]
    scene = build_curves(cp, _mat())
    o, d = _rays([[1, 5, 0], [1, 5, 0], [-2, 5, 0]], [[0, -1, 0], [0, 1, 0], [0, -1, 0]])
    rec = closest_hit_curves(scene, o, d)
    t = np.asarray(rec.t)
    assert abs(t[0] - 4.5) < 1e-4
    assert not bool(np.asarray(rec.hit)[1])  # points away
    assert not bool(np.asarray(rec.hit)[2])  # misses to the side (x=-2 < -r)
    # lateral normal is radial: +y, perpendicular to the axis
    n = rec.normal
    assert abs(float(n.y[0]) - 1.0) < 1e-5
    assert abs(float(n.x[0])) < 1e-5


def test_linear_round_endcap():
    # ray down the axis hits the round endcap sphere at x = -0.5
    cp = [[[0, 0, 0, 0.5], [2, 0, 0, 0.5]]]
    scene = build_curves(cp, _mat())
    o, d = _rays([[-4, 0, 0]], [[1, 0, 0]])
    rec = closest_hit_curves(scene, o, d)
    assert abs(float(rec.t[0]) - 3.5) < 1e-4
    assert float(rec.normal.x[0]) < -0.99  # cap normal faces the ray


def test_degenerate_segment_matches_sphere():
    # a near-zero-length constant-radius segment behaves like a sphere
    eps = 1e-4
    cp = [[[0, 0, 0, 1.0], [eps, 0, 0, 1.0]]]
    scene = build_curves(cp, _mat())
    phi = np.linspace(0.1, np.pi - 0.1, 16)
    origins = np.stack([4 * np.cos(phi), 4 * np.sin(phi), np.zeros_like(phi)], 1)
    o, d = _rays(origins, -origins)
    rec = closest_hit_curves(scene, o, d)
    t = np.asarray(rec.t)
    assert np.asarray(rec.hit).all()
    assert np.abs(t - 3.0).max() < 2e-3  # |o| = 4, r = 1


@pytest.mark.slow
def test_cubic_vs_swept_sphere_oracle(rng):
    # cubic b-spline arc with varying radius; oracle = min over a dense
    # u-sampling of |closest(ray, sphere(c(u), r(u)))|
    q = np.array(
        [[[-1.5, 0.0, 0.0, 0.30], [-0.5, 1.2, 0.3, 0.22],
          [0.5, 1.2, -0.3, 0.16], [1.5, 0.0, 0.0, 0.10]]], np.float32)
    scene = build_curves(q, _mat())

    n_rays = 64
    origins = np.stack(
        [rng.uniform(-2, 2, n_rays), np.full(n_rays, 4.0),
         rng.uniform(-1, 1, n_rays)], 1).astype(np.float32)
    targets = np.stack(
        [rng.uniform(-1.2, 1.2, n_rays), rng.uniform(0.0, 1.0, n_rays),
         rng.uniform(-0.3, 0.3, n_rays)], 1).astype(np.float32)
    o, d = _rays(origins, targets - origins)
    rec = closest_hit_curves(scene, o, d)

    # oracle: exact polynomial evaluated densely
    from optixpathtracer.core import curves as cv

    uu = np.linspace(0, 1, 4096, dtype=np.float32)
    p = scene.p
    c = np.stack([np.asarray(cv.position4(p, jnp.full((1,), float(u)))[0])
                  for u in uu])  # (U, 4)
    on = np.stack([np.asarray(o.x), np.asarray(o.y), np.asarray(o.z)], 1)
    dn = np.stack([np.asarray(d.x), np.asarray(d.y), np.asarray(d.z)], 1)
    oc = on[:, None, :] - c[None, :, :3]  # (R, U, 3)
    b = np.einsum("ruk,rk->ru", oc, dn)
    cc = (oc * oc).sum(-1) - c[None, :, 3] ** 2
    h = b * b - cc
    t_sph = np.where(h >= 0, -b - np.sqrt(np.maximum(h, 0)), np.inf)
    t_sph = np.where(t_sph > 1e-3, t_sph, np.inf)
    t_ref = t_sph.min(1)

    t = np.asarray(rec.t)
    hit = np.asarray(rec.hit)
    ref_hit = np.isfinite(t_ref)
    # the sphere-sampled oracle under-covers the tube between samples and
    # the cone chain slightly over-covers between flatten points: compare
    # where both agree there is a hit, and allow the flattening tolerance
    both = hit & ref_hit
    assert both.sum() >= ref_hit.sum() - 2
    # grazing incidence amplifies surface error by 1/|cos|: gate the tight
    # tolerance on non-grazing hits, bound grazing ones loosely
    nrm = np.stack([np.asarray(rec.normal.x), np.asarray(rec.normal.y),
                    np.asarray(rec.normal.z)], 1)
    cosi = np.abs((nrm * dn).sum(1))
    steep = both & (cosi > 0.25)
    assert steep.sum() > both.sum() // 2
    assert np.abs(t[steep] - t_ref[steep]).max() < 2e-3
    assert np.abs(t[both] - t_ref[both]).max() < 3e-2
    # u parameter: re-evaluating the curve at rec.u must sit within a
    # radius of the hit point
    u_hat = np.asarray(rec.u)[both]
    pt = np.stack([np.asarray(rec.point.x), np.asarray(rec.point.y),
                   np.asarray(rec.point.z)], 1)[both]
    c_hat = np.stack([np.asarray(cv.position4(p, jnp.full((1,), float(u)))[0])
                      for u in u_hat])
    dist = np.linalg.norm(pt - c_hat[:, :3], axis=1)
    assert (dist < c_hat[:, 3] * 1.35 + 5e-3).all()


def test_any_hit_occlusion():
    cp = [[[0, 0, 0, 0.5], [2, 0, 0, 0.5]]]
    scene = build_curves(cp, _mat())
    o, d = _rays([[1, 5, 0], [5, 5, 0]], [[0, -1, 0], [0, -1, 0]])
    occ = np.asarray(any_hit_curves(scene, o, d))
    assert bool(occ[0]) and not bool(occ[1])
    # segment limit: the blocker is beyond t_max
    occ2 = np.asarray(any_hit_curves(scene, o, d, t_max=4.0))
    assert not bool(occ2[0])


def test_multi_segment_closest_wins():
    # two parallel tubes; the nearer one must win and report its seg id
    cp = [
        [[0, 0, 0, 0.3], [2, 0, 0, 0.3]],
        [[0, 2, 0, 0.3], [2, 2, 0, 0.3]],
    ]
    scene = build_curves(cp, _mat(), material_ids=[0, 0])
    o, d = _rays([[1, 5, 0]], [[0, -1, 0]])
    rec = closest_hit_curves(scene, o, d)
    assert int(rec.seg[0]) == 1  # tube at y=2 is closer from y=5
    assert abs(float(rec.t[0]) - 2.7) < 1e-4


@pytest.mark.slow
def test_whitted_engine_traces_curves():
    # a thick curve arching over the whitted floor must be visible in the
    # frame and cast a point-light shadow (engine-level integration)
    import jax
    from optixpathtracer.builder import compile_scene
    from optixpathtracer.core.camera import Camera
    from optixpathtracer.core.materials import make_material
    from optixpathtracer.core.scene import HostScene
    from optixpathtracer.engine.whitted import WhittedConfig
    from optixpathtracer.lights.lights import (
        build_lights, make_ambient_light, make_point_light)
    from optixpathtracer.models.whitted import WhittedRenderer

    hs = HostScene()
    hs.add_box(make_material(color=(0.75, 0.75, 0.75), roughness=0.9),
               pos=(0, -0.15, 0), extent=(8, 0.15, 8))
    cs = compile_scene(hs)
    q = [[[-2.5, 0.0, 0.0, 0.45], [-1.0, 2.8, 0.0, 0.40],
          [1.0, 2.8, 0.0, 0.35], [2.5, 0.0, 0.0, 0.30]]]
    curves_scene = build_curves(q, [make_material(color=(0.9, 0.25, 0.2),
                                                  roughness=0.5)])
    lights = build_lights([
        make_point_light((0.0, 9.0, 1.0), (1.0, 1.0, 1.0), intensity=140.0),
        make_ambient_light((1.0, 1.0, 1.0), 0.10),
    ])
    W, H = 96, 72
    cfg = WhittedConfig(width=W, height=H, max_depth=1, antialias=False)
    cam = Camera(eye=(0.0, 2.2, 8.0), lookat=(0.0, 1.0, 0.0), up=(0, 1, 0),
                 fov_y=40, aspect_ratio=W / H)
    r = WhittedRenderer(None, cs, lights, cfg, cam, curves=curves_scene)
    img = r.render()  # (H, W, 3) float in [0, 1]
    # the tube is red: center-top region must be red-dominant
    mid = img[H // 4: H // 2, :, :]
    red_frac = ((mid[..., 0] > mid[..., 1] * 1.5) & (mid[..., 0] > 0.1)).mean()
    assert red_frac > 0.05
    # shadow: in the center column band, the floor rows under the arch
    # (just below the image midline for this camera) are darker than the
    # lit floor rows further down the frame
    band = img[:, W // 3: 2 * W // 3, :].mean(-1)
    under = band[int(H * 0.50): int(H * 0.61)].mean()
    lit = band[int(H * 0.72): int(H * 0.95)].mean()
    assert under < lit * 0.92
