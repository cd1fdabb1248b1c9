"""BSDF validation — the chi-square / furnace tests the reference only
sketched in its commented-out BSDFTest harness (Disney.cuh:430-503)."""
import numpy as np
import jax
import jax.numpy as jnp

from optixpathtracer.core.materials import build_table, make_material
from optixpathtracer.core.math import Vec3, basis_from_vector, dot, normalize
from optixpathtracer.core.rng import RngState
from optixpathtracer.shade import disney


def _mat_batch(n, **over):
    table = build_table([make_material(**over)])
    return table.take(jnp.zeros(n, jnp.int32))


def _frame(n):
    nrm = Vec3.of(np.zeros(n, np.float32), np.zeros(n, np.float32), np.ones(n, np.float32))
    u, v = basis_from_vector(nrm)
    return u, v, nrm


def _view(n, theta=0.5):
    return Vec3.of(
        np.full(n, np.sin(theta), np.float32),
        np.zeros(n, np.float32),
        np.full(n, np.cos(theta), np.float32),
    )


def test_eval_nonnegative_finite():
    n = 4096
    rng = np.random.default_rng(1)
    for over in [dict(), dict(roughness=0.1, metallic=1.0), dict(transmission=0.9), dict(subsurface=0.5), dict(clearcoat=1.0)]:
        mat = _mat_batch(n, **over)
        _, _, nrm = _frame(n)
        v = _view(n)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        l = normalize(Vec3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2])))
        albedo = Vec3.full((n,), 0.7)
        f = disney.bsdf_eval(mat, albedo, jnp.ones(n), jnp.full(n, 1.5), nrm, v, l)
        arr = np.asarray(f.to_array())
        assert np.all(np.isfinite(arr)), over
        assert np.all(arr >= -1e-6), over


def test_sample_pdf_positive_and_consistent():
    """pdf returned by sample must match bsdf_pdf at the sampled direction."""
    n = 8192
    mat = _mat_batch(n, roughness=0.4)
    u, v, nrm = _frame(n)
    view = _view(n)
    st = RngState.for_pixels(jnp.arange(n, dtype=jnp.uint32), 0)
    _, res = disney.bsdf_sample(mat, jnp.ones(n), jnp.full(n, 1.5), u, v, nrm, view, st)
    pdf2 = disney.bsdf_pdf(mat, jnp.ones(n), jnp.full(n, 1.5), nrm, view, res.light)
    p1 = np.asarray(res.pdf)
    p2 = np.asarray(pdf2)
    ok = p1 > 0
    # GGX reflection at roughness 0.4 puts a few % of samples below the
    # horizon (pdf 0 -> path terminates, reference behavior)
    assert ok.mean() > 0.85
    np.testing.assert_allclose(p1[ok], p2[ok], rtol=1e-4)


def test_sampled_directions_histogram_matches_pdf():
    """Chi-square: bin sampled directions over the sphere; compare observed
    frequency with pdf * solid angle."""
    n = 1 << 17
    mat = _mat_batch(n, roughness=0.6)
    u, v, nrm = _frame(n)
    view = _view(n)
    st = RngState.for_pixels(jnp.arange(n, dtype=jnp.uint32), 7)
    _, res = disney.bsdf_sample(mat, jnp.ones(n), jnp.full(n, 1.5), u, v, nrm, view, st)

    lz = np.asarray(res.light.z)
    lphi = np.arctan2(np.asarray(res.light.y), np.asarray(res.light.x))
    # bins over upper hemisphere (diffuse material: all samples reflect)
    nb_z, nb_p = 8, 8
    zi = np.clip(((lz + 1) / 2 * nb_z).astype(int), 0, nb_z - 1)
    pi_ = np.clip(((lphi + np.pi) / (2 * np.pi) * nb_p).astype(int), 0, nb_p - 1)
    counts = np.zeros((nb_z, nb_p))
    np.add.at(counts, (zi, pi_), 1.0)

    # expected from pdf at bin centers
    zc = (np.arange(nb_z) + 0.5) / nb_z * 2 - 1
    pc = (np.arange(nb_p) + 0.5) / nb_p * 2 * np.pi - np.pi
    zz, pp = np.meshgrid(zc, pc, indexing="ij")
    sz = np.sqrt(np.maximum(0, 1 - zz**2))
    ln = Vec3(
        jnp.asarray((sz * np.cos(pp)).ravel().astype(np.float32)),
        jnp.asarray((sz * np.sin(pp)).ravel().astype(np.float32)),
        jnp.asarray(zz.ravel().astype(np.float32)),
    )
    m = zz.size
    matm = _mat_batch(m, roughness=0.6)
    nrm_m = Vec3.of(np.zeros(m, np.float32), np.zeros(m, np.float32), np.ones(m, np.float32))
    view_m = _view(m)
    pdf = np.asarray(
        disney.bsdf_pdf(matm, jnp.ones(m), jnp.full(m, 1.5), nrm_m, view_m, ln)
    ).reshape(nb_z, nb_p)
    solid_angle = (2.0 / nb_z) * (2 * np.pi / nb_p)
    expected = pdf * solid_angle * n
    mask = expected > 80
    rel = np.abs(counts[mask] - expected[mask]) / expected[mask]
    assert np.median(rel) < 0.08, (np.median(rel), rel.max())


def test_furnace_energy_conservation():
    """White-ish furnace: integral of f * cos over the sphere <= ~1 for a
    non-emissive diffuse material (Monte Carlo with BSDF sampling)."""
    n = 1 << 17
    mat = _mat_batch(n, color=(1.0, 1.0, 1.0), roughness=0.8)
    u, v, nrm = _frame(n)
    view = _view(n, theta=0.3)
    st = RngState.for_pixels(jnp.arange(n, dtype=jnp.uint32), 13)
    _, res = disney.bsdf_sample(mat, jnp.ones(n), jnp.full(n, 1.5), u, v, nrm, view, st)
    f = disney.bsdf_eval(
        mat, Vec3.full((n,), 1.0), jnp.ones(n), jnp.full(n, 1.5), nrm, view, res.light
    )
    w = np.asarray(dot(res.light, nrm))
    pdf = np.asarray(res.pdf)
    val = np.asarray(f.x) * np.abs(w) / np.maximum(pdf, 1e-8)
    val = np.where(pdf > 1e-6, val, 0.0)
    mean = val.mean()
    assert mean < 1.25, mean  # allow some specular-lobe estimator noise
    assert mean > 0.3, mean  # and it shouldn't lose all energy


def test_fresnel_limits():
    f0 = disney.fresnel_dielectric(jnp.asarray([1.0]), jnp.asarray([1.0]), jnp.asarray([1.5]))
    # normal incidence: ((1-1.5)/(2.5))^2 = 0.04
    np.testing.assert_allclose(np.asarray(f0)[0], 0.04, atol=1e-3)
    fg = disney.fresnel_dielectric(jnp.asarray([0.01]), jnp.asarray([1.0]), jnp.asarray([1.5]))
    assert float(np.asarray(fg)[0]) > 0.9  # grazing -> ~1
    # TIR from the dense side
    ft = disney.fresnel_dielectric(jnp.asarray([0.3]), jnp.asarray([1.5]), jnp.asarray([1.0]))
    np.testing.assert_allclose(np.asarray(ft)[0], 1.0)


def test_gtr2_normalized():
    """GTR2 is a normalized NDF: integral over hemisphere of D*cos = 1."""
    nth = 4096
    th = (np.arange(nth) + 0.5) / nth * (np.pi / 2)
    for a in (0.1, 0.5, 0.9):
        d = np.asarray(disney.gtr2(jnp.asarray(np.cos(th), jnp.float32), jnp.float32(a)))
        integral = np.sum(d * np.cos(th) * np.sin(th)) * (np.pi / 2 / nth) * 2 * np.pi
        np.testing.assert_allclose(integral, 1.0, rtol=2e-2)


def test_bsdf_eval_joint_affine_in_albedo_and_cspec0():
    """The eval is jointly affine in (albedo, cspec0) — the contract the
    spectral engine's exact per-wavelength reconstruction rests on
    (engine/spectral.py): three overridden evals + the per-lambda cspec0
    rebuild must reproduce the full RGB eval for EVERY material class,
    including specular-tinted ones (ctint is the one non-affine path and
    lives entirely inside cspec0)."""
    import numpy as np

    from optixpathtracer.core.materials import build_table, make_material

    rng = np.random.default_rng(5)
    n = 256

    def vec(a):
        return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))

    nrm = np.zeros((n, 3), np.float32)
    nrm[:, 2] = 1
    v = rng.normal(0, 1, (n, 3)).astype(np.float32)
    v[:, 2] = np.abs(v[:, 2]) + 0.1
    l = rng.normal(0, 1, (n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    l /= np.linalg.norm(l, axis=1, keepdims=True)
    nv, vv, lv = vec(nrm), vec(v), vec(l)
    eta_i = jnp.ones(n)
    alb = np.array([0.7, 0.4, 0.15], np.float32)
    cases = [
        dict(),
        dict(metallic=1.0),
        dict(metallic=0.5, roughness=0.3),
        dict(transmission=1.0, eta=1.5),
        dict(subsurface=0.6),
        dict(clearcoat=1.0),
        dict(specular_tint=1.0, metallic=0.4, roughness=0.3),
        dict(specular_tint=0.7, transmission=0.8, eta=1.5),
    ]
    for kw in cases:
        mt = build_table([make_material(color=(0.6, 0.3, 0.2), **kw)]).take(
            jnp.zeros(n, jnp.int32))
        eta_o = jnp.where(eta_i == 1.0, mt.index_of_refraction(), 1.0)
        av = Vec3(jnp.full(n, alb[0]), jnp.full(n, alb[1]), jnp.full(n, alb[2]))
        truth = disney.bsdf_eval(mt, av, eta_i, eta_o, nv, vv, lv)
        zero, one = Vec3.zeros((n,)), Vec3.ones((n,))
        f00 = disney.bsdf_eval(mt, zero, eta_i, eta_o, nv, vv, lv,
                               cspec0_override=zero)
        f10 = disney.bsdf_eval(mt, one, eta_i, eta_o, nv, vv, lv,
                               cspec0_override=zero)
        f01 = disney.bsdf_eval(mt, zero, eta_i, eta_o, nv, vv, lv,
                               cspec0_override=one)
        lum = 0.3 * alb[0] + 0.6 * alb[1] + 0.1 * alb[2]
        tint = kw.get("specular_tint", 0.0)
        m = kw.get("metallic", 0.0)
        spec = 0.5  # make_material default
        cspec = (1 + tint * (alb / lum - 1)) * 0.08 * spec * (1 - m) + m * alb
        truth_ch = [truth.x, truth.y, truth.z]
        f00_ch = [f00.x, f00.y, f00.z]  # chromatic base (subsurface color)
        for ch in range(3):
            pred = (f00_ch[ch] + (f10.x - f00.x) * alb[ch]
                    + (f01.x - f00.x) * cspec[ch])
            err = np.max(np.abs(np.asarray(pred - truth_ch[ch]))
                         / (np.abs(np.asarray(truth_ch[ch])) + 1e-6))
            assert err < 1e-5, (kw, ch, err)
