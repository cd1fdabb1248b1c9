import numpy as np
import jax.numpy as jnp

from optixpathtracer.core.math import Vec3, normalize
from optixpathtracer.core.rng import RngState
from optixpathtracer.lights import probe as P


def _gradient_probe(w=64, h=32):
    rng = np.random.default_rng(3)
    img = rng.random((h, w, 3)).astype(np.float32) + 0.01
    img[h // 4, w // 3] = 50.0  # a bright texel to stress importance sampling
    return P.build_probe(img), img


def test_cdf_monotone_and_normalized():
    p, _ = _gradient_probe()
    cy = np.asarray(p.cdf_y)
    assert np.all(np.diff(cy) >= -1e-6)
    np.testing.assert_allclose(cy[-1], 1.0, rtol=1e-5)
    cx = np.asarray(p.cdf_x)
    assert np.all(np.diff(cx, axis=1) >= -1e-6)
    np.testing.assert_allclose(cx[:, -1], 1.0, rtol=1e-5)


def test_uv_dir_roundtrip():
    rng = np.random.default_rng(5)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    dv = normalize(Vec3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2])))
    u, v = P.dir_to_uv(dv)
    back = P.uv_to_dir(u, v)
    np.testing.assert_allclose(
        np.asarray(back.to_array()), np.asarray(dv.to_array()), atol=2e-3
    )


def test_sample_eval_agree():
    """Sampled color must equal the image texel at the chosen (row, col); the
    returned direction must map back to within one texel (it sits exactly on
    the texel's lower edge, reference ProbeSample convention)."""
    p, img = _gradient_probe()
    st = RngState.for_pixels(jnp.arange(2048, dtype=jnp.uint32), 0)
    _, d, color, pdf, row, col = P.probe_sample_texel(p, st)
    row = np.asarray(row)
    col = np.asarray(col)
    np.testing.assert_allclose(
        np.asarray(color.to_array()), img[row, col], rtol=1e-5
    )
    u, v = P.dir_to_uv(d)
    ok = np.asarray(pdf) > 0  # pole rows (sin theta == 0) are pdf-0 and phi-degenerate
    col2 = np.asarray(u) * img.shape[1]
    row2 = np.asarray(v) * img.shape[0]
    dc = np.abs(col2 - col)
    dc = np.minimum(dc, img.shape[1] - dc)  # phi wraps around
    assert np.all(dc[ok] <= 1.0 + 1e-3)
    assert np.all(np.abs(row2 - row)[ok] <= 1.0 + 1e-3)


def test_importance_sampling_prefers_bright_texel():
    p, img = _gradient_probe()
    st = RngState.for_pixels(jnp.arange(1 << 14, dtype=jnp.uint32), 1)
    _, d, color, pdf = P.probe_sample(p, st)
    # the bright texel has ~50/sum of total luminance; it should be sampled
    # far more often than 1/(w*h)
    # bright texel's luminance share is ~50/(0.5*2048+50) ~ 4.6%; uniform
    # would be 1/2048 ~ 0.05% — assert importance sampling multiplies it ~60x
    bright = np.asarray(color.x) > 10.0
    assert bright.mean() > 0.03


def test_mc_integral_matches_riemann():
    """E[L/pdf] over probe samples == integral of L over the sphere."""
    p, img = _gradient_probe()
    st = RngState.for_pixels(jnp.arange(1 << 15, dtype=jnp.uint32), 2)
    _, d, color, pdf = P.probe_sample(p, st)
    pdf_np = np.asarray(pdf)
    est = np.divide(
        np.asarray(color.x), pdf_np, out=np.zeros_like(pdf_np), where=pdf_np > 0
    ).mean()

    h, w = img.shape[:2]
    v = (np.arange(h) + 0.5) / h
    sin_t = np.sin(v * np.pi)
    riemann = (img[..., 0] * sin_t[:, None]).sum() * (np.pi / h) * (2 * np.pi / w)
    np.testing.assert_allclose(est, riemann, rtol=0.05)


def test_pdf_integrates_to_one():
    """Riemann sum of probe_pdf over the sphere == 1."""
    p, _ = _gradient_probe()
    h, w = 64, 128
    v, u = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
    d = P.uv_to_dir(jnp.asarray(u.ravel(), jnp.float32), jnp.asarray(v.ravel(), jnp.float32))
    pdf = np.asarray(P.probe_pdf(p, d)).reshape(h, w)
    sin_t = np.sin(((np.arange(h) + 0.5) / h) * np.pi)
    total = (pdf * sin_t[:, None]).sum() * (np.pi / h) * (2 * np.pi / w)
    np.testing.assert_allclose(total, 1.0, rtol=0.05)


def test_gaussian_prefilter_stays_unbiased():
    """Prefiltered CDF (OptixUtils/Texture.cpp:5-40 parity): the MC estimate
    E[L/pdf] must still equal the sphere integral (pdf matches what is
    actually sampled), and the pdf must stay normalized."""
    _, img = _gradient_probe()
    p = P.build_probe(img, gaussian_prefilter=True)
    st = RngState.for_pixels(jnp.arange(1 << 15, dtype=jnp.uint32), 5)
    _, d, color, pdf = P.probe_sample(p, st)
    pdf_np = np.asarray(pdf)
    est = np.divide(
        np.asarray(color.x), pdf_np, out=np.zeros_like(pdf_np), where=pdf_np > 0
    ).mean()
    h, w = img.shape[:2]
    v = (np.arange(h) + 0.5) / h
    sin_t = np.sin(v * np.pi)
    riemann = (img[..., 0] * sin_t[:, None]).sum() * (np.pi / h) * (2 * np.pi / w)
    np.testing.assert_allclose(est, riemann, rtol=0.05)

    vv, uu = np.meshgrid((np.arange(64) + 0.5) / 64, (np.arange(128) + 0.5) / 128, indexing="ij")
    dd = P.uv_to_dir(jnp.asarray(uu.ravel(), jnp.float32), jnp.asarray(vv.ravel(), jnp.float32))
    pdfs = np.asarray(P.probe_pdf(p, dd)).reshape(64, 128)
    sint = np.sin(((np.arange(64) + 0.5) / 64) * np.pi)
    total = (pdfs * sint[:, None]).sum() * (np.pi / 64) * (2 * np.pi / 128)
    np.testing.assert_allclose(total, 1.0, rtol=0.05)
