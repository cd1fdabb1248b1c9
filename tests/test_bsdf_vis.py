"""BSDF visualization harness (shade/bsdf_vis.py) — the reference's
BSDFTest (Disney.cuh:430-503) realized: dense f/pdf lobe maps + sample
splats, checked QUANTITATIVELY (samples must land where the pdf says)."""
import numpy as np
import pytest

from optixpathtracer.core.materials import make_material
from optixpathtracer.shade.bsdf_vis import (
    bsdf_maps,
    bsdf_sample_splat,
    bsdf_test_image,
)

W, H = 128, 64


def _expected_mass(pdf_img):
    """Per-pixel probability mass from the pdf map on the lat-long grid."""
    theta = (np.arange(H) + 0.5) / H * np.pi
    d_omega = np.sin(theta)[:, None] * (np.pi / H) * (2 * np.pi / W)
    mass = pdf_img * d_omega
    return mass / mass.sum()


@pytest.mark.parametrize(
    "mat",
    [
        make_material(color=(0.95, 0.9, 0.9), specular=1.0, roughness=0.025),
        make_material(color=(0.6, 0.6, 0.6), roughness=0.8),
        make_material(color=(0.9, 0.7, 0.3), metallic=1.0, roughness=0.2),
    ],
    ids=["glossy", "diffuse", "metal"],
)
def test_samples_match_pdf_map(mat):
    f_img, pdf_img = bsdf_maps(mat, width=W, height=H)
    assert np.all(np.isfinite(f_img)) and np.all(np.isfinite(pdf_img))
    assert np.all(pdf_img >= 0.0)

    n = 40000
    hist = bsdf_sample_splat(mat, width=W, height=H, n_samples=n)
    kept = hist.sum()
    # at the near-grazing reference wo (pi/2.05), GGX half-vector reflection
    # throws a fraction of samples below the horizon (pdf<=0, rejected)
    assert kept > 0.6 * n

    # coarse-bin agreement: empirical frequency vs pdf-integrated mass
    exp = _expected_mass(pdf_img)

    def coarse(a, b=8):
        return a.reshape(H // b, b, W // b, b).sum(axis=(1, 3))

    e = coarse(exp)
    o = coarse(hist / kept)
    tv = 0.5 * np.abs(e - o).sum()  # total-variation distance in [0, 1]
    assert tv < 0.15, f"sampling disagrees with pdf map: TV={tv:.3f}"


def test_composite_image_shape_and_splats():
    img = bsdf_test_image(width=W, height=H, n_samples=500)
    assert img.shape == (H, W, 3) and img.dtype == np.float32
    red = (img[..., 0] == 1.0) & (img[..., 1] == 0.0) & (img[..., 2] == 0.0)
    assert 0 < red.sum() <= 500  # splats present, possibly coincident
    # the blue channel is the 0.5 background everywhere off-splat
    assert np.all(img[..., 2][~red] == 0.5)
