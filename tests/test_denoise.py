import numpy as np
import pytest
import jax.numpy as jnp

from optixpathtracer.ops.denoise import atrous_denoise, bilateral_denoise


def _noisy_scene(rng, h=48, w=64):
    """Two flat regions + a normal/albedo edge, with MC-like noise."""
    albedo = np.zeros((h, w, 3), np.float32)
    albedo[:, : w // 2] = (0.8, 0.2, 0.2)
    albedo[:, w // 2 :] = (0.2, 0.8, 0.2)
    normal = np.zeros((h, w, 3), np.float32)
    normal[: h // 2] = (0, 1, 0)
    normal[h // 2 :] = (1, 0, 0)
    clean = albedo * 0.5
    noisy = clean + rng.normal(0, 0.15, clean.shape).astype(np.float32)
    return noisy, clean, normal, albedo


@pytest.mark.slow
def test_atrous_reduces_noise_preserves_edges(rng):
    noisy, clean, normal, albedo = _noisy_scene(rng)
    out = np.asarray(
        atrous_denoise(jnp.asarray(noisy), jnp.asarray(normal), jnp.asarray(albedo))
    )
    err_in = np.abs(noisy - clean).mean()
    err_out = np.abs(out - clean).mean()
    assert err_out < err_in * 0.5, (err_in, err_out)
    # the albedo edge must survive: means of the two halves stay distinct
    h, w = clean.shape[:2]
    left = out[:, : w // 2 - 4, 0].mean()
    right = out[:, w // 2 + 4 :, 0].mean()
    assert left > right + 0.2


def test_bilateral_smoke(rng):
    noisy, clean, _, _ = _noisy_scene(rng)
    out = np.asarray(bilateral_denoise(jnp.asarray(noisy)))
    assert np.abs(out - clean).mean() < np.abs(noisy - clean).mean()
