"""Texture pipeline through the full renderer (Model.cpp loadTexture role)."""
import numpy as np
import pytest

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene, Mesh, TexturePool, pack_textures
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.lights.probe import build_probe
import jax.numpy as jnp


def test_texture_pool_bilinear_sampling():
    # 2x2 texel image: distinct corners
    img = np.array(
        [[[1, 0, 0], [0, 1, 0]],
         [[0, 0, 1], [1, 1, 0]]], np.float32
    )
    pool = pack_textures([img])
    tid = jnp.zeros(4, jnp.int32)
    # texel centers: (0.25, 0.25) etc.
    u = jnp.asarray([0.25, 0.75, 0.25, 0.75])
    v = jnp.asarray([0.25, 0.25, 0.75, 0.75])
    c = pool.sample_bilinear(tid, u, v)
    got = np.stack([np.asarray(c.x), np.asarray(c.y), np.asarray(c.z)], -1)
    np.testing.assert_allclose(got, img.reshape(4, 3), atol=1e-5)


def test_texture_pool_untextured_returns_white():
    pool = TexturePool.empty()
    c = pool.sample_bilinear(jnp.full(3, -1, jnp.int32), jnp.zeros(3), jnp.zeros(3))
    assert np.all(np.asarray(c.to_array()) == 1.0)


@pytest.mark.slow
def test_textured_quad_renders_pattern():
    """A textured floor quad must show the texture's two halves."""
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:, :4] = (1.0, 0.1, 0.1)  # left half red
    tex[:, 4:] = (0.1, 0.1, 1.0)  # right half blue

    hs = HostScene()
    tid = hs.add_texture(tex)
    quad = Mesh(
        vertices=np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=np.array([[0, 1, 0]] * 4, np.float32),
        texcoords=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        material=make_material(color=(1, 1, 1), texture_id=tid),
    )
    hs.add_mesh(quad)
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 1.0, np.float32))
    cfg = RenderConfig(width=48, height=48, samples_per_launch=8, max_depth=1)
    cam = Camera(eye=(0, 4, 0.01), lookat=(0, 0, 0), up=(0, 1, 0), fov_y=60,
                 aspect_ratio=1.0)
    r = Renderer(cs, probe, cfg, cam)
    r.render()
    aov = r.aovs()["albedo"]
    lit = aov.sum(-1) > 0.1
    assert lit.mean() > 0.5
    red = aov[..., 0] > aov[..., 2]
    blue = aov[..., 2] > aov[..., 0]
    # both texture halves visible
    assert (red & lit).mean() > 0.15
    assert (blue & lit).mean() > 0.15
