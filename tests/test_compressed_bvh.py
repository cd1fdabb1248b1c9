"""bf16-compressed wide-BVH nodes: conservative and exact-result."""
import numpy as np
import jax.numpy as jnp

from optixpathtracer.builder import compile_scene
from optixpathtracer.bvh.wide import _bf16_down, _bf16_up
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.math import Vec3, normalize
from optixpathtracer.core.scene import HostScene, Mesh
from optixpathtracer.ops.traverse_bfs import closest_hit_bfs


def test_bf16_rounding_conservative(rng):
    x = (rng.normal(size=20000) * np.exp(rng.normal(size=20000) * 5)).astype(np.float32)
    x = np.concatenate([x, [0.0, -0.0, 1e-40, -1e-40, 3e38, -3e38]]).astype(np.float32)
    dn = _bf16_down(x)
    up = _bf16_up(x)
    assert np.all(dn <= x)
    assert np.all(up >= x)
    # within one bf16 ulp (relative 2^-7 for normal numbers)
    big = np.abs(x) > 1e-30
    assert np.all(np.abs(dn[big] - x[big]) <= np.abs(x[big]) * 2**-6)
    assert np.all(np.abs(up[big] - x[big]) <= np.abs(x[big]) * 2**-6)


def _soup(rng, n_tris=250):
    c = (rng.random((n_tris, 3)) * 4 - 2).astype(np.float32)
    e1 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.2
    e2 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.2
    verts = np.concatenate([c, c + e1, c + e2]).astype(np.float32)
    idx = np.stack([np.arange(n_tris), np.arange(n_tris) + n_tris,
                    np.arange(n_tris) + 2 * n_tris], axis=1).astype(np.int32)
    hs = HostScene()
    hs.add_mesh(Mesh(vertices=verts, indices=idx, material=make_material()))
    return hs


def test_compressed_traversal_matches_uncompressed(rng):
    hs = _soup(rng)
    o = (rng.random((256, 3)) * 6 - 3).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    ov = Vec3(jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]), jnp.asarray(o[:, 2]))
    dv = normalize(Vec3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2])))

    plain = compile_scene(hs, compressed_nodes=False)
    comp = compile_scene(hs, compressed_nodes=True)
    r1 = closest_hit_bfs(plain.wide, ov, dv, cap_factor=8)
    r2 = closest_hit_bfs(comp.wide, ov, dv, cap_factor=8)
    assert float(r1.overflow) == 0.0 and float(r2.overflow) == 0.0
    # dilated boxes only ADD candidates; the triangle tests are identical,
    # so results must match exactly
    np.testing.assert_array_equal(np.asarray(r1.record.tri), np.asarray(r2.record.tri))
    np.testing.assert_allclose(np.asarray(r1.record.t), np.asarray(r2.record.t), rtol=1e-6)
