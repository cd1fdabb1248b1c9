"""Native C++ acceleration-structure compiler (native/src/accel.cpp) vs the
numpy reference builders — equivalence tests.

The native library fills the role of the reference's native accel build
(optixAccelBuild, SimplePathtracer.cpp:457-601) for the host-side scene
compile; the numpy builders define the semantics. Both stages must be
BIT-EXACT (binary LBVH, wide collapse).
"""
from __future__ import annotations

import numpy as np
import pytest

from optixpathtracer.bvh import native
from optixpathtracer.bvh.lbvh import (
    _np_karras_tree,
    _np_levels,
    _np_refit,
)
from optixpathtracer.bvh.morton import np_morton_codes
from optixpathtracer.bvh.wide import collapse

if native.get_lib() is None:
    pytest.skip("native accel library unavailable", allow_module_level=True)


def _random_tris(n, seed, dupes=False):
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-20, 20, (n, 3))
    if dupes:  # coincident centroids exercise the Morton/Karras tie-breaks
        k = max(1, n // 8)
        ctr[rng.integers(0, n, k)] = ctr[rng.integers(0, n, k)]
    e1 = rng.normal(0, 0.5, (n, 3))
    e2 = rng.normal(0, 0.5, (n, 3))
    v0 = (ctr - (e1 + e2) / 3).astype(np.float32)
    return v0, (v0 + e1).astype(np.float32), (v0 + e2).astype(np.float32)


def _np_binary(v0, v1, v2, leaf_size):
    """The numpy lbvh.build_bvh host stage, reproduced stage-by-stage."""
    t = v0.shape[0]
    pad_to = max(leaf_size, ((t + leaf_size - 1) // leaf_size) * leaf_size)
    c = (v0.astype(np.float64) + v1 + v2) / 3.0
    codes = np_morton_codes(c)
    order = np.argsort(codes, kind="stable")
    if pad_to > t:
        order = np.concatenate([order, np.repeat(order[-1:], pad_to - t)])
    sorted_codes = codes[order]
    num_leaves = pad_to // leaf_size
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    lf_min = tri_min[order].reshape(num_leaves, leaf_size, 3).min(axis=1)
    lf_max = tri_max[order].reshape(num_leaves, leaf_size, 3).max(axis=1)
    left, right = _np_karras_tree(sorted_codes[::leaf_size].copy())
    level, depth = _np_levels(left, right)
    lmin, lmax, rmin, rmax = _np_refit(
        left, right, lf_min.astype(np.float32), lf_max.astype(np.float32), level
    )
    return dict(order=order, left=left, right=right, lmin=lmin, lmax=lmax,
                rmin=rmin, rmax=rmax, depth=depth)


@pytest.mark.parametrize("n,seed,dupes,leaf_size", [
    (1, 0, False, 4), (3, 1, False, 4), (4, 2, False, 4), (97, 3, False, 4),
    (1000, 4, False, 4), (1000, 5, True, 4), (4096, 6, True, 4),
    # leaf size 8 is what the renderers build (cli, bench)
    (1, 7, False, 8), (9, 8, False, 8), (1000, 9, True, 8), (4099, 10, True, 8),
])
def test_build_binary_bit_exact(n, seed, dupes, leaf_size):
    v0, v1, v2 = _random_tris(n, seed, dupes)
    ref = _np_binary(v0, v1, v2, leaf_size=leaf_size)
    nat = native.build_binary(v0, v1, v2, leaf_size=leaf_size)
    assert nat is not None
    np.testing.assert_array_equal(nat["order"], ref["order"])
    np.testing.assert_array_equal(nat["left"], ref["left"])
    np.testing.assert_array_equal(nat["right"], ref["right"])
    for k in ("lmin", "lmax", "rmin", "rmax"):
        np.testing.assert_array_equal(nat[k], ref[k])
    assert nat["depth"] == ref["depth"]


@pytest.mark.parametrize("n,seed,width", [
    (40, 0, 8), (1000, 1, 8), (1000, 2, 4), (4096, 3, 8), (8, 4, 8),
])
def test_wide_collapse_bit_exact(n, seed, width):
    v0, v1, v2 = _random_tris(n, seed, dupes=True)
    ref = _np_binary(v0, v1, v2, leaf_size=4)
    num_leaves = len(ref["left"]) + 1
    bbox_ref, refs_ref, depth_ref = collapse(
        ref["left"], ref["right"], ref["lmin"], ref["lmax"], ref["rmin"],
        ref["rmax"], num_leaves, width)
    nat = native.wide_collapse(
        ref["left"], ref["right"], ref["lmin"], ref["lmax"], ref["rmin"],
        ref["rmax"], num_leaves, width)
    assert nat is not None
    bbox_nat, refs_nat, depth_nat = nat
    assert depth_nat == depth_ref
    np.testing.assert_array_equal(refs_nat, refs_ref)
    np.testing.assert_array_equal(bbox_nat, bbox_ref)


def test_end_to_end_compile_scene_native_matches_numpy():
    """compile_scene with the native builder produces identical traversal
    results (closest-hit tri/t) to the pure-numpy build on random rays."""
    import os

    import jax.numpy as jnp

    from optixpathtracer.builder import compile_scene
    from optixpathtracer.core.math import Vec3
    from optixpathtracer.core.scene import HostScene
    from optixpathtracer.ops.traverse import closest_hit

    from optixpathtracer.core.materials import make_material

    def build_host():
        hs = HostScene()
        rng = np.random.default_rng(11)
        for i in range(12):
            p = rng.uniform(-4, 4, 3)
            hs.add_box(make_material(color=(0.7, 0.7, 0.7)), p,
                       (0.8, 1.2, 0.6))
        return hs

    cs_nat = compile_scene(build_host())
    os.environ["OPTIXPT_NO_NATIVE"] = "1"
    try:
        cs_np = compile_scene(build_host())
    finally:
        del os.environ["OPTIXPT_NO_NATIVE"]

    rng = np.random.default_rng(12)
    o = rng.uniform(-6, 6, (256, 3)).astype(np.float32)
    d = rng.normal(0, 1, (256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def trace(cs):
        hit = closest_hit(
            cs.bvh, cs.scene,
            Vec3(jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]), jnp.asarray(o[:, 2])),
            Vec3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2])),
        )
        return np.asarray(hit.tri), np.asarray(hit.t)

    tri_a, t_a = trace(cs_nat)
    tri_b, t_b = trace(cs_np)
    np.testing.assert_array_equal(tri_a, tri_b)
    np.testing.assert_array_equal(t_a, t_b)
