import numpy as np
import jax.numpy as jnp

from optixpathtracer.bvh import morton
from optixpathtracer.bvh.lbvh import build_bvh


def _random_tris(rng, n, scale=1.0):
    c = rng.random((n, 3), dtype=np.float32) * scale
    e1 = rng.normal(size=(n, 3)).astype(np.float32) * 0.05 * scale
    e2 = rng.normal(size=(n, 3)).astype(np.float32) * 0.05 * scale
    return c, c + e1, c + e2


def test_clz32():
    x = jnp.asarray(np.array([0, 1, 2, 0x80000000, 0xFFFFFFFF, 0x00010000], np.uint32))
    got = np.asarray(morton.clz32(x))
    np.testing.assert_array_equal(got, [32, 31, 30, 0, 0, 15])


def test_expand_bits():
    v = jnp.asarray(np.array([0b1111111111], np.uint32))
    got = int(np.asarray(morton.expand_bits_10(v))[0])
    assert got == 0b1001001001001001001001001001


def test_morton_ordering_locality():
    # points on a diagonal line must sort monotonically
    t = np.linspace(0, 1, 100, dtype=np.float32)
    codes = np.asarray(
        morton.morton_codes(jnp.asarray(t * 1023), jnp.asarray(t * 1023), jnp.asarray(t * 1023))
    )
    assert np.all(np.diff(codes.astype(np.int64)) >= 0)


def _validate_tree(left, right, num_leaves):
    """Every leaf reachable exactly once; children form a proper binary tree."""
    if num_leaves == 1:
        return
    m = num_leaves - 1
    seen_leaves = []
    seen_nodes = set()
    stack = [0]
    while stack:
        node = stack.pop()
        assert node not in seen_nodes, "internal node visited twice"
        seen_nodes.add(node)
        for c in (left[node], right[node]):
            if c < 0:
                seen_leaves.append(-(c + 1))
            else:
                stack.append(int(c))
    assert sorted(seen_leaves) == list(range(num_leaves))
    assert len(seen_nodes) == m


def test_karras_tree_topology(rng):
    for n in [5, 16, 33, 200]:
        v0, v1, v2 = _random_tris(rng, n)
        res = build_bvh(v0, v1, v2, leaf_size=4)
        left = np.asarray(res.bvh.child_left)
        right = np.asarray(res.bvh.child_right)
        _validate_tree(left, right, res.bvh.num_leaves)


def test_refit_parent_contains_children(rng):
    v0, v1, v2 = _random_tris(rng, 300)
    res = build_bvh(v0, v1, v2, leaf_size=4)
    b = res.bvh
    left, right = np.asarray(b.child_left), np.asarray(b.child_right)
    lmin = np.asarray(b.left_min.to_array())
    lmax = np.asarray(b.left_max.to_array())
    rmin = np.asarray(b.right_min.to_array())
    rmax = np.asarray(b.right_max.to_array())

    # root box must contain every triangle vertex
    root_min = np.minimum(lmin[0], rmin[0])
    root_max = np.maximum(lmax[0], rmax[0])
    allv = np.concatenate([v0, v1, v2])
    assert np.all(allv >= root_min - 1e-4)
    assert np.all(allv <= root_max + 1e-4)

    # each internal child box must be contained in the union stored at parent
    for node in range(b.num_internal):
        for child, cmin, cmax in ((left[node], lmin[node], lmax[node]), (right[node], rmin[node], rmax[node])):
            if child >= 0:
                cl_min = np.minimum(lmin[child], rmin[child])
                cl_max = np.maximum(lmax[child], rmax[child])
                assert np.all(cl_min >= cmin - 1e-4)
                assert np.all(cl_max <= cmax + 1e-4)


def test_single_leaf_scene(rng):
    v0, v1, v2 = _random_tris(rng, 3)
    res = build_bvh(v0, v1, v2, leaf_size=4)
    assert res.bvh.num_internal == 1
    assert res.padded_count == 4
