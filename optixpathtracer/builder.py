"""Scene compilation: host meshes -> (device SceneData, acceleration structures).

The single entry point that replaces the reference's buildAccel + buildSBT
sequence (SimplePathtracer.cpp:457-601, :390-455): flatten meshes, build the
acceleration structures host-side in vectorized numpy, and upload the
triangle soup in Morton/BVH-sorted order so leaf ranges are contiguous
slices.

The structures serve the traversal backends (ops/):
  bvh    — binary LBVH for the lockstep backend (the CPU default, exact)
  packed — the same LBVH and triangles as float4 records for the per-ray
           CUDA kernel (ops/traverse_gpu.py, the GPU default)
  wide   — W-wide collapsed BVH for the BFS and dense backends
All index the same sorted triangle order, so HitRecord.tri is
interchangeable across backends.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .bvh.lbvh import BVH, build_bvh
from .bvh.wide import WideBVH, build_wide
from .core.scene import HostScene, SceneData, device_scene_from_sorted
from .ops.traverse_gpu import PackedBVH, pack_bvh


class CompiledScene(NamedTuple):
    scene: SceneData
    bvh: BVH
    num_triangles: int  # real (unpadded) triangle count
    wide: Optional[WideBVH] = None  # BFS/dense-backend acceleration structure
    packed: Optional[PackedBVH] = None  # the GPU kernel's records of bvh
    scene_aabb: Optional[np.ndarray] = None  # (6,) f32 min xyz, max xyz


def compile_scene(
    host: HostScene,
    leaf_size: int = 4,
    wide_width: int = 8,
    build_wide_bvh: bool = True,
    compressed_nodes: bool = False,
) -> CompiledScene:
    flat = host.flatten()
    v0, v1, v2 = flat["v"]
    res = build_bvh(v0, v1, v2, leaf_size=leaf_size)
    scene = device_scene_from_sorted(flat, res.order, res.padded_count)

    wide = None
    if build_wide_bvh:
        h = res.host
        wide = build_wide(
            h["left"], h["right"], h["lmin"], h["lmax"], h["rmin"], h["rmax"],
            np.asarray(v0)[res.order],
            np.asarray(v1)[res.order],
            np.asarray(v2)[res.order],
            leaf_size=leaf_size,
            width=wide_width,
            compressed=compressed_nodes,
        )

    lmin, lmax = res.host["lmin"][0], res.host["lmax"][0]
    rmin, rmax = res.host["rmin"][0], res.host["rmax"][0]
    aabb = np.concatenate([np.minimum(lmin, rmin), np.maximum(lmax, rmax)])
    return CompiledScene(
        scene=scene,
        bvh=res.bvh,
        num_triangles=len(v0),
        wide=wide,
        packed=pack_bvh(res.bvh, scene),
        scene_aabb=aabb.astype(np.float32),
    )
