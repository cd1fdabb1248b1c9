"""Per-ray BVH traversal on an NVIDIA GPU: a CUDA kernel behind `jax.ffi`.

The kernel (native/cuda/traverse.cu) runs one thread per ray with a short
private stack over the binary LBVH of bvh/lbvh.py, the way OptiX walks a
BVH in software on a GPU without RT cores. Its semantics are those of the
lockstep backend (ops/traverse.py): the same slab and Moller-Trumbore tests,
per-ray (t_min, t_max), and the same miss record. `traverse_packed_np` is
the plain reference over the kernel's own packed buffers.

The library is compiled with nvcc at first use (or by `python -m
optixpathtracer.ops.traverse_gpu`) into native/build/, keyed by a hash
of the source. A failed build, or a process without a CUDA device, is an
error: nothing here falls back to another path.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..bvh.lbvh import TRAVERSAL_STACK_DEPTH, BVH
from ..core.math import Vec3
from ..core.scene import SceneData
from .traverse import HitRecord

Array = jax.Array

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
SOURCE = os.path.join(_REPO_ROOT, "native", "cuda", "traverse.cu")
BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
TARGETS = {"closest": "optixpt_closest_hit", "any": "optixpt_any_hit"}
_SYMBOLS = {"closest": "OptixptClosestHit", "any": "OptixptAnyHit"}

_lock = threading.Lock()
_lib = None  # the loaded library; kept alive for the registered handlers


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PackedBVH:
    """The kernel's array-of-structures view of a BVH and its triangles.

    nodes: (M, 4, 4) f32, per internal node (lmin.x, lmax.x, lmin.y,
      lmax.y), (rmin.x, rmax.x, rmin.y, rmax.y), (lmin.z, lmax.z, rmin.z,
      rmax.z), (left, right, 0, 0) with the child ids' int32 bits.
    tris: (L, K, 3, 4) f32, per triangle (v0, 0), (v1 - v0, 0), (v2 - v0, 0);
      leaf l owns tris[l], the sorted triangles l*K .. l*K + K - 1.
    """

    nodes: Array
    tris: Array


def pack_bvh(bvh: BVH, scene: SceneData) -> PackedBVH:
    """Pack the lockstep BVH and the sorted triangle soup for the kernel."""
    z = jnp.zeros_like(bvh.left_min.x)
    bits = lambda c: jax.lax.bitcast_convert_type(c.astype(jnp.int32), jnp.float32)
    nodes = jnp.stack([
        jnp.stack([bvh.left_min.x, bvh.left_max.x, bvh.left_min.y, bvh.left_max.y], -1),
        jnp.stack([bvh.right_min.x, bvh.right_max.x, bvh.right_min.y, bvh.right_max.y], -1),
        jnp.stack([bvh.left_min.z, bvh.left_max.z, bvh.right_min.z, bvh.right_max.z], -1),
        jnp.stack([bits(bvh.child_left), bits(bvh.child_right), z, z], -1),
    ], axis=1)
    v0, v1, v2 = scene.v0, scene.v1, scene.v2
    e1, e2 = v1 - v0, v2 - v0
    w = jnp.zeros_like(v0.x)
    rec = lambda a: jnp.stack([a.x, a.y, a.z, w], -1)
    tris = jnp.stack([rec(v0), rec(e1), rec(e2)], axis=1)
    k = bvh.leaf_size
    return PackedBVH(nodes=nodes, tris=tris.reshape(-1, k, 3, 4))


# -- build and registration ------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    """Path of the built library for the current source and flags."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libtraverse_{h[:16]}.so")


def build_library() -> str:
    """Compile native/cuda/traverse.cu unless this source is built already."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders agree on the result
    return out


def register() -> None:
    """Build and load the library and register both FFI targets (once)."""
    global _lib
    with _lock:
        if _lib is not None:
            return
        platform = jax.devices()[0].platform
        if platform != "gpu":
            raise RuntimeError(
                f"the gpu traversal needs a CUDA device; jax runs on {platform!r}"
            )
        lib = ctypes.cdll.LoadLibrary(build_library())
        for key, target in TARGETS.items():
            jax.ffi.register_ffi_target(
                target, jax.ffi.pycapsule(getattr(lib, _SYMBOLS[key])), platform="CUDA"
            )
        _lib = lib


# -- entry points ------------------------------------------------------------


def _launch(kind: str, packed: PackedBVH, rays: tuple) -> tuple:
    """One kernel call on flat (N,) ray arrays -> (t, tri, u, v)."""
    register()
    n = rays[0].shape[0]
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    return jax.ffi.ffi_call(TARGETS[kind], (f32, i32, f32, f32))(
        packed.nodes, packed.tris, *rays
    )


def _trace(kind: str, packed: PackedBVH, o: Vec3, d: Vec3, t_min, t_max):
    shape = jnp.shape(o.x)
    flat = lambda a: jnp.broadcast_to(jnp.asarray(a, jnp.float32), shape).reshape(-1)
    rays = tuple(flat(a) for a in (o.x, o.y, o.z, d.x, d.y, d.z, t_min, t_max))
    t, tri, u, v = _launch(kind, packed, rays)
    return HitRecord(*(a.reshape(shape) for a in (t, tri, u, v)))


def closest_hit(
    packed: PackedBVH, o: Vec3, d: Vec3, t_min: Array | float = 0.001,
    t_max: Array | float = 1e16,
) -> HitRecord:
    """Closest hit per ray (RAY_TYPE_RADIANCE): t, sorted tri id, u, v."""
    return _trace("closest", packed, o, d, t_min, t_max)


def any_hit(
    packed: PackedBVH, o: Vec3, d: Vec3, t_min: Array | float = 0.01,
    t_max: Array | float = 1e16,
) -> Array:
    """Occlusion, terminating on the first hit (RAY_TYPE_OCCLUSION)."""
    return _trace("any", packed, o, d, t_min, t_max).tri >= 0


# -- plain reference -----------------------------------------------------------


def traverse_packed_np(nodes, tris, o, d, t_min, t_max, any_hit: bool = False):
    """The kernel's walk in numpy, one ray at a time, over the packed
    buffers: (N, 3) origins and directions, (N,) t_min and t_max.
    Returns (t, tri, u, v) as the kernel does. For tests on small scenes."""
    nodes = np.asarray(nodes, np.float32)
    tris = np.asarray(tris, np.float32)
    k = tris.shape[1]
    tris = tris.reshape(-1, 3, 4)
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    n = o.shape[0]
    t_min = np.broadcast_to(np.asarray(t_min, np.float32), (n,))
    t_max = np.broadcast_to(np.asarray(t_max, np.float32), (n,))
    child = nodes[:, 3, :2].copy().view(np.int32)
    lo = np.stack([nodes[:, 0, 0], nodes[:, 0, 2], nodes[:, 2, 0]], -1)
    lhi = np.stack([nodes[:, 0, 1], nodes[:, 0, 3], nodes[:, 2, 1]], -1)
    rlo = np.stack([nodes[:, 1, 0], nodes[:, 1, 2], nodes[:, 2, 2]], -1)
    rhi = np.stack([nodes[:, 1, 1], nodes[:, 1, 3], nodes[:, 2, 3]], -1)
    v0s, e1s, e2s = tris[:, 0, :3], tris[:, 1, :3], tris[:, 2, :3]

    def dot(a, b):  # the kernel's summation order, in f32
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    out_t = t_max.copy()
    out_tri = np.full(n, -1, np.int32)
    out_u = np.zeros(n, np.float32)
    out_v = np.zeros(n, np.float32)
    with np.errstate(all="ignore"):
        for i in range(n):
            oi, di, tmin = o[i], d[i], t_min[i]
            inv = np.float32(1) / np.where(np.abs(di) > 1e-20, di, np.float32(1e-20))
            best_t, best = out_t[i], -1
            bu = bv = np.float32(0)

            def slab(bmin, bmax):
                t0, t1 = (bmin - oi) * inv, (bmax - oi) * inv
                near = max(np.minimum(t0, t1).max(), tmin)
                far = min(np.maximum(t0, t1).min(), best_t)
                return near <= far

            stack, ref = [], 0
            while True:
                if ref >= 0:
                    hl, hr = slab(lo[ref], lhi[ref]), slab(rlo[ref], rhi[ref])
                    cl, cr = int(child[ref, 0]), int(child[ref, 1])
                    if hl and hr:
                        dl = dot((lo[ref] + lhi[ref]) * np.float32(0.5) - oi, di)
                        dr = dot((rlo[ref] + rhi[ref]) * np.float32(0.5) - oi, di)
                        near_left = dl <= dr
                        if len(stack) < TRAVERSAL_STACK_DEPTH:
                            stack.append(cr if near_left else cl)
                        ref = cl if near_left else cr
                        continue
                    if hl or hr:
                        ref = cl if hl else cr
                        continue
                else:
                    base = -(ref + 1) * k
                    for j in range(base, base + k):
                        e1, e2 = e1s[j], e2s[j]
                        p = np.cross(di, e2)
                        det = dot(e1, p)
                        ok = abs(det) > 1e-12
                        inv_det = np.float32(1) / det if ok else np.float32(0)
                        tv = oi - v0s[j]
                        q = np.cross(tv, e1)
                        u, v, t = dot(tv, p) * inv_det, dot(di, q) * inv_det, dot(e2, q) * inv_det
                        if ok and u >= 0 and v >= 0 and u + v <= 1 and tmin < t < best_t:
                            best_t, best, bu, bv = t, j, u, v
                            if any_hit:
                                break
                    if any_hit and best >= 0:
                        break
                if not stack:
                    break
                ref = stack.pop()
            out_t[i], out_tri[i], out_u[i], out_v[i] = best_t, best, bu, bv
    return out_t, out_tri, out_u, out_v


if __name__ == "__main__":
    import time

    t0 = time.perf_counter()
    path = build_library()
    print(f"{path} ({time.perf_counter() - t0:.1f} s)")
