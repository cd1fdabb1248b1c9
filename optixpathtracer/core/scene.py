"""Scene container: host-side builder + device-side SoA arrays.

Reference: the per-variant Model.{h,cpp} (TriangleMesh vectors of
vertex/normal/texcoord/index + Material + diffuseTextureID, Model.h:10-42) and
the per-mesh SBT records that carry geometry pointers into the hit programs
(SimplePathtracer.cpp:429-450).

Layout: all meshes are fused into one flat triangle soup with a
per-triangle material id. Triangle vertices are PRE-GATHERED (v0/v1/v2 stored
per triangle, SoA) so the traversal inner loop does contiguous dynamic-slice
reads with no index indirection. Textures are packed into one flat RGB pool
with per-texture (offset, width, height) — texture lookup is a gather, which
replaces CUDA texture objects.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .materials import MaterialTable, build_table, make_material
from .math import Vec3

Array = jax.Array


class TexturePool(NamedTuple):
    """All scene textures packed into one flat RGB pool (SoA channels)."""

    r: Array  # (P,) float32, linear-ish (stored as-is from 8-bit srgb/255)
    g: Array
    b: Array
    offset: Array  # (T,) int32 start pixel of each texture
    width: Array  # (T,) int32
    height: Array  # (T,) int32

    @staticmethod
    def empty() -> "TexturePool":
        one = jnp.ones((1,), jnp.float32)
        zero_i = jnp.zeros((1,), jnp.int32)
        one_i = jnp.ones((1,), jnp.int32)
        return TexturePool(one, one, one, zero_i, one_i, one_i)

    def sample_bilinear(self, tex_id: Array, u: Array, v: Array) -> Vec3:
        """Bilinear fetch with wrap addressing; tex_id < 0 returns white."""
        tid = jnp.maximum(tex_id, 0)
        w = self.width[tid].astype(jnp.float32)
        h = self.height[tid].astype(jnp.float32)
        off = self.offset[tid]
        # wrap address mode (cudaAddressModeWrap in the reference texture setup)
        uu = (u % 1.0) * w - 0.5
        vv = (v % 1.0) * h - 0.5
        x0 = jnp.floor(uu)
        y0 = jnp.floor(vv)
        fx = uu - x0
        fy = vv - y0
        wi = self.width[tid]
        hi = self.height[tid]

        def fetch(xi, yi):
            xi = jnp.mod(xi.astype(jnp.int32), wi)
            yi = jnp.mod(yi.astype(jnp.int32), hi)
            idx = off + yi * wi + xi
            return Vec3(self.r[idx], self.g[idx], self.b[idx])

        c00 = fetch(x0, y0)
        c10 = fetch(x0 + 1, y0)
        c01 = fetch(x0, y0 + 1)
        c11 = fetch(x0 + 1, y0 + 1)
        top = c00 * (1.0 - fx) + c10 * fx
        bot = c01 * (1.0 - fx) + c11 * fx
        out = top * (1.0 - fy) + bot * fy
        white = Vec3.ones(jnp.shape(u))
        has = tex_id >= 0
        return Vec3(
            jnp.where(has, out.x, white.x),
            jnp.where(has, out.y, white.y),
            jnp.where(has, out.z, white.z),
        )


class SceneData(NamedTuple):
    """Device-resident flat triangle soup (all SoA, shapes (N,) per component).

    Triangles are stored in BVH-sorted order (see bvh/), so leaf ranges are
    contiguous slices of these arrays.
    """

    v0: Vec3
    v1: Vec3
    v2: Vec3
    n0: Vec3  # shading normals (geometric normal where absent)
    n1: Vec3
    n2: Vec3
    uv0u: Array
    uv0v: Array
    uv1u: Array
    uv1v: Array
    uv2u: Array
    uv2v: Array
    material_id: Array  # (N,) int32
    has_shading_normal: Array  # (N,) bool
    materials: MaterialTable
    textures: TexturePool
    shade_rows: Array | None = None  # (N, 32) f32 packed per-triangle shade
    #   record: [v0|v1|v2 (9), n0|n1|n2 (9), uv0|uv1|uv2 (6), mat_id,
    #   has_sn, pad(6)]. The hit-shading stage gathers THIS — one wide-row
    #   gather instead of ~25 narrow ones (the SBT-record fetch).

    @property
    def num_triangles(self) -> int:
        return self.material_id.shape[0]

    def take_shade(self, tri: Array):
        """One-gather fetch of the per-hit shade record. Returns
        (v0, v1, v2, n0, n1, n2, (uv0u, uv0v, uv1u, uv1v, uv2u, uv2v),
        mat_id, has_sn)."""
        # barrier: keep the bulk row gather out of the consumer fusion
        # (fused, XLA lowers it to per-element loads)
        r = jax.lax.optimization_barrier(self.shade_rows[tri])  # (N, 32)
        v3 = lambda c: Vec3(r[..., c], r[..., c + 1], r[..., c + 2])
        uv = tuple(r[..., 18 + k] for k in range(6))
        return (
            v3(0), v3(3), v3(6), v3(9), v3(12), v3(15), uv,
            r[..., 24].astype(jnp.int32), r[..., 25] > 0.5,
        )

    def geometric_normal(self, tri: Array) -> Vec3:
        from . import math as m

        e1 = self.v1.take(tri) - self.v0.take(tri)
        e2 = self.v2.take(tri) - self.v0.take(tri)
        return m.normalize(m.cross(e1, e2))


@dataclasses.dataclass
class Mesh:
    """Host-side mesh: one material per mesh (Model.h TriangleMesh semantics)."""

    vertices: np.ndarray  # (V, 3) float32
    indices: np.ndarray  # (F, 3) int32
    normals: np.ndarray | None = None  # (V, 3) or None
    texcoords: np.ndarray | None = None  # (V, 2) or None
    material: dict = dataclasses.field(default_factory=make_material)


@dataclasses.dataclass
class HostScene:
    """Host staging area; `flatten()` produces numpy SoA ready for BVH build."""

    meshes: list[Mesh] = dataclasses.field(default_factory=list)
    textures: list[np.ndarray] = dataclasses.field(default_factory=list)  # (H,W,3) float32

    def add_mesh(self, mesh: Mesh) -> None:
        self.meshes.append(mesh)

    def add_texture(self, image: np.ndarray) -> int:
        """Register an (H, W, 3) float32 image; returns its texture id."""
        self.textures.append(np.asarray(image, np.float32))
        return len(self.textures) - 1

    def add_box(self, material: dict, pos, extent) -> None:
        """Procedural axis-aligned box (Model.cpp addBox :214-286 semantics)."""
        pos = np.asarray(pos, np.float32)
        e = np.asarray(extent, np.float32)
        lo, hi = pos - e, pos + e
        corners = np.array(
            [
                [lo[0], lo[1], hi[2]],  # A
                [hi[0], lo[1], hi[2]],  # B
                [hi[0], hi[1], hi[2]],  # C
                [lo[0], hi[1], hi[2]],  # D
                [lo[0], lo[1], lo[2]],  # E
                [hi[0], lo[1], lo[2]],  # F
                [hi[0], hi[1], lo[2]],  # G
                [lo[0], hi[1], lo[2]],  # H
            ],
            np.float32,
        )
        quads = [  # (v0, v1, v2, v3, normal)
            (0, 1, 2, 3, [0, 0, 1]),  # front
            (4, 7, 6, 5, [0, 0, -1]),  # back
            (4, 0, 3, 7, [-1, 0, 0]),  # left
            (1, 5, 6, 2, [1, 0, 0]),  # right
            (3, 2, 6, 7, [0, 1, 0]),  # top
            (4, 0, 1, 5, [0, -1, 0]),  # bottom (reference uses E,A,B winding)
        ]
        verts, norms, idx = [], [], []
        for a, b, c, d, n in quads:
            base = len(verts)
            verts += [corners[a], corners[b], corners[c], corners[d]]
            norms += [n, n, n, n]
            idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        self.add_mesh(
            Mesh(
                vertices=np.asarray(verts, np.float32),
                indices=np.asarray(idx, np.int32),
                normals=np.asarray(norms, np.float32),
                material=material,
            )
        )

    # -- flatten -----------------------------------------------------------
    def flatten(self) -> dict:
        """Fuse meshes into numpy SoA dicts (still unsorted — BVH reorders)."""
        assert self.meshes, "empty scene"
        tri_v = [[], [], []]
        tri_n = [[], [], []]
        tri_uv = [[], [], []]
        mat_ids = []
        has_sn = []
        materials = []
        for mesh in self.meshes:
            mid = len(materials)
            materials.append(mesh.material)
            v = np.asarray(mesh.vertices, np.float32)
            # int32 indexing: fancy-gather on int32 avoids a full-size int64
            # copy per mesh (build-time hot path at multi-Mtri scale)
            f = np.asarray(mesh.indices, np.int32)
            corners = [v[f[:, k]] for k in range(3)]
            for k in range(3):
                tri_v[k].append(corners[k])
            if mesh.normals is not None and len(mesh.normals):
                n = np.asarray(mesh.normals, np.float32)
                for k in range(3):
                    tri_n[k].append(n[f[:, k]])
                has_sn.append(np.ones(len(f), bool))
            else:
                # geometric normal fallback (04HelloRaytracing deviceProgram.cu:86-91)
                # manual cross: np.cross allocates ~5 temporaries per call,
                # measurably slow at Mtri scale
                e1 = corners[1] - corners[0]
                e2 = corners[2] - corners[0]
                gn = np.empty_like(e1)
                gn[:, 0] = e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1]
                gn[:, 1] = e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2]
                gn[:, 2] = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
                gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
                for k in range(3):
                    tri_n[k].append(gn)
                has_sn.append(np.zeros(len(f), bool))
            if mesh.texcoords is not None and len(mesh.texcoords):
                t = np.asarray(mesh.texcoords, np.float32)
                for k in range(3):
                    tri_uv[k].append(t[f[:, k]])
            else:
                for k in range(3):
                    tri_uv[k].append(np.zeros((len(f), 2), np.float32))
            mat_ids.append(np.full(len(f), mid, np.int32))

        out = dict(
            v=[np.concatenate(tri_v[k]) for k in range(3)],
            n=[np.concatenate(tri_n[k]) for k in range(3)],
            uv=[np.concatenate(tri_uv[k]) for k in range(3)],
            material_id=np.concatenate(mat_ids),
            has_shading_normal=np.concatenate(has_sn),
            materials=materials,
            textures=self.textures,
        )
        return out


def pack_textures(images: Sequence[np.ndarray]) -> TexturePool:
    if not images:
        return TexturePool.empty()
    offsets, widths, heights, chunks = [], [], [], []
    off = 0
    for img in images:
        img = np.asarray(img, np.float32)
        h, w = img.shape[:2]
        offsets.append(off)
        widths.append(w)
        heights.append(h)
        chunks.append(img.reshape(-1, img.shape[-1])[:, :3])
        off += h * w
    flat = np.concatenate(chunks, axis=0)
    return TexturePool(
        r=jnp.asarray(flat[:, 0]),
        g=jnp.asarray(flat[:, 1]),
        b=jnp.asarray(flat[:, 2]),
        offset=jnp.asarray(np.array(offsets, np.int32)),
        width=jnp.asarray(np.array(widths, np.int32)),
        height=jnp.asarray(np.array(heights, np.int32)),
    )


def device_scene_from_sorted(flat: dict, order: np.ndarray, pad_to: int) -> SceneData:
    """Upload flattened host arrays in BVH order, padded with degenerate tris.

    Padding triangles are zero-area at a far-away point so they never hit;
    padding keeps leaf ranges fixed-size (static shapes for XLA).
    """

    def pad3(a: np.ndarray, fill: float) -> np.ndarray:
        # empty + tail fill (not np.full): halves the write traffic on the
        # multi-hundred-MB attribute arrays of Mtri scenes
        n = len(order)
        out = np.empty((pad_to,) + a.shape[1:], a.dtype)
        np.take(a, order, axis=0, out=out[:n])
        if pad_to > n:
            out[n:] = fill
        return out

    far = 3.0e37
    v = [pad3(flat["v"][k], far) for k in range(3)]
    n = [pad3(flat["n"][k], 0.0) for k in range(3)]
    uv = [pad3(flat["uv"][k], 0.0) for k in range(3)]
    mat = np.zeros(pad_to, np.int32)
    mat[: len(order)] = flat["material_id"][order]
    hs = np.zeros(pad_to, bool)
    hs[: len(order)] = flat["has_shading_normal"][order]

    # upload each (pad_to, 3)/(pad_to, 2) attribute ONCE as a contiguous
    # array and derive both the per-component fields and the packed 32-wide
    # shade rows ON DEVICE: at 4.5M tris this removes a 576 MB host-side
    # shade matrix build plus its upload (the single largest cost of the
    # old path), replacing it with one fused on-device concatenate
    vj = [jnp.asarray(a) for a in v]
    nj = [jnp.asarray(a) for a in n]
    uvj = [jnp.asarray(a) for a in uv]
    matj = jnp.asarray(mat)
    hsj = jnp.asarray(hs)

    @jax.jit
    def _unpack(vj, nj, uvj, matj, hsj):
        shade = jnp.concatenate(
            vj + nj + uvj + [
                matj.astype(jnp.float32)[:, None],
                hsj.astype(jnp.float32)[:, None],
                jnp.zeros((pad_to, 6), jnp.float32),
            ], axis=1)
        comp = [a[:, k] for a in vj + nj for k in range(3)]
        uvc = [a[:, k] for a in uvj for k in range(2)]
        return shade, comp, uvc

    shade, comp, uvc = _unpack(vj, nj, uvj, matj, hsj)

    def v3(i):
        return Vec3(comp[3 * i], comp[3 * i + 1], comp[3 * i + 2])

    return SceneData(
        shade_rows=shade,
        v0=v3(0),
        v1=v3(1),
        v2=v3(2),
        n0=v3(3),
        n1=v3(4),
        n2=v3(5),
        uv0u=uvc[0],
        uv0v=uvc[1],
        uv1u=uvc[2],
        uv1v=uvc[3],
        uv2u=uvc[4],
        uv2v=uvc[5],
        material_id=matj,
        has_shading_normal=hsj,
        materials=build_table(flat["materials"]),
        textures=pack_textures(flat["textures"]),
    )
