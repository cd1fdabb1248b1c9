// Per-ray BVH traversal for NVIDIA Hopper, called from JAX through the XLA
// foreign function interface (ops/traverse_gpu.py builds and loads it).
//
// One thread traces one ray through the binary LBVH of bvh/lbvh.py with a
// short private stack, the software analogue of an optixTrace walk on a GPU
// without RT cores. Both child boxes live at the parent, so one node fetch
// (four float4) tests both children; a leaf's K triangles are contiguous
// (three float4 each: v0, e1 = v1 - v0, e2 = v2 - v0).
//
// Semantics follow ops/traverse.py exactly: the same slab test, the same
// two-sided Moller-Trumbore test with its 1e-12 determinant cut, per-ray
// (t_min, t_max) with t_min < t < best_t, near-child-first order, and on a
// miss t = t_max, tri = -1, u = v = 0. The any-hit entry point returns on
// the first accepted triangle.
//
// Node record i (nodes + 4 * i):
//   [0] = (lmin.x, lmax.x, lmin.y, lmax.y)
//   [1] = (rmin.x, rmax.x, rmin.y, rmax.y)
//   [2] = (lmin.z, lmax.z, rmin.z, rmax.z)
//   [3] = (left child, right child, 0, 0) as int32 bits; a child < 0 is
//         leaf -(child + 1), a child >= 0 an internal node. Node 0 is the root.
// Triangle record j (tris + 3 * j): (v0, 0), (e1, 0), (e2, 0).

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kStackDepth = 64;  // bvh/lbvh.py TRAVERSAL_STACK_DEPTH
constexpr int kBlock = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, t_min;
};

// ops/intersect.py ray_aabb: near <= far over the three slabs and the
// current [t_min, best_t] interval.
__device__ __forceinline__ bool slab(const Ray& r, float x0, float x1, float y0,
                                     float y1, float z0, float z1, float best_t) {
  float t0x = (x0 - r.ox) * r.ix, t1x = (x1 - r.ox) * r.ix;
  float t0y = (y0 - r.oy) * r.iy, t1y = (y1 - r.oy) * r.iy;
  float t0z = (z0 - r.oz) * r.iz, t1z = (z1 - r.oz) * r.iz;
  float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                     fmaxf(fminf(t0z, t1z), r.t_min));
  float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                    fminf(fmaxf(t0z, t1z), best_t));
  return near <= far;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    traverse_kernel(const float4* __restrict__ nodes,
                    const float4* __restrict__ tris, int leaf_size,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int64_t n,
                    float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                    float* __restrict__ out_u, float* __restrict__ out_v) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;

  Ray r;
  r.ox = ox[i];
  r.oy = oy[i];
  r.oz = oz[i];
  r.dx = dx[i];
  r.dy = dy[i];
  r.dz = dz[i];
  r.ix = 1.0f / (fabsf(r.dx) > 1e-20f ? r.dx : 1e-20f);
  r.iy = 1.0f / (fabsf(r.dy) > 1e-20f ? r.dy : 1e-20f);
  r.iz = 1.0f / (fabsf(r.dz) > 1e-20f ? r.dz : 1e-20f);
  r.t_min = tmin[i];

  float best_t = tmax[i], best_u = 0.0f, best_v = 0.0f;
  int32_t best_tri = -1;

  int stack[kStackDepth];
  int sp = 0;
  int ref = 0;  // the Karras root
  while (true) {
    if (ref >= 0) {
      const float4* nd = nodes + 4 * static_cast<int64_t>(ref);
      float4 a = __ldg(nd), b = __ldg(nd + 1), c = __ldg(nd + 2),
             e = __ldg(nd + 3);
      bool hl = slab(r, a.x, a.y, a.z, a.w, c.x, c.y, best_t);
      bool hr = slab(r, b.x, b.y, b.z, b.w, c.z, c.w, best_t);
      int cl = __float_as_int(e.x), cr = __float_as_int(e.y);
      if (hl && hr) {
        // near child first, by box-centre projection on the ray direction
        float dl = ((a.x + a.y) * 0.5f - r.ox) * r.dx +
                   ((a.z + a.w) * 0.5f - r.oy) * r.dy +
                   ((c.x + c.y) * 0.5f - r.oz) * r.dz;
        float dr = ((b.x + b.y) * 0.5f - r.ox) * r.dx +
                   ((b.z + b.w) * 0.5f - r.oy) * r.dy +
                   ((c.z + c.w) * 0.5f - r.oz) * r.dz;
        bool left_near = dl <= dr;
        if (sp < kStackDepth) stack[sp++] = left_near ? cr : cl;
        ref = left_near ? cl : cr;
        continue;
      }
      if (hl || hr) {
        ref = hl ? cl : cr;
        continue;
      }
    } else {
      int64_t base = static_cast<int64_t>(-(ref + 1)) * leaf_size;
      for (int k = 0; k < leaf_size; ++k) {
        const float4* tp = tris + 3 * (base + k);
        float4 v0 = __ldg(tp), e1 = __ldg(tp + 1), e2 = __ldg(tp + 2);
        // p = d x e2, det = e1 . p, tv = o - v0, q = tv x e1
        float px = r.dy * e2.z - r.dz * e2.y;
        float py = r.dz * e2.x - r.dx * e2.z;
        float pz = r.dx * e2.y - r.dy * e2.x;
        float det = e1.x * px + e1.y * py + e1.z * pz;
        bool ok = fabsf(det) > 1e-12f;
        float inv_det = ok ? 1.0f / det : 0.0f;
        float tx = r.ox - v0.x, ty = r.oy - v0.y, tz = r.oz - v0.z;
        float u = (tx * px + ty * py + tz * pz) * inv_det;
        float qx = ty * e1.z - tz * e1.y;
        float qy = tz * e1.x - tx * e1.z;
        float qz = tx * e1.y - ty * e1.x;
        float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
        float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
        if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.t_min &&
            t < best_t) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_tri = static_cast<int32_t>(base + k);
          if (kAnyHit) break;
        }
      }
      if (kAnyHit && best_tri >= 0) break;
    }
    if (sp == 0) break;
    ref = stack[--sp];
  }
  out_t[i] = best_t;
  out_tri[i] = best_tri;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

template <bool kAnyHit>
ffi::Error Traverse(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                    ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> ox,
                    ffi::Buffer<ffi::F32> oy, ffi::Buffer<ffi::F32> oz,
                    ffi::Buffer<ffi::F32> dx, ffi::Buffer<ffi::F32> dy,
                    ffi::Buffer<ffi::F32> dz, ffi::Buffer<ffi::F32> tmin,
                    ffi::Buffer<ffi::F32> tmax,
                    ffi::ResultBuffer<ffi::F32> t,
                    ffi::ResultBuffer<ffi::S32> tri,
                    ffi::ResultBuffer<ffi::F32> u,
                    ffi::ResultBuffer<ffi::F32> v) {
  auto nd = nodes.dimensions();
  auto td = tris.dimensions();
  if (nd.size() != 3 || nd[1] != 4 || nd[2] != 4)
    return ffi::Error::InvalidArgument("nodes must be (M, 4, 4) float32");
  if (td.size() != 4 || td[2] != 3 || td[3] != 4)
    return ffi::Error::InvalidArgument("tris must be (L, K, 3, 4) float32");
  int64_t n = ox.element_count();
  if (n == 0) return ffi::Error::Success();
  int64_t grid = (n + kBlock - 1) / kBlock;
  traverse_kernel<kAnyHit><<<grid, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes.typed_data()),
      reinterpret_cast<const float4*>(tris.typed_data()),
      static_cast<int>(td[1]), ox.typed_data(), oy.typed_data(),
      oz.typed_data(), dx.typed_data(), dy.typed_data(), dz.typed_data(),
      tmin.typed_data(), tmax.typed_data(), n, t->typed_data(),
      tri->typed_data(), u->typed_data(), v->typed_data());
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("traverse launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error ClosestHit(cudaStream_t s, ffi::Buffer<ffi::F32> nodes,
                      ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> ox,
                      ffi::Buffer<ffi::F32> oy, ffi::Buffer<ffi::F32> oz,
                      ffi::Buffer<ffi::F32> dx, ffi::Buffer<ffi::F32> dy,
                      ffi::Buffer<ffi::F32> dz, ffi::Buffer<ffi::F32> tmin,
                      ffi::Buffer<ffi::F32> tmax,
                      ffi::ResultBuffer<ffi::F32> t,
                      ffi::ResultBuffer<ffi::S32> tri,
                      ffi::ResultBuffer<ffi::F32> u,
                      ffi::ResultBuffer<ffi::F32> v) {
  return Traverse<false>(s, nodes, tris, ox, oy, oz, dx, dy, dz, tmin, tmax,
                         t, tri, u, v);
}

ffi::Error AnyHit(cudaStream_t s, ffi::Buffer<ffi::F32> nodes,
                  ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> ox,
                  ffi::Buffer<ffi::F32> oy, ffi::Buffer<ffi::F32> oz,
                  ffi::Buffer<ffi::F32> dx, ffi::Buffer<ffi::F32> dy,
                  ffi::Buffer<ffi::F32> dz, ffi::Buffer<ffi::F32> tmin,
                  ffi::Buffer<ffi::F32> tmax, ffi::ResultBuffer<ffi::F32> t,
                  ffi::ResultBuffer<ffi::S32> tri,
                  ffi::ResultBuffer<ffi::F32> u,
                  ffi::ResultBuffer<ffi::F32> v) {
  return Traverse<true>(s, nodes, tris, ox, oy, oz, dx, dy, dz, tmin, tmax, t,
                        tri, u, v);
}

}  // namespace

#define OPTIXPT_BIND                                   \
  ffi::Ffi::Bind()                                     \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()        \
      .Arg<ffi::Buffer<ffi::F32>>() /* nodes */        \
      .Arg<ffi::Buffer<ffi::F32>>() /* tris */         \
      .Arg<ffi::Buffer<ffi::F32>>() /* ox */           \
      .Arg<ffi::Buffer<ffi::F32>>() /* oy */           \
      .Arg<ffi::Buffer<ffi::F32>>() /* oz */           \
      .Arg<ffi::Buffer<ffi::F32>>() /* dx */           \
      .Arg<ffi::Buffer<ffi::F32>>() /* dy */           \
      .Arg<ffi::Buffer<ffi::F32>>() /* dz */           \
      .Arg<ffi::Buffer<ffi::F32>>() /* t_min */        \
      .Arg<ffi::Buffer<ffi::F32>>() /* t_max */        \
      .Ret<ffi::Buffer<ffi::F32>>() /* t */            \
      .Ret<ffi::Buffer<ffi::S32>>() /* tri */          \
      .Ret<ffi::Buffer<ffi::F32>>() /* u */            \
      .Ret<ffi::Buffer<ffi::F32>>() /* v */

XLA_FFI_DEFINE_HANDLER_SYMBOL(OptixptClosestHit, ClosestHit, OPTIXPT_BIND);
XLA_FFI_DEFINE_HANDLER_SYMBOL(OptixptAnyHit, AnyHit, OPTIXPT_BIND);
