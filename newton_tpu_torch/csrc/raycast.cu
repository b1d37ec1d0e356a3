// Closest-hit ray casts for the tiled camera and viewer picking.
//
// Replaces no TPU kernel: newton_tpu/geometry/raycast.py:raycast_model and
// newton_tpu/geometry/bvh.py:MeshBVH.raycast reach no pl.pallas_call. The
// JAX package evaluates every (ray, shape) pair as one dense (R, S, 3)
// array that XLA fuses, and walks each ray's BVH in a vmapped
// lax.while_loop. PyTorch cannot fuse the dense form (at the camera's
// width, R = 4.19 M rays and S = 14,336 shapes, one (R, S, 3) float array
// is 721 GB) and an eager walk reads a flag back to the host at every node.
//
// K1, raycast_closest_f32: one thread per ray, 128 rays a block. The shapes
// (world transform, scale, class) are staged through shared memory 128 at a
// time; every thread of a warp reads the same shape (a broadcast) and takes
// the same class branch. Each pair moves the ray into the shape's frame and
// runs the class's intersector (raycast.py: plane; sphere, also for
// ellipsoids; box; capsule, also for cylinders), keeping the running
// minimum with a strict < in ascending shape order (the JAX argmin's first
// minimum). The winner's normal is computed once, after the loop.
// What bounds it: operations. Every pair is evaluated (no culling: the
// place of a shape BVH in ROADMAP), ~60 FLOPs to move the ray and 2-60 for
// the class, against 40 bytes of ray in and 20 bytes out per ray.
//
// K2, raycast_mesh_f32: one thread per (mesh shape, ray) pair. The ray goes
// into the shape's frame (divided by its scale), then down the shape's BVH
// with a stack in local memory (2 depth + 2 entries used, MAX_STACK
// reserved): pop the top, the slab test against the node's box, a leaf's
// triangles by Moller-Trumbore with the leaf's first minimum taken where
// strictly below the best, push 2i + 1 then 2i + 2 (bvh.py's order). The
// work depends on the data (nodes visited, triangles tested); an optional
// pair of counters returns both.
//
// Every floating-point operation is an explicitly rounded intrinsic, in the
// order of the plain PyTorch versions (raycast.py, bvh.py), without fused
// multiply-adds: each kernel equals its plain version bit for bit. With
// contracted multiply-adds a grazing ray, whose discriminant b^2 - c
// cancels (b ~ 100 m for a shape in a far world), moves its t by up to
// 1e-2 and its shape, beyond the tolerances the kernels are held to.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRaysPerBlock = 128;
constexpr int kTile = 128;
constexpr int kMaxStack = 64;
constexpr float kInf = 1e10f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
__device__ __forceinline__ float sqr(float a) { return __fsqrt_rn(a); }

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return v3(sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z));
}
__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
  return v3(add(a.x, b.x), add(a.y, b.y), add(a.z, b.z));
}
__device__ __forceinline__ V3 vscale(V3 a, float s) {
  return v3(mul(a.x, s), mul(a.y, s), mul(a.z, s));
}
// a[0] b[0] + a[1] b[1] + a[2] b[2], summed left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(sub(mul(a.y, b.z), mul(a.z, b.y)),
            sub(mul(a.z, b.x), mul(a.x, b.z)),
            sub(mul(a.x, b.y), mul(a.y, b.x)));
}
// v + w t + u x t with t = 2 (u x v): math/quat.py's quat_rotate (u = q's
// vector part) and quat_rotate_inv (u = its negation)
__device__ __forceinline__ V3 qrot(V3 u, float w, V3 v) {
  const V3 t = vscale(cross(u, v), 2.0f);
  return vadd(vadd(v, vscale(t, w)), cross(u, t));
}
__device__ __forceinline__ V3 unit(V3 v, float floor) {
  const float n = fmaxf(sqr(dot(v, v)), floor);
  return v3(dvd(v.x, n), dvd(v.y, n), dvd(v.z, n));
}

// ---------------------------------------------------------------- K1 ----
__device__ __forceinline__ float t_plane(V3 o, V3 d) {
  const bool ok = fabsf(d.z) > 1e-9f;
  const float t = dvd(-o.z, ok ? d.z : 1e-9f);
  return (ok && t > 0.0f) ? t : kInf;
}

__device__ __forceinline__ float t_sphere(V3 o, V3 d, float r) {
  const float b = dot(o, d);
  const float c = sub(dot(o, o), mul(r, r));
  const float disc = sub(mul(b, b), c);
  const float sq = sqr(fmaxf(disc, 0.0f));
  float t = sub(-b, sq);
  if (!(t > 0.0f)) t = add(-b, sq);
  return (disc >= 0.0f && t > 0.0f) ? t : kInf;
}

__device__ __forceinline__ float t_box(V3 o, V3 d, V3 h) {
  const float ix = rcp(fabsf(d.x) > 1e-9f ? d.x : 1e-9f);
  const float iy = rcp(fabsf(d.y) > 1e-9f ? d.y : 1e-9f);
  const float iz = rcp(fabsf(d.z) > 1e-9f ? d.z : 1e-9f);
  const float ax = mul(sub(-h.x, o.x), ix), bx = mul(sub(h.x, o.x), ix);
  const float ay = mul(sub(-h.y, o.y), iy), by = mul(sub(h.y, o.y), iy);
  const float az = mul(sub(-h.z, o.z), iz), bz = mul(sub(h.z, o.z), iz);
  const float tmin =
      fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  const float tmax =
      fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  const bool hit = tmax >= fmaxf(tmin, 0.0f);
  const float t = tmin > 0.0f ? tmin : tmax;
  return (hit && t > 0.0f) ? t : kInf;
}

__device__ __forceinline__ float t_capsule(V3 o, V3 d, float r, float h) {
  const float a = add(mul(d.x, d.x), mul(d.y, d.y));
  const float b = add(mul(o.x, d.x), mul(o.y, d.y));
  const float c = sub(add(mul(o.x, o.x), mul(o.y, o.y)), mul(r, r));
  const float disc = sub(mul(b, b), mul(a, c));
  const float sq = sqr(fmaxf(disc, 0.0f));
  const float t_cyl = dvd(sub(-b, sq), a > 1e-12f ? a : 1e-12f);
  const float z = add(o.z, mul(d.z, t_cyl));
  float t = (disc >= 0.0f && a > 1e-12f && t_cyl > 0.0f && fabsf(z) <= h)
                ? t_cyl : kInf;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float oz = sub(o.z, mul(k == 0 ? 1.0f : -1.0f, h));
    const float bb = add(add(mul(o.x, d.x), mul(o.y, d.y)), mul(oz, d.z));
    const float cc = sub(add(add(mul(o.x, o.x), mul(o.y, o.y)),
                             mul(oz, oz)), mul(r, r));
    const float dd = sub(mul(bb, bb), cc);
    const float ts = sub(-bb, sqr(fmaxf(dd, 0.0f)));
    t = fminf(t, (dd >= 0.0f && ts > 0.0f) ? ts : kInf);
  }
  return t;
}

__device__ __forceinline__ float class_t(int cls, V3 o, V3 d, V3 sc) {
  switch (cls) {
    case 0: return t_plane(o, d);
    case 1: return t_sphere(o, d, sc.x);
    case 2: return t_box(o, d, sc);
    case 3: return t_capsule(o, d, sc.x, sc.y);
    default: return kInf;
  }
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// the local normal at t of class cls (raycast.py's _class_normal)
__device__ V3 class_normal(int cls, V3 o, V3 d, float t, V3 sc) {
  const V3 p = vadd(o, vscale(d, t));
  if (cls == 1) return unit(p, 1e-9f);
  if (cls == 2) {
    const V3 q = v3(dvd(p.x, fmaxf(sc.x, 1e-9f)), dvd(p.y, fmaxf(sc.y, 1e-9f)),
                    dvd(p.z, fmaxf(sc.z, 1e-9f)));
    int ax = 0;
    float m = fabsf(q.x);
    if (fabsf(q.y) > m) { ax = 1; m = fabsf(q.y); }
    if (fabsf(q.z) > m) ax = 2;
    return v3(mul(ax == 0 ? 1.0f : 0.0f, sgn(q.x)),
              mul(ax == 1 ? 1.0f : 0.0f, sgn(q.y)),
              mul(ax == 2 ? 1.0f : 0.0f, sgn(q.z)));
  }
  if (cls == 3) {
    const float zc = fminf(fmaxf(p.z, -sc.y), sc.y);
    return unit(v3(p.x, p.y, sub(p.z, zc)), 1e-9f);
  }
  return v3(0.0f, 0.0f, 1.0f);
}

__global__ void __launch_bounds__(kRaysPerBlock)
raycast_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       int R, const float* __restrict__ X,
                       const float* __restrict__ scale,
                       const int* __restrict__ cls, int S, float max_dist,
                       float* __restrict__ t_out, int* __restrict__ s_out,
                       float* __restrict__ n_out) {
  __shared__ float s_p[kTile][3];
  __shared__ float s_u[kTile][4];     // -q.xyz, q.w
  __shared__ float s_sc[kTile][3];
  __shared__ int s_cls[kTile];
  const int r = blockIdx.x * kRaysPerBlock + threadIdx.x;
  const bool live = r < R;
  V3 ro = v3(0.f, 0.f, 0.f), rd = v3(0.f, 0.f, 0.f);
  if (live) {
    ro = v3(o[3 * r], o[3 * r + 1], o[3 * r + 2]);
    rd = v3(d[3 * r], d[3 * r + 1], d[3 * r + 2]);
  }
  float t_best = kInf;
  int best = -1;
  for (int base = 0; base < S; base += kTile) {
    const int n = min(kTile, S - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kRaysPerBlock) {
      const float* x = X + 7 * (size_t)(base + j);
      s_p[j][0] = x[0]; s_p[j][1] = x[1]; s_p[j][2] = x[2];
      s_u[j][0] = -x[3]; s_u[j][1] = -x[4]; s_u[j][2] = -x[5];
      s_u[j][3] = x[6];
      const float* sc = scale + 3 * (size_t)(base + j);
      s_sc[j][0] = sc[0]; s_sc[j][1] = sc[1]; s_sc[j][2] = sc[2];
      s_cls[j] = cls[base + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const int c = s_cls[j];
      if (c < 0) continue;
      const V3 u = v3(s_u[j][0], s_u[j][1], s_u[j][2]);
      const float w = s_u[j][3];
      const V3 ol = qrot(u, w, vsub(ro, v3(s_p[j][0], s_p[j][1], s_p[j][2])));
      const V3 dl = qrot(u, w, rd);
      const float t =
          class_t(c, ol, dl, v3(s_sc[j][0], s_sc[j][1], s_sc[j][2]));
      if (t < t_best) {
        t_best = t;
        best = base + j;
      }
    }
  }
  if (!live) return;
  float* nn = n_out + 3 * (size_t)r;
  if (best < 0 || !(t_best <= max_dist)) {
    t_out[r] = kInf;
    s_out[r] = -1;
    nn[0] = 0.0f; nn[1] = 0.0f; nn[2] = 0.0f;
    return;
  }
  const float* x = X + 7 * (size_t)best;
  const V3 p = v3(x[0], x[1], x[2]);
  const V3 q = v3(x[3], x[4], x[5]);
  const V3 u = v3(-x[3], -x[4], -x[5]);
  const float* sc = scale + 3 * (size_t)best;
  const V3 ol = qrot(u, x[6], vsub(ro, p));
  const V3 dl = qrot(u, x[6], rd);
  const V3 nl = class_normal(cls[best], ol, dl, t_best, v3(sc[0], sc[1], sc[2]));
  const V3 nw = qrot(q, x[6], nl);
  t_out[r] = t_best;
  s_out[r] = best;
  nn[0] = nw.x; nn[1] = nw.y; nn[2] = nw.z;
}

// ---------------------------------------------------------------- K2 ----
__global__ void __launch_bounds__(kRaysPerBlock)
raycast_mesh_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    int R, const float* __restrict__ X,
                    const float* __restrict__ scale,
                    const int* __restrict__ bvh_of, int M,
                    const float* __restrict__ lo, const float* __restrict__ hi,
                    const int* __restrict__ tris,
                    const unsigned char* __restrict__ mask,
                    const float* __restrict__ verts,
                    const int* __restrict__ params, int K,
                    float* __restrict__ t_out, float* __restrict__ n_out,
                    unsigned long long* __restrict__ stats) {
  const long long q = (long long)blockIdx.x * kRaysPerBlock + threadIdx.x;
  if (q >= (long long)M * R) return;
  const int m = (int)(q / R);
  const int r = (int)(q - (long long)m * R);
  V3 ro = v3(o[3 * (size_t)r], o[3 * (size_t)r + 1], o[3 * (size_t)r + 2]);
  V3 rd = v3(d[3 * (size_t)r], d[3 * (size_t)r + 1], d[3 * (size_t)r + 2]);
  V3 sc = v3(1.0f, 1.0f, 1.0f);
  if (X != nullptr) {
    const float* x = X + 7 * (size_t)m;
    const V3 u = v3(-x[3], -x[4], -x[5]);
    ro = qrot(u, x[6], vsub(ro, v3(x[0], x[1], x[2])));
    rd = qrot(u, x[6], rd);
    if (scale != nullptr) {
      const float* s = scale + 3 * (size_t)m;
      sc = v3(fmaxf(s[0], 1e-9f), fmaxf(s[1], 1e-9f), fmaxf(s[2], 1e-9f));
      ro = v3(dvd(ro.x, sc.x), dvd(ro.y, sc.y), dvd(ro.z, sc.z));
      rd = v3(dvd(rd.x, sc.x), dvd(rd.y, sc.y), dvd(rd.z, sc.z));
    }
  }
  const int b = bvh_of[m];
  const int node_off = params[4 * b], leaf_off = params[4 * b + 1];
  const int leaf_base = params[4 * b + 2] - 1;
  const V3 inv = v3(rcp(fabsf(rd.x) > 1e-9f ? rd.x : 1e-9f),
                    rcp(fabsf(rd.y) > 1e-9f ? rd.y : 1e-9f),
                    rcp(fabsf(rd.z) > 1e-9f ? rd.z : 1e-9f));
  int stack[kMaxStack];
  int sp = 1;
  stack[0] = 0;
  float t_best = kInf;
  V3 n_best = v3(0.0f, 0.0f, 0.0f);
  unsigned long long nodes = 0, tested = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    ++nodes;
    const float* l = lo + 3 * (size_t)(node_off + node);
    const float* h = hi + 3 * (size_t)(node_off + node);
    const float ax = mul(sub(l[0], ro.x), inv.x), bx = mul(sub(h[0], ro.x), inv.x);
    const float ay = mul(sub(l[1], ro.y), inv.y), by = mul(sub(h[1], ro.y), inv.y);
    const float az = mul(sub(l[2], ro.z), inv.z), bz = mul(sub(h[2], ro.z), inv.z);
    const float tmin =
        fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
    const float tmax =
        fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
    if (!(tmax >= fmaxf(tmin, 0.0f) && tmin < t_best)) continue;
    if (node < leaf_base) {
      stack[sp] = 2 * node + 1;
      stack[sp + 1] = 2 * node + 2;
      sp += 2;
      continue;
    }
    const size_t leaf = (size_t)(leaf_off + node - leaf_base);
    float tk = kInf;
    V3 nk = v3(0.0f, 0.0f, 0.0f);
    for (int k = 0; k < K; ++k) {
      if (!mask[leaf * K + k]) continue;
      ++tested;
      const int* tri = tris + 3 * (leaf * K + k);
      const float* p0 = verts + 3 * (size_t)tri[0];
      const float* p1 = verts + 3 * (size_t)tri[1];
      const float* p2 = verts + 3 * (size_t)tri[2];
      const V3 v0 = v3(p0[0], p0[1], p0[2]);
      const V3 e1 = vsub(v3(p1[0], p1[1], p1[2]), v0);
      const V3 e2 = vsub(v3(p2[0], p2[1], p2[2]), v0);
      const V3 pv = cross(rd, e2);
      const float det = dot(e1, pv);
      const bool ok = fabsf(det) > 1e-12f;
      const float id = rcp(ok ? det : 1e-12f);
      const V3 s = vsub(ro, v0);
      const float uu = mul(dot(s, pv), id);
      const V3 qv = cross(s, e1);
      const float vv = mul(dot(rd, qv), id);
      const float t = mul(dot(e2, qv), id);
      const bool hit = ok && uu >= 0.0f && vv >= 0.0f &&
                       add(uu, vv) <= 1.0f && t > 1e-6f;
      const float th = hit ? t : kInf;
      if (th < tk) {
        tk = th;
        V3 nf = unit(cross(e1, e2), 1e-12f);
        if (dot(nf, rd) > 0.0f) nf = v3(-nf.x, -nf.y, -nf.z);
        nk = nf;
      }
    }
    if (tk < t_best) {
      t_best = tk;
      n_best = nk;
    }
  }
  if (stats != nullptr) {
    atomicAdd(stats, nodes);
    atomicAdd(stats + 1, tested);
  }
  if (scale != nullptr) {
    n_best = unit(v3(dvd(n_best.x, sc.x), dvd(n_best.y, sc.y),
                     dvd(n_best.z, sc.z)), 1e-9f);
  }
  t_out[q] = t_best;
  n_out[3 * q] = n_best.x;
  n_out[3 * q + 1] = n_best.y;
  n_out[3 * q + 2] = n_best.z;
}

}  // namespace

// t (R,), shape (R,) int32, world normal (R, 3): the closest analytic hit
// of each ray among the S shapes (X (S, 7) world transforms, scale (S, 3),
// cls (S,) class codes, -1: never hit) within max_dist.
extern "C" int raycast_closest_f32(const float* o, const float* d, int R,
                                   const float* X, const float* scale,
                                   const int* cls, int S, float max_dist,
                                   float* t, int* shape, float* n,
                                   void* stream) {
  if (R <= 0) return 0;
  if (S < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kRaysPerBlock - 1) / kRaysPerBlock;
  raycast_closest_kernel<<<blocks, kRaysPerBlock, 0, (cudaStream_t)stream>>>(
      o, d, R, X, scale, cls, S, max_dist, t, shape, n);
  return (int)cudaGetLastError();
}

// t (M, R) and local normal (M, R, 3) of every (mesh shape, ray) pair; X and
// scale may be null (rays already in the mesh's frame); stats (2 counters:
// nodes visited, triangles tested) may be null.
extern "C" int raycast_mesh_f32(const float* o, const float* d, int R,
                                const float* X, const float* scale,
                                const int* bvh_of, int M, const float* lo,
                                const float* hi, const int* tris,
                                const unsigned char* mask, const float* verts,
                                const int* params, int K, float* t, float* n,
                                long long* stats, void* stream) {
  if (R <= 0 || M <= 0) return 0;
  if (K < 1) return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)M * R;
  const long long blocks = (pairs + kRaysPerBlock - 1) / kRaysPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  raycast_mesh_kernel<<<(unsigned)blocks, kRaysPerBlock, 0,
                        (cudaStream_t)stream>>>(
      o, d, R, X, scale, bvh_of, M, lo, hi, tris, mask, verts, params, K, t,
      n, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

// Registers per thread and resident blocks per SM of K1 (which 0) and K2
// (which 1).
extern "C" int raycast_kernel_info(int which, int* regs, int* blocks_per_sm) {
  cudaFuncAttributes a;
  const void* k = which == 0 ? (const void*)raycast_closest_kernel
                             : (const void*)raycast_mesh_kernel;
  const cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, kRaysPerBlock, 0);
}
