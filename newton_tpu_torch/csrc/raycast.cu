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
// K1, raycast_closest_f32: one thread per ray, 128 rays a block; a warp
// holds 32 consecutive rays (half a 64-pixel camera row: coherent). What
// bounds it on an H100: operations. Each (ray, shape) pair moves the ray
// into the shape's frame (two quaternion rotations, ~60 FLOPs) and runs
// the class's intersector (raycast.py: plane; sphere, also for
// ellipsoids; box; capsule, also for cylinders: up to three square roots
// and a division), all correctly rounded without FMA; with every pair
// evaluated, the tiled camera's 4.19 M rays against 14,336 shapes are
// 6.0e10 pairs a render, though a camera sees its own world of 1,024.
// The design evaluates fewer pairs and leaves each pair's arithmetic as
// it was. A pre-pass in plain PyTorch (raycast.py: cull_tables, on the
// device, no host sync) gives
//   - `order`: the finite shapes (sphere, box, capsule) in Morton order
//     of their centres, then the planes it keeps, then the rest;
//     `counts` = (finite, planes kept);
//   - each finite shape's world box (its class, scale and rotation),
//     unions of G = 16 consecutive ones in that order (`gbox`) and of F
//     = 16 consecutive groups (`tbox`);
//   - one plane of each set of planes with no rotation (q.xyz == 0) and
//     equal height, the lowest index: the ray reaches such planes at the
//     same local z and t, bit for bit, so no other can win (ties go to
//     the lowest index).
// The kernel evaluates the kept planes, then walks the top boxes and,
// in an opened top box, its groups: each lane tests its ray against the
// box grown by a margin (box_pass), and the warp opens the box where
// one lane passes it (__any_sync), so the warp stays converged and each
// shape's loads are a broadcast. A box whose grown entry t exceeds the
// lane's running best (strictly) or max_dist does not need that lane.
// The running minimum compares (t, shape index), so the winner is the
// first minimum in ascending index order (the JAX argmin's) whatever the
// order of evaluation, and evaluating a pair that culling could have
// skipped never changes it.
// The margin: a rounded intersector reports hits off its exact shape.
// In a far world (|o| ~ 350 m) the discriminant b^2 - c cancels and a
// grazing ray's t moves by ~1e-2; a hit lies within sqrt(r^2 + 2 delta)
// of a sphere's centre, delta ~ 7e-7 |o|^2 (the rounding of b^2 and c),
// so within 1.2e-3 |o| of the shape's box, the same for the capsule's
// cylinder and caps; a box's slab test and the culling test themselves
// err by ~1e-6 |o|. Far from the world's origin every coordinate rounds
// by half an ulp of its size (p - h of a box, ro - p of a pair), a few
// ulps together whatever the ray's length. The margin is m0 + kr D + ka A:
// m0 = 1 mm, D the distance bound from the ray origin to the box, kr = 2e-3
// plus 1.5 sqrt(| |d|^2 - 1 |) for a direction that is not of unit length,
// A the largest coordinate of the box and the ray origin, ka = 2^-20 (8
// ulps). A shape with a non-finite transform or scale, or a quaternion off
// unit length by more than 1e-5, gets an unbounded box.
// tests/test_torch_raycast_cull.py checks on grazing rays from the far
// corner of a 32 x 32 grid of worlds, and from near worlds moved 1e4-1e5 m
// from the origin, that every winner's boxes pass, and that a plain-PyTorch
// walk of this algorithm equals the plain version bit for bit. The group,
// fan and margin constants are compile-time here and raycast.py's CULL_*
// (a CPU test holds them equal). The kStats instance also counts, into 12
// counters: box tests, boxes opened and the pairs evaluated of each class,
// once per live ray of the warp (the work the warp did), and the same
// counted per ray where that ray's own test passed (every top box, the
// groups of the top boxes it passes, the pairs of the groups it passes:
// the work culling leaves each ray).
// K2, raycast_mesh_f32: the closest triangle of every (mesh shape, ray)
// pair. The ray goes into the shape's frame (divided by its scale), then
// down the shape's BVH in bvh.py's order: the slab test against the node's
// box (tmin < t_best), a leaf's triangles by Moller-Trumbore with the
// leaf's first minimum taken where strictly below the best, and for a hit
// interior node the right child 2i + 2 first, then 2i + 1 (the stack walk
// pushes 2i + 1, then 2i + 2). What bounds it on an H100: bytes, 0.05 ms
// at the terrain's 4.19 M rays (rays in, hits out); the work depends on
// the data: 4.5 nodes and 4.1 triangles a ray there, most rays missing the
// root and a few testing dozens of triangles. The first design (a thread
// per pair, a stack in local memory, a triangle's index loads before its
// vertex loads, a leaf tested as soon as one lane of the warp reached one)
// ran 0.87 ms, its warps mostly idle in leaf loops that few of their
// lanes needed. This one:
//   - walks without a stack: on the complete binary layout, after a miss
//     or a leaf it climbs while the node is a left child (odd), then steps
//     to the left sibling of the right child reached, and stops at the
//     root: the stack walk's order, with the node in a register;
//   - reads packed data that BVHPool makes once: a box as two float4, a
//     leaf's slots contiguous as v0, e1, e2 (the same rounded differences
//     the first design formed) in three float4, and a count of valid slots
//     a leaf (every mask is a prefix) in place of the mask;
//   - keeps the warp's lanes in step: the warp walks until kLeafLanes of
//     its lanes stand at a hit leaf (or all have one or have ended), then
//     tests all those leaves' slots at once, spread evenly over its 32
//     lanes (a prefix sum of the counts gives each slot test its lane), and
//     each leaf's least (t, slot) comes back to its lane by a segmented
//     shuffle reduction: the leaf's first minimum, as before. Each lane
//     still walks its own nodes in its own order.
// Timed beside this design on the terrain and left out, none faster
// (tools/k2_variants.cu, by tools/torch_kernel_ab.py --k2-variants;
// PERF.md section 6): the BVH's top 8 levels staged in shared memory,
// blocks of 2 or 8 warps, a launch bound of 10 blocks an SM (it spills),
// and a walk by warp vote (one node at a time for the whole warp: its 32
// rays, half a camera row, reach different leaves). The leaf stage keeps
// each lane's leaf as a 32-bit index, so that the instance without
// counters holds its state in 56 registers without spilling. The counters
// (nodes visited, triangles tested) are a template instance of their own.
//
// Every floating-point operation is an explicitly rounded intrinsic, in the
// order of the plain PyTorch versions (raycast.py, bvh.py), without fused
// multiply-adds: each kernel equals its plain version bit for bit. With
// contracted multiply-adds a grazing ray, whose discriminant b^2 - c
// cancels (b ~ 100 m for a shape in a far world), moves its t by up to
// 1e-2 and its shape, beyond the tolerances the kernels are held to.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRaysPerBlock = 128;
constexpr int kWarp = 32;
constexpr float kInf = 1e10f;
// K1's culling (raycast.py: CULL_GROUP, CULL_FAN, CULL_M0, CULL_KAPPA,
// CULL_ABS): shapes a group, groups a top box, the margin's terms
constexpr int kCullGroup = 16;
constexpr int kCullFan = 16;
constexpr float kCullM0 = 1e-3f;
constexpr float kCullKappa = 2e-3f;
constexpr float kCullAbs = 9.5367431640625e-07f;  // 2^-20

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

// The culling test of K1 (raycast.py: cull_box_pass is its plain twin):
// does the ray (ro, rd) enter the box [lo, hi], grown by the margin m0 +
// kr D + ka A, at an entry t no later than t_lim? D bounds the distance
// from the ray origin to any point of the box (the L1 distance to its
// farthest corner), kr is the ray's error slope (ray_slope), A the
// largest absolute coordinate of the box and the origin. An axis along which
// the direction is below 1e-9 restricts t only where the origin lies
// outside the grown slab: the ray reaches it no earlier than at its
// distance times 0.999e9.
__device__ __forceinline__ bool box_pass(V3 ro, V3 inv, unsigned small,
                                         float kr, const float* b,
                                         float t_lim) {
  const float lo[3] = {b[0], b[1], b[2]}, hi[3] = {b[3], b[4], b[5]};
  const float o[3] = {ro.x, ro.y, ro.z}, iv[3] = {inv.x, inv.y, inv.z};
  float D = 0.0f, A = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    D = add(D, fmaxf(fabsf(sub(o[i], lo[i])), fabsf(sub(o[i], hi[i]))));
    A = fmaxf(A, fmaxf(fabsf(o[i]), fmaxf(fabsf(lo[i]), fabsf(hi[i]))));
  }
  const float m = add(add(kCullM0, mul(kr, D)), mul(kCullAbs, A));
  float tmin = -INFINITY, tmax = INFINITY;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float l = sub(lo[i], m), h = add(hi[i], m);
    float a, c;
    if (small & (1u << i)) {
      const bool in = o[i] >= l && o[i] <= h;
      a = in ? -INFINITY
             : mul(fminf(fabsf(sub(l, o[i])), fabsf(sub(h, o[i]))), 0.999e9f);
      c = INFINITY;
    } else {
      const float x = mul(sub(l, o[i]), iv[i]), y = mul(sub(h, o[i]), iv[i]);
      a = fminf(x, y);
      c = fmaxf(x, y);
    }
    tmin = fmaxf(tmin, a);
    tmax = fminf(tmax, c);
  }
  return tmax >= fmaxf(tmin, 0.0f) && tmin <= t_lim;
}

// The ray's error slope: kappa plus 1.5 sqrt(| |d|^2 - 1 |) (a direction
// that is not of unit length moves the intersectors' hits off their
// shapes by up to sqrt(| |d|^2 - 1 |) t)
__device__ __forceinline__ float ray_slope(V3 d) {
  return add(kCullKappa, mul(1.5f, sqr(fabsf(sub(dot(d, d), 1.0f)))));
}

template <bool kStats>
__global__ void __launch_bounds__(kRaysPerBlock)
raycast_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       int R, const float* __restrict__ X,
                       const float* __restrict__ scale,
                       const int* __restrict__ cls,
                       const int* __restrict__ order,
                       const int* __restrict__ counts,
                       const float* __restrict__ gbox,
                       const float* __restrict__ tbox, float max_dist,
                       float* __restrict__ t_out, int* __restrict__ s_out,
                       float* __restrict__ n_out,
                       unsigned long long* __restrict__ stats) {
  const int r = blockIdx.x * kRaysPerBlock + threadIdx.x;
  const bool live = r < R;
  V3 ro = v3(0.f, 0.f, 0.f), rd = v3(0.f, 0.f, 1.f);
  if (live) {
    ro = v3(o[3 * (size_t)r], o[3 * (size_t)r + 1], o[3 * (size_t)r + 2]);
    rd = v3(d[3 * (size_t)r], d[3 * (size_t)r + 1], d[3 * (size_t)r + 2]);
  }
  unsigned small = 0;
  if (!(fabsf(rd.x) > 1e-9f)) small |= 1u;
  if (!(fabsf(rd.y) > 1e-9f)) small |= 2u;
  if (!(fabsf(rd.z) > 1e-9f)) small |= 4u;
  const V3 inv = v3(rcp(small & 1u ? 1.0f : rd.x), rcp(small & 2u ? 1.0f : rd.y),
                    rcp(small & 4u ? 1.0f : rd.z));
  const float kr = ray_slope(rd);
  const int n_fin = counts[0], n_pl = counts[1];
  float t_best = kInf;
  int best = -1;
  // box tests, boxes opened, pairs of each class (plane, sphere, box,
  // capsule): the warp's, and this ray's own (kStats only)
  unsigned tests = 0, opened = 0, pc[4] = {0, 0, 0, 0};
  unsigned my_tests = 0, my_pass = 0, my_pc[4] = {0, 0, 0, 0};

  // one (ray, shape) pair; the least (t, index) wins; ``mine``: this
  // ray's own test passed the shape's boxes
  auto pair = [&](int s, bool mine) {
    const float* x = X + 7 * (size_t)s;
    const float* sc = scale + 3 * (size_t)s;
    const V3 u = v3(-x[3], -x[4], -x[5]);
    const V3 ol = qrot(u, x[6], vsub(ro, v3(x[0], x[1], x[2])));
    const V3 dl = qrot(u, x[6], rd);
    const int c = cls[s];
    if (kStats) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        pc[k] += c == k;
        my_pc[k] += mine && c == k;
      }
    }
    const float t = class_t(c, ol, dl, v3(sc[0], sc[1], sc[2]));
    if (t < t_best || (t == t_best && s < best)) {
      t_best = t;
      best = s;
    }
  };

  // every plane that the pre-pass kept, then the boxes of the finite
  // shapes: a warp opens a box where one of its rays passes it
  for (int k = 0; k < n_pl; ++k) pair(order[n_fin + k], live);
  const int n_grp = (n_fin + kCullGroup - 1) / kCullGroup;
  const int n_top = (n_grp + kCullFan - 1) / kCullFan;
  for (int top = 0; top < n_top; ++top) {
    ++tests;
    my_tests += live;
    const bool need = live && box_pass(ro, inv, small, kr, tbox + 6 * top,
                                       fminf(t_best, max_dist));
    if (!__any_sync(0xffffffffu, need)) continue;
    ++opened;
    my_pass += need;
    const int g1 = min(n_grp, (top + 1) * kCullFan);
    for (int g = top * kCullFan; g < g1; ++g) {
      ++tests;
      my_tests += need;
      const bool gneed = live && box_pass(ro, inv, small, kr, gbox + 6 * g,
                                          fminf(t_best, max_dist));
      if (!__any_sync(0xffffffffu, gneed)) continue;
      ++opened;
      const bool mine = need && gneed;
      my_pass += mine;
      const int k1 = min(n_fin, (g + 1) * kCullGroup);
      for (int k = g * kCullGroup; k < k1; ++k) pair(order[k], mine);
    }
  }
  if (kStats) {
    const unsigned n_live = __popc(__ballot_sync(0xffffffffu, live));
    unsigned mine[6] = {my_tests, my_pass, my_pc[0], my_pc[1], my_pc[2],
                        my_pc[3]};
#pragma unroll
    for (int k = 0; k < 6; ++k) mine[k] = __reduce_add_sync(0xffffffffu, mine[k]);
    if ((threadIdx.x & 31) == 0 && n_live) {
      atomicAdd(stats, (unsigned long long)tests * n_live);
      atomicAdd(stats + 1, (unsigned long long)opened * n_live);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        atomicAdd(stats + 2 + k, (unsigned long long)pc[k] * n_live);
#pragma unroll
      for (int k = 0; k < 6; ++k)
        atomicAdd(stats + 6 + k, (unsigned long long)mine[k]);
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
// A node's box: (lo, 0) and (hi, 0), two float4 (bvh.py: BVHPool.boxes).
// A leaf slot: v0, e1 = p1 - p0, e2 = p2 - p0 and three zeros, three
// float4 (BVHPool.slots).
constexpr int kLeafLanes = 8;    // lanes at a leaf that start a leaf stage

// the slab test of bvh.py's walk: the ray enters the box, before t_best
__device__ __forceinline__ bool node_hit(V3 ro, V3 inv, float4 l, float4 h,
                                         float t_best) {
  const float ax = mul(sub(l.x, ro.x), inv.x), bx = mul(sub(h.x, ro.x), inv.x);
  const float ay = mul(sub(l.y, ro.y), inv.y), by = mul(sub(h.y, ro.y), inv.y);
  const float az = mul(sub(l.z, ro.z), inv.z), bz = mul(sub(h.z, ro.z), inv.z);
  const float tmin =
      fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  const float tmax =
      fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  return tmax >= fmaxf(tmin, 0.0f) && tmin < t_best;
}

// Moller-Trumbore on one slot: t, or kInf on a miss
__device__ __forceinline__ float slot_t(const float4* __restrict__ s, V3 ro,
                                        V3 rd) {
  const float4 a = __ldg(s), b = __ldg(s + 1), c = __ldg(s + 2);
  const V3 v0 = v3(a.x, a.y, a.z);
  const V3 e1 = v3(a.w, b.x, b.y);
  const V3 e2 = v3(b.z, b.w, c.x);
  const V3 pv = cross(rd, e2);
  const float det = dot(e1, pv);
  const bool ok = fabsf(det) > 1e-12f;
  const float id = rcp(ok ? det : 1e-12f);
  const V3 sv = vsub(ro, v0);
  const float uu = mul(dot(sv, pv), id);
  const V3 qv = cross(sv, e1);
  const float vv = mul(dot(rd, qv), id);
  const float t = mul(dot(e2, qv), id);
  const bool hit = ok && uu >= 0.0f && vv >= 0.0f &&
                   add(uu, vv) <= 1.0f && t > 1e-6f;
  return hit ? t : kInf;
}

// the slot's unit face normal, turned against the ray
__device__ __forceinline__ V3 slot_normal(const float4* __restrict__ s,
                                          V3 rd) {
  const float4 a = __ldg(s), b = __ldg(s + 1), c = __ldg(s + 2);
  V3 nf = unit(cross(v3(a.w, b.x, b.y), v3(b.z, b.w, c.x)), 1e-12f);
  if (dot(nf, rd) > 0.0f) nf = v3(-nf.x, -nf.y, -nf.z);
  return nf;
}

// The stack walk's next node, without the stack: after a miss or a leaf,
// climb while the node is a left child (odd), then take the left sibling
// of the right child reached; -1 after the root ends the walk. Interior
// hits go to the right child 2i + 2 (the stack pops it first).
__device__ __forceinline__ int next_node(int node) {
  while (node & 1) node = (node - 1) >> 1;
  return node == 0 ? -1 : node - 1;
}

// a warp's leaf stage: each lane's ray and slots, its slots' prefix sums
struct LeafStage {
  float4 ray[kWarp][2];              // (ro, 0), (rd, 0)
  int leaf[kWarp];                   // the lane's leaf in the pool
  int end[kWarp];                    // inclusive prefix sum of the counts
  unsigned long long best[kWarp];    // (t bits, slot) of its first minimum
};

// One thread per (mesh shape, ray) pair, a warp 32 consecutive rays of one
// shape; each lane walks alone, the warp keeps its lanes in step: it walks
// until kLeafLanes of its lanes stand at a hit leaf (or every lane stands
// at one or has ended), then tests all those leaves' slots at once, spread
// over its 32 lanes. Each lane still sees its own walk's nodes in its own
// order, and its leaf's first minimum replaces its best where strictly
// below it. kStats counts nodes visited and triangles tested.
template <bool kStats>
__global__ void __launch_bounds__(kRaysPerBlock)
raycast_mesh_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    int R, const float* __restrict__ X,
                    const float* __restrict__ scale,
                    const int* __restrict__ bvh_of, int M,
                    const float4* __restrict__ boxes,
                    const float4* __restrict__ slots,
                    const int* __restrict__ counts,
                    const int* __restrict__ params, int K,
                    float* __restrict__ t_out, float* __restrict__ n_out,
                    unsigned long long* __restrict__ stats) {
  __shared__ LeafStage stage[kRaysPerBlock / kWarp];
  const int lane = threadIdx.x & 31;
  LeafStage& S = stage[threadIdx.x / kWarp];
  // a warp: 32 consecutive rays of one shape (shape-major)
  const int warps_per_m = (R + kWarp - 1) / kWarp;
  const long long tile = (long long)blockIdx.x * (kRaysPerBlock / kWarp) +
                         threadIdx.x / kWarp;
  if (tile >= (long long)M * warps_per_m) return;  // the whole warp
  const int m = (int)(tile / warps_per_m);
  const int r = (int)(tile - (long long)m * warps_per_m) * kWarp + lane;
  const int b = bvh_of[m];
  const int node_off = params[4 * b], leaf_off = params[4 * b + 1];
  const int leaf_base = params[4 * b + 2] - 1;
  const bool live = r < R;
  V3 ro = v3(0.0f, 0.0f, 0.0f), rd = v3(0.0f, 0.0f, 1.0f);
  if (live) {
    ro = v3(o[3 * (size_t)r], o[3 * (size_t)r + 1], o[3 * (size_t)r + 2]);
    rd = v3(d[3 * (size_t)r], d[3 * (size_t)r + 1], d[3 * (size_t)r + 2]);
  }
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
  const V3 inv = v3(rcp(fabsf(rd.x) > 1e-9f ? rd.x : 1e-9f),
                    rcp(fabsf(rd.y) > 1e-9f ? rd.y : 1e-9f),
                    rcp(fabsf(rd.z) > 1e-9f ? rd.z : 1e-9f));
  const float4* nb = boxes + 2 * (size_t)node_off;
  const int leaf0 = leaf_off - leaf_base;  // leaf of node: leaf0 + node
  S.ray[lane][0] = make_float4(ro.x, ro.y, ro.z, 0.0f);
  S.ray[lane][1] = make_float4(rd.x, rd.y, rd.z, 0.0f);
  float t_best = kInf;
  V3 n_best = v3(0.0f, 0.0f, 0.0f);
  unsigned long long nodes = 0, tested = 0;
  int node = live ? 0 : -1;
  bool at_leaf = false;
  while (__any_sync(0xffffffffu, node >= 0)) {
    // walk until enough lanes stand at a hit leaf
    while (true) {
      const bool ready = node < 0 || at_leaf;
      if (__all_sync(0xffffffffu, ready) ||
          __popc(__ballot_sync(0xffffffffu, at_leaf)) >= kLeafLanes)
        break;
      if (ready) continue;
      if (kStats) ++nodes;
      if (node_hit(ro, inv, __ldg(nb + 2 * node), __ldg(nb + 2 * node + 1),
                   t_best)) {
        if (node < leaf_base) node = 2 * node + 2;
        else at_leaf = true;
      } else {
        node = next_node(node);
      }
    }
    // the leaf stage: the warp's w-th slot test goes to lane w % 32
    const int n = at_leaf ? counts[leaf0 + node] : 0;
    if (kStats) tested += n;
    int end = n;
#pragma unroll
    for (int s = 1; s < kWarp; s <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, end, s);
      if (lane >= s) end += y;
    }
    const int total = __shfl_sync(0xffffffffu, end, kWarp - 1);
    S.leaf[lane] = leaf0 + node;
    S.end[lane] = end;
    S.best[lane] = (unsigned long long)__float_as_uint(kInf) << 32;
    __syncwarp();
    for (int w0 = 0; w0 < total; w0 += kWarp) {
      const int w = w0 + lane;
      int owner = -1;
      unsigned long long key = ~0ull;
      if (w < total) {
        owner = 0;                   // the first lane whose end exceeds w
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          if (S.end[owner + s - 1] <= w) owner += s;
        const int k = w - (owner ? S.end[owner - 1] : 0);
        const float4 a = S.ray[owner][0], c = S.ray[owner][1];
        const long long sl = (long long)S.leaf[owner] * K + k;
        const float t = slot_t(slots + 3 * sl, v3(a.x, a.y, a.z),
                               v3(c.x, c.y, c.z));
        key = ((unsigned long long)__float_as_uint(t) << 32) | (unsigned)k;
      }
      // the least (t, k) of each owner's run of lanes (runs are
      // contiguous), into the run's first lane
#pragma unroll
      for (int s = 1; s < kWarp; s <<= 1) {
        const unsigned long long y = __shfl_down_sync(0xffffffffu, key, s);
        const int oy = __shfl_down_sync(0xffffffffu, owner, s);
        if (lane + s < kWarp && oy == owner && y < key) key = y;
      }
      const int before = __shfl_up_sync(0xffffffffu, owner, 1);
      if (owner >= 0 && (lane == 0 || before != owner) &&
          key < S.best[owner])
        S.best[owner] = key;
      __syncwarp();
    }
    if (at_leaf) {
      const unsigned long long key = S.best[lane];
      const float tk = __uint_as_float((unsigned)(key >> 32));
      if (tk < t_best) {
        t_best = tk;
        n_best = slot_normal(
            slots + 3 * ((long long)S.leaf[lane] * K + (unsigned)key), rd);
      }
      at_leaf = false;
      node = next_node(node);
    }
    __syncwarp();
  }
  if (kStats) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      nodes += __shfl_xor_sync(0xffffffffu, nodes, s);
      tested += __shfl_xor_sync(0xffffffffu, tested, s);
    }
    if (lane == 0) {
      atomicAdd(stats, nodes);
      atomicAdd(stats + 1, tested);
    }
  }
  if (!live) return;
  if (scale != nullptr) {
    n_best = unit(v3(dvd(n_best.x, sc.x), dvd(n_best.y, sc.y),
                     dvd(n_best.z, sc.z)), 1e-9f);
  }
  const size_t q = (size_t)m * R + r;
  t_out[q] = t_best;
  n_out[3 * q] = n_best.x;
  n_out[3 * q + 1] = n_best.y;
  n_out[3 * q + 2] = n_best.z;
}

}  // namespace

// t (R,), shape (R,) int32, world normal (R, 3): the closest analytic hit
// of each ray among the shapes (X (S, 7) world transforms, scale (S, 3),
// cls (S,) class codes, -1: never hit) within max_dist, given the
// pre-pass's order, counts, group and top boxes ((., 6): lo, hi); stats
// (12 counters: box tests, boxes opened, pairs with planes, spheres,
// boxes, capsules, the warp's work counted once per live ray, then the
// same of each ray's own passes) may be null, and selects the counting
// instance where it is not.
extern "C" int raycast_closest_f32(const float* o, const float* d, int R,
                                   const float* X, const float* scale,
                                   const int* cls, const int* order,
                                   const int* counts, const float* gbox,
                                   const float* tbox, float max_dist,
                                   float* t, int* shape, float* n,
                                   long long* stats, void* stream) {
  if (R <= 0) return 0;
  const int blocks = (R + kRaysPerBlock - 1) / kRaysPerBlock;
  const cudaStream_t st = (cudaStream_t)stream;
  if (stats == nullptr)
    raycast_closest_kernel<false><<<blocks, kRaysPerBlock, 0, st>>>(
        o, d, R, X, scale, cls, order, counts, gbox, tbox, max_dist, t, shape,
        n, nullptr);
  else
    raycast_closest_kernel<true><<<blocks, kRaysPerBlock, 0, st>>>(
        o, d, R, X, scale, cls, order, counts, gbox, tbox, max_dist, t, shape,
        n, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

// t (M, R) and local normal (M, R, 3) of every (mesh shape, ray) pair; X and
// scale may be null (rays already in the mesh's frame); boxes (N, 8),
// slots (S, 12) and counts (L,) are a BVHPool's packed nodes, leaf slots
// and valid slots a leaf, params (B, 4) its per-BVH (node offset, leaf
// offset, leaves, depth), K its leaf budget; stats (2 counters: nodes
// visited, triangles tested) may be null, and selects the counting
// instance where it is not. A warp walks 32 rays of one shape
// (shape-major), four warps a block.
extern "C" int raycast_mesh_f32(const float* o, const float* d, int R,
                                const float* X, const float* scale,
                                const int* bvh_of, int M, const float* boxes,
                                const float* slots, const int* counts,
                                const int* params, int K, float* t, float* n,
                                long long* stats, void* stream) {
  if (R <= 0 || M <= 0) return 0;
  if (K < 1) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)M * ((R + kWarp - 1) / kWarp);
  const long long per_block = kRaysPerBlock / kWarp;
  const long long blocks = (warps + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float4* b4 = (const float4*)boxes;
  const float4* s4 = (const float4*)slots;
  if (stats == nullptr)
    raycast_mesh_kernel<false><<<(unsigned)blocks, kRaysPerBlock, 0, st>>>(
        o, d, R, X, scale, bvh_of, M, b4, s4, counts, params, K, t, n,
        nullptr);
  else
    raycast_mesh_kernel<true><<<(unsigned)blocks, kRaysPerBlock, 0, st>>>(
        o, d, R, X, scale, bvh_of, M, b4, s4, counts, params, K, t, n,
        (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

// Registers per thread and resident blocks per SM of K1 (which 0; its
// instance without counters) and K2 (which 1; 2: its counting instance).
extern "C" int raycast_kernel_info(int which, int* regs, int* blocks_per_sm) {
  if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const void* k =
      which == 0 ? (const void*)raycast_closest_kernel<false>
      : which == 1 ? (const void*)raycast_mesh_kernel<false>
                   : (const void*)raycast_mesh_kernel<true>;
  const cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, kRaysPerBlock, 0);
}
