// Variants of K2 (newton_tpu_torch/csrc/raycast.cu, raycast_mesh_kernel)
// that the port does not ship, built and timed beside K2 itself by
//
//     python3 tools/torch_kernel_ab.py --k2-variants
//
// on chip_smoke.py phase 57 (a)'s operands. Each computes what K2 computes,
// bit for bit (the tool checks it), from the same BVHPool arrays:
//   - k2_lane<kTop, kBlock, kMinBlocks>: K2's walk and leaf stage, with the
//     first kTopLevels levels of the block's BVH read from shared memory
//     (kTop: ROADMAP held item 14), kBlock threads a block and the launch
//     bound kMinBlocks blocks an SM; <false, 128, 1> is K2 itself without
//     its counters, the control of the comparison;
//   - k2_vote: a walk by warp vote. The warp stands at one node at a time;
//     each lane tests it while it hit every ancestor (its own walk, in its
//     own order), the warp goes down where any lane hit, and a lane that
//     hit a leaf tests that leaf's slots alone.

#include "../newton_tpu_torch/csrc/raycast.cu"

namespace {

constexpr int kTopLevels = 8;                     // 255 nodes, 8,160 B
constexpr int kTopNodes = (1 << kTopLevels) - 1;
constexpr unsigned kAll = 0xffffffffu;

// the ray of (shape m, ray r) in the shape's frame, divided by its scale;
// sc gets the scale (1 without one)
__device__ __forceinline__ void local_ray(const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          int r, bool live,
                                          const float* __restrict__ X,
                                          const float* __restrict__ scale,
                                          int m, V3& ro, V3& rd, V3& sc) {
  ro = v3(0.0f, 0.0f, 0.0f);
  rd = v3(0.0f, 0.0f, 1.0f);
  if (live) {
    ro = v3(o[3 * (size_t)r], o[3 * (size_t)r + 1], o[3 * (size_t)r + 2]);
    rd = v3(d[3 * (size_t)r], d[3 * (size_t)r + 1], d[3 * (size_t)r + 2]);
  }
  sc = v3(1.0f, 1.0f, 1.0f);
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
}

__device__ __forceinline__ V3 inverse_dir(V3 rd) {
  return v3(rcp(fabsf(rd.x) > 1e-9f ? rd.x : 1e-9f),
            rcp(fabsf(rd.y) > 1e-9f ? rd.y : 1e-9f),
            rcp(fabsf(rd.z) > 1e-9f ? rd.z : 1e-9f));
}

__device__ __forceinline__ void write_hit(float* __restrict__ t_out,
                                          float* __restrict__ n_out, int m,
                                          int R, int r, float t_best,
                                          V3 n_best, V3 sc, bool scaled) {
  if (scaled)
    n_best = unit(v3(dvd(n_best.x, sc.x), dvd(n_best.y, sc.y),
                     dvd(n_best.z, sc.z)), 1e-9f);
  const size_t q = (size_t)m * R + r;
  t_out[q] = t_best;
  n_out[3 * q] = n_best.x;
  n_out[3 * q + 1] = n_best.y;
  n_out[3 * q + 2] = n_best.z;
}

template <bool kTop, int kBlock, int kMinBlocks>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
k2_lane(const float* __restrict__ o, const float* __restrict__ d, int R,
        const float* __restrict__ X, const float* __restrict__ scale,
        const int* __restrict__ bvh_of, int M,
        const float4* __restrict__ boxes, const float4* __restrict__ slots,
        const int* __restrict__ counts, const int* __restrict__ params,
        int K, float* __restrict__ t_out, float* __restrict__ n_out) {
  __shared__ LeafStage stage[kBlock / kWarp];
  __shared__ float4 top[kTop ? 2 * kTopNodes : 1];
  const int lane = threadIdx.x & 31;
  LeafStage& S = stage[threadIdx.x / kWarp];
  const int warps_per_m = (R + kWarp - 1) / kWarp;
  const long long tile0 = (long long)blockIdx.x * (kBlock / kWarp);
  const long long tile = tile0 + threadIdx.x / kWarp;
  // the block stages the top of its first warp's BVH; a warp of another
  // shape's BVH reads global memory
  int top_b = -1, top_n = 0;
  if (kTop) {
    top_b = bvh_of[(int)min(tile0 / warps_per_m, (long long)M - 1)];
    top_n = min(kTopNodes, 2 * params[4 * top_b + 2] - 1);
    const float4* nb0 = boxes + 2 * (size_t)params[4 * top_b];
    for (int i = threadIdx.x; i < 2 * top_n; i += kBlock) top[i] = __ldg(nb0 + i);
    __syncthreads();
  }
  if (tile >= (long long)M * warps_per_m) return;  // the whole warp
  const int m = (int)(tile / warps_per_m);
  const int r = (int)(tile - (long long)m * warps_per_m) * kWarp + lane;
  const int b = bvh_of[m];
  const int node_off = params[4 * b], leaf_off = params[4 * b + 1];
  const int leaf_base = params[4 * b + 2] - 1;
  const bool live = r < R;
  const int n_top = kTop && b == top_b ? top_n : 0;
  V3 ro, rd, sc;
  local_ray(o, d, r, live, X, scale, m, ro, rd, sc);
  const V3 inv = inverse_dir(rd);
  const float4* nb = boxes + 2 * (size_t)node_off;
  const int leaf0 = leaf_off - leaf_base;
  S.ray[lane][0] = make_float4(ro.x, ro.y, ro.z, 0.0f);
  S.ray[lane][1] = make_float4(rd.x, rd.y, rd.z, 0.0f);
  float t_best = kInf;
  V3 n_best = v3(0.0f, 0.0f, 0.0f);
  int node = live ? 0 : -1;
  bool at_leaf = false;
  while (__any_sync(kAll, node >= 0)) {
    while (true) {
      const bool ready = node < 0 || at_leaf;
      if (__all_sync(kAll, ready) ||
          __popc(__ballot_sync(kAll, at_leaf)) >= kLeafLanes)
        break;
      if (ready) continue;
      const float4 l = node < n_top ? top[2 * node] : __ldg(nb + 2 * node);
      const float4 h =
          node < n_top ? top[2 * node + 1] : __ldg(nb + 2 * node + 1);
      if (node_hit(ro, inv, l, h, t_best)) {
        if (node < leaf_base) node = 2 * node + 2;
        else at_leaf = true;
      } else {
        node = next_node(node);
      }
    }
    const int n = at_leaf ? counts[leaf0 + node] : 0;
    int end = n;
#pragma unroll
    for (int s = 1; s < kWarp; s <<= 1) {
      const int y = __shfl_up_sync(kAll, end, s);
      if (lane >= s) end += y;
    }
    const int total = __shfl_sync(kAll, end, kWarp - 1);
    S.leaf[lane] = leaf0 + node;
    S.end[lane] = end;
    S.best[lane] = (unsigned long long)__float_as_uint(kInf) << 32;
    __syncwarp();
    for (int w0 = 0; w0 < total; w0 += kWarp) {
      const int w = w0 + lane;
      int owner = -1;
      unsigned long long key = ~0ull;
      if (w < total) {
        owner = 0;
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
#pragma unroll
      for (int s = 1; s < kWarp; s <<= 1) {
        const unsigned long long y = __shfl_down_sync(kAll, key, s);
        const int oy = __shfl_down_sync(kAll, owner, s);
        if (lane + s < kWarp && oy == owner && y < key) key = y;
      }
      const int before = __shfl_up_sync(kAll, owner, 1);
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
  if (live)
    write_hit(t_out, n_out, m, R, r, t_best, n_best, sc, scale != nullptr);
}

__global__ void __launch_bounds__(kRaysPerBlock)
k2_vote(const float* __restrict__ o, const float* __restrict__ d, int R,
        const float* __restrict__ X, const float* __restrict__ scale,
        const int* __restrict__ bvh_of, int M,
        const float4* __restrict__ boxes, const float4* __restrict__ slots,
        const int* __restrict__ counts, const int* __restrict__ params,
        int K, float* __restrict__ t_out, float* __restrict__ n_out) {
  const int lane = threadIdx.x & 31;
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
  V3 ro, rd, sc;
  local_ray(o, d, r, live, X, scale, m, ro, rd, sc);
  const V3 inv = inverse_dir(rd);
  const float4* nb = boxes + 2 * (size_t)node_off;
  const int leaf0 = leaf_off - leaf_base;
  float t_best = kInf;
  V3 n_best = v3(0.0f, 0.0f, 0.0f);
  // the depth of the node where this lane's own walk missed (32: it is in
  // the walk); the warp's walk leaves that subtree at a depth no deeper
  int off = 32;
  int node = 0;
  while (node >= 0) {
    const int depth = 31 - __clz(node + 1);
    if (depth <= off) off = 32;
    bool hit = false;
    if (live && off == 32) {
      hit = node_hit(ro, inv, __ldg(nb + 2 * node), __ldg(nb + 2 * node + 1),
                     t_best);
      if (!hit) off = depth;
    }
    if (__any_sync(kAll, hit)) {
      if (node < leaf_base) {
        node = 2 * node + 2;
        continue;
      }
      if (hit) {  // the leaf's first minimum, where below the best
        const long long first = (long long)(leaf0 + node) * K;
        const int n = counts[leaf0 + node];
        float tl = kInf;
        int kl = 0;
        for (int k = 0; k < n; ++k) {
          const float t = slot_t(slots + 3 * (first + k), ro, rd);
          if (t < tl) {
            tl = t;
            kl = k;
          }
        }
        if (tl < t_best) {
          t_best = tl;
          n_best = slot_normal(slots + 3 * (first + kl), rd);
        }
      }
    }
    node = next_node(node);
  }
  if (live)
    write_hit(t_out, n_out, m, R, r, t_best, n_best, sc, scale != nullptr);
}

using Kernel = void (*)(const float*, const float*, int, const float*,
                        const float*, const int*, int, const float4*,
                        const float4*, const int*, const int*, int, float*,
                        float*);

struct Variant {
  const char* name;
  Kernel kernel;
  int block;
};

const Variant kVariants[] = {
    {"control (K2's walk, blocks of 128)", k2_lane<false, 128, 1>, 128},
    {"top 8 levels in shared memory", k2_lane<true, 128, 1>, 128},
    {"launch bound 10 blocks an SM", k2_lane<false, 128, 10>, 128},
    {"blocks of 64", k2_lane<false, 64, 1>, 64},
    {"blocks of 256", k2_lane<false, 256, 1>, 256},
    {"walk by warp vote", k2_vote, kRaysPerBlock}};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

}  // namespace

extern "C" int k2_variant_count() { return kNumVariants; }

extern "C" const char* k2_variant_name(int v) {
  return v >= 0 && v < kNumVariants ? kVariants[v].name : nullptr;
}

// raycast_mesh_f32's arguments, without stats, for variant v
extern "C" int k2_variant_f32(int v, const float* o, const float* d, int R,
                              const float* X, const float* scale,
                              const int* bvh_of, int M, const float* boxes,
                              const float* slots, const int* counts,
                              const int* params, int K, float* t, float* n,
                              void* stream) {
  if (v < 0 || v >= kNumVariants || K < 1) return (int)cudaErrorInvalidValue;
  if (R <= 0 || M <= 0) return 0;
  const Variant& w = kVariants[v];
  const long long warps = (long long)M * ((R + kWarp - 1) / kWarp);
  const long long per_block = w.block / kWarp;
  const long long blocks = (warps + per_block - 1) / per_block;
  w.kernel<<<(unsigned)blocks, w.block, 0, (cudaStream_t)stream>>>(
      o, d, R, X, scale, bvh_of, M, (const float4*)boxes,
      (const float4*)slots, counts, params, K, t, n);
  return (int)cudaGetLastError();
}

// registers per thread and resident blocks per SM of variant v
extern "C" int k2_variant_info(int v, int* regs, int* blocks_per_sm) {
  if (v < 0 || v >= kNumVariants) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, (const void*)kVariants[v].kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, (const void*)kVariants[v].kernel, kVariants[v].block,
      0);
}
