// MLS-MPM particle<->grid transfers under the separable quadratic B-spline
// stencil: particle n touches the 27 nodes base[n] + (i, j, k), i, j, k in
// {0, 1, 2}, each index clipped to [0, res - 1] (border duplicates sum),
// with weight w_ax[n, i, 0] * w_ax[n, j, 1] * w_ax[n, k, 2].
// Layouts: base (N, 3) int32, w_ax (N, 3 offsets, 3 axes) f32,
// vals / out (N, C) f32, grid (res, res, res, C) f32, all row-major.
//
// mpm_p2g_binned_f32 replaces the TPU kernel newton_tpu/solvers/
// mpm_pallas.py :: p2g_apply (body _p2g_body):
//   G[node, c] += W_n(node) * vals[n, c].
// mpm_g2p_binned_f32 replaces mpm_pallas.py :: g2p_apply (body _g2p_body):
//   out[n, c] = sum over the 27 nodes of W_n(node) * G[node, c].
//
// The TPU kernels turn the scatter into dense algebra: a banded basis
// B (P, res^2) per particle chunk and one MXU matmul against the whole grid
// held in VMEM. A Hopper block cannot hold the 13.6 MB grid (64^3 x 13 x
// 4 B), so here the stencil is applied directly, 27 nodes per particle, on
// particles grouped by grid tile so that a block works on one tile of the
// grid in shared memory.
//
// Tiles. A particle's clipped nodes lie in [cb, cb + 2] per axis with
// cb = clamp(base, 0, res - 1) (also for bases outside the grid), so it is
// binned by the tile of cb: kTile^3 = 4^3 cells, ceil(res / 4)^3 tiles. The
// nodes of tile t's particles lie in t's node block [4 t, 4 t + 6)^3 (a 2-
// node halo, clipped at res): 216 nodes. kTile = 4 spreads the sand cell's
// 252 occupied tiles (about 130 particles each) over the 132 SMs, two or
// more blocks per SM; 8^3 tiles would leave ~40 blocks busy. A channel slab
// of a node block is 216 x 16 floats = 13.8 KB of shared memory.
//
// Binning (mpm_bin_particles, once per MPM step, shared by every transfer
// of the step): a counting sort over tiles in one kernel, one cluster of 8
// blocks with cluster barriers between its phases and no memset. Each
// block counts a share of the particles per tile in its own shared memory
// (native integer atomics); block r sums the 8 blocks' counts of its
// eighth of the tiles (distributed shared memory reads), scans them after
// the totals of blocks < r into offsets, slot_of and a record (tile,
// begin, end) per non-empty tile, and turns each block's counts into that
// block's start positions; each block then places its particles (base and
// index, an int4) with local atomics. Remote atomics on one owner of each
// tile's counter were slower: the sand's 252 tiles fall to a few owners.
// The order inside a tile changes from run to run; offsets and records do
// not. The transfer kernels' blocks walk the records.
//
// P2G, in two kernels. Float atomicAdd on shared memory is a compare-and-
// swap loop on sm_90 (ATOMS.CAST.SPIN), and 11.5 M of them per call (N =
// 32768, C = 13) cost more than global atomics into an L2-resident grid;
// so no float atomics at all, and every node of the dense grid is written
// once by a store (no separate zero fill):
//  1. one block per non-empty tile stages up to 256 of its particles at a
//     time in shared memory, sorted by their cell in the tile (integer
//     shared atomics and a 64-entry scan), with their weights merged per
//     axis onto the 3 nodes above their clipped cell (border duplicates
//     summed there). Each of 8 warps takes 8 cells (half of a row x =
//     const); a cell's 27 nodes are its lanes, which sum the cell's
//     particles into 16 channels in registers (all lanes read one particle
//     at a time: broadcasts) and then add them to the warp's own node slab
//     (3 x 4 x 6 nodes). The slabs are summed per node in a fixed order
//     into the tile's scratch slot.
//  2. one block per (x, y) row of nodes stores the row, float4 at a time
//     where rows allow it: 0 in the tiles whose 8 neighbours t - {0, 1}^3
//     are all empty, else the sum of those neighbours' slots that hold the
//     node, in a fixed order.
// Within a cell the particles' order follows the atomics, so P2G is not
// bitwise reproducible: it agrees with a float64 sum to within float32
// rounding of the node's sum of magnitudes (the tolerance 1e-5 S + 1e-7 of
// the tests).
//
// G2P: 2 blocks per non-empty tile, each taking every other group of 64
// of its particles, load the tile's node block (a slab of up to 16 channels,
// 80 B per node; 16-byte cp.async when C % 4 == 0) into shared memory while
// their threads load their first particles. The 4 lanes of a quad take one
// particle (their loads of its stencil are one request) and lane q sums
// channels [4 q, 4 q + 4) of the slab from shared memory (float4 reads)
// over the 27 nodes in a fixed order, then stores them as a float4 when
// C % 4 == 0: out[n, :] is written by one quad, coalesced. Deterministic.
//
// Bounds on the H100: P2G writes the dense grid (13.6 MB at the sand size),
// G2P reads the particles and only the ~14k nodes their stencils touch
// (chip_smoke.py: kernel_cost). The scratch slots and the bins are this
// design's own traffic, in L2 at these sizes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "exact_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 4;                        // cells per tile edge
constexpr int kTileCells = kTile * kTile * kTile;
constexpr int kSpan = kTile + 2;                // nodes per node-block edge
constexpr int kSpanNodes = kSpan * kSpan * kSpan;
constexpr int kSlab = 16;                       // channels per shared slab
constexpr int kStride = kSlab + 4;              // floats per node in a slab:
                                                // 80 B, so the float4 reads
                                                // of random nodes spread over
                                                // all 8 bank groups
constexpr int kBinCluster = 8;                  // blocks of the binning
constexpr int kBinThreads = 1024;
constexpr int kBinUnroll = 4;                   // loads a thread has in flight
constexpr int kBinSmemTiles = 48 * 1024;        // most tiles a block counts
                                                // in shared memory
constexpr int kP2GWarps = 2 * kTile;            // two per cell row
constexpr int kP2GThreads = 32 * kP2GWarps;
constexpr int kChunk = kP2GThreads;             // particles staged at once
constexpr int kPartNodes = 3 * 4 * kSpan;       // nodes a warp's cells reach
constexpr int kG2PThreads = 256;                // a quad per particle
constexpr int kG2PParts = 2;                    // blocks per tile
constexpr int kG2PBlocksPerSM = 4;              // at 64 registers
constexpr int kOwnThreads = 128;

// dynamic shared memory of the P2G tile kernel: the warps' node slabs, the
// staged values, merged weights, bases, cell counts and offsets
constexpr int kP2GSmem = (kP2GWarps * kPartNodes * kStride + kChunk * kSlab
                          + kChunk * 9) * 4 + kChunk * 16
                         + (2 * kTileCells + 1) * 4;

// meta (int32): work[kBinCluster K] | offsets[K + 1] | slot_of[K] |
// nactive | rec[3 K], K = nt^3 tiles. work is the binning's workspace when
// the tiles do not fit in its blocks' shared memory; rec holds (tile,
// begin, end) of the nactive non-empty tiles, ascending
struct Layout {
  int nt, K;
  int *work, *offsets, *slot_of, *nactive, *rec;
};

__host__ __device__ __forceinline__ Layout layout(int* meta, int res) {
  Layout L;
  L.nt = (res + kTile - 1) / kTile;
  L.K = L.nt * L.nt * L.nt;
  L.work = meta;
  L.offsets = meta + kBinCluster * L.K;
  L.slot_of = L.offsets + L.K + 1;
  L.nactive = L.slot_of + L.K;
  L.rec = L.nactive + 1;
  return L;
}

__device__ __forceinline__ int clampi(int v, int res) {
  return min(max(v, 0), res - 1);
}

__device__ __forceinline__ int tile_of(int bx, int by, int bz, int res,
                                       int nt) {
  return ((clampi(bx, res) / kTile) * nt + clampi(by, res) / kTile) * nt
         + clampi(bz, res) / kTile;
}

__device__ __forceinline__ void tile_origin(int t, int nt, int* o) {
  o[2] = (t % nt) * kTile;
  o[1] = ((t / nt) % nt) * kTile;
  o[0] = (t / (nt * nt)) * kTile;
}

// block-wide exclusive scan of two ints; their block totals in *total
__device__ int2 block_scan2(int a, int b, int2* total) {
  __shared__ int2 s_warp[kBinThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int sa = a, sb = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ta = __shfl_up_sync(0xffffffffu, sa, off);
    const int tb = __shfl_up_sync(0xffffffffu, sb, off);
    if (lane >= off) { sa += ta; sb += tb; }
  }
  if (lane == 31) s_warp[warp] = make_int2(sa, sb);
  __syncthreads();
  if (warp == 0) {
    int2 v = lane < kBinThreads / 32 ? s_warp[lane] : make_int2(0, 0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ta = __shfl_up_sync(0xffffffffu, v.x, off);
      const int tb = __shfl_up_sync(0xffffffffu, v.y, off);
      if (lane >= off) { v.x += ta; v.y += tb; }
    }
    if (lane < kBinThreads / 32) s_warp[lane] = v;
  }
  __syncthreads();
  const int2 before = warp > 0 ? s_warp[warp - 1] : make_int2(0, 0);
  *total = s_warp[kBinThreads / 32 - 1];
  __syncthreads();                   // s_warp is reused by the next call
  return make_int2(before.x + sa - a, before.y + sb - b);
}

// the binning, one cluster of kBinCluster blocks. Each block counts a
// share of the particles per tile in its own shared memory (or, for larger
// grids, its part of meta's workspace); block r then sums the blocks'
// counts of the tiles [r Kb, (r + 1) Kb) over the cluster (distributed
// shared memory reads), scans them after the totals of blocks < r into the
// offsets and records, and turns each block's counts of those tiles into
// its start positions; each block then places its share with local
// atomics. Cluster barriers separate the phases.
__global__ void __launch_bounds__(kBinThreads)
mpm_bin_kernel(const int* __restrict__ base, int* meta,
               int4* __restrict__ sorted, int N, int res, int in_smem) {
  extern __shared__ int s_cnt[];     // [K] this block's counts, then starts
  __shared__ int2 s_total;           // block r's tiles: particles, non-empty
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = layout(meta, res);
  const int rank = (int)cluster.block_rank(), tid = threadIdx.x, K = L.K;
  auto counts_of = [&](int r) -> int* {
    return in_smem ? cluster.map_shared_rank(s_cnt, r) : L.work + r * K;
  };
  int* const cnt = in_smem ? s_cnt : L.work + rank * K;
  for (int i = tid; i < K; i += kBinThreads) cnt[i] = 0;
  __syncthreads();
  // a thread's particles n, n + stride, ...: kBinUnroll loads in flight
  const int stride = kBinCluster * kBinThreads;
  const int first = rank * kBinThreads + tid;
  for (int n0 = first; n0 < N; n0 += kBinUnroll * stride) {
    int t[kBinUnroll];
#pragma unroll
    for (int u = 0; u < kBinUnroll; ++u) {
      const int n = n0 + u * stride;
      t[u] = n < N ? tile_of(base[3 * n], base[3 * n + 1], base[3 * n + 2],
                             res, L.nt) : -1;
    }
#pragma unroll
    for (int u = 0; u < kBinUnroll; ++u)
      if (t[u] >= 0) atomicAdd(cnt + t[u], 1);
  }
  cluster.sync();
  const int Kb = (K + kBinCluster - 1) / kBinCluster;
  const int lo = min(K, rank * Kb), hi = min(K, lo + Kb);
  int sum = 0, act = 0;
  for (int t = lo + tid; t < hi; t += kBinThreads) {
    int c = 0;
#pragma unroll
    for (int r = 0; r < kBinCluster; ++r) c += counts_of(r)[t];
    sum += c;
    act += c > 0;
  }
  int2 tot;
  block_scan2(sum, act, &tot);
  if (tid == 0) s_total = tot;
  cluster.sync();
  int2 run = make_int2(0, 0);        // particles and non-empty tiles before
  for (int r = 0; r < rank; ++r) {
    const int2 o = *cluster.map_shared_rank(&s_total, r);
    run.x += o.x;
    run.y += o.y;
  }
  for (int start = lo; start < hi; start += kBinThreads) {
    const int t = start + tid;
    int c[kBinCluster], all = 0;
#pragma unroll
    for (int r = 0; r < kBinCluster; ++r) {
      c[r] = t < hi ? counts_of(r)[t] : 0;
      all += c[r];
    }
    const int2 ex = block_scan2(all, all > 0, &tot);
    if (t < hi) {
      const int off = run.x + ex.x, slot = run.y + ex.y;
      L.offsets[t] = off;
      L.slot_of[t] = all > 0 ? slot : -1;
      if (all > 0) {
        L.rec[3 * slot] = t;
        L.rec[3 * slot + 1] = off;
        L.rec[3 * slot + 2] = off + all;
      }
      int at = off;                  // block r's particles of t start here
#pragma unroll
      for (int r = 0; r < kBinCluster; ++r) {
        counts_of(r)[t] = at;
        at += c[r];
      }
    }
    run.x += tot.x;
    run.y += tot.y;
  }
  if (rank == kBinCluster - 1 && tid == 0) {
    L.offsets[K] = run.x;
    *L.nactive = run.y;
  }
  cluster.sync();
  for (int n0 = first; n0 < N; n0 += kBinUnroll * stride) {
    int4 b[kBinUnroll];
#pragma unroll
    for (int u = 0; u < kBinUnroll; ++u) {
      const int n = n0 + u * stride;
      b[u] = n < N ? make_int4(base[3 * n], base[3 * n + 1], base[3 * n + 2],
                               n) : make_int4(0, 0, 0, -1);
    }
#pragma unroll
    for (int u = 0; u < kBinUnroll; ++u)
      if (b[u].w >= 0)
        sorted[atomicAdd(cnt + tile_of(b[u].x, b[u].y, b[u].z, res, L.nt),
                         1)] = b[u];
  }
}

// the weights of one axis merged onto the 3 nodes above the clipped cell
// cb = clamp(b): m[d] sums the w[i * 3] whose clipped node b + i is cb + d
__device__ __forceinline__ void merged_weights(int b, const float* w,
                                               int res, float* m) {
  const int cb = clampi(b, res);
  m[0] = m[1] = m[2] = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int d = clampi(b + i, res) - cb;
    const float x = w[i * 3];
    m[0] += d == 0 ? x : 0.f;
    m[1] += d == 1 ? x : 0.f;
    m[2] += d == 2 ? x : 0.f;
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// P2G step 1: one block per non-empty tile (blocks walk the records)
__global__ void __launch_bounds__(kP2GThreads, 2)
mpm_p2g_tile_kernel(const float* __restrict__ w_ax,
                    const float* __restrict__ vals, int* meta,
                    const int4* __restrict__ sorted,
                    float* __restrict__ scratch, int nslots, int C,
                    int res) {
  extern __shared__ __align__(16) float smem[];
  float* s_part = smem;                          // [8 warps][72][kStride]
  float* s_v = s_part + kP2GWarps * kPartNodes * kStride;  // [kChunk][16]
  float* s_w = s_v + kChunk * kSlab;             // [kChunk][3 axes][3]
  int4* s_b = reinterpret_cast<int4*>(s_w + kChunk * 9);   // [kChunk]
  int* s_cnt = reinterpret_cast<int*>(s_b + kChunk);       // [64]
  int* s_cell = s_cnt + kTileCells;                        // [65]
  const Layout L = layout(meta, res);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int li = lane / 9, lj = (lane / 3) % 3, lk = lane % 3;
  const int nact = *L.nactive;
  // warp w: the 8 cells (x, y, z) = (w / 2, 2 (w % 2) + {0, 1}, 0..3);
  // its node slab: x in [w / 2, w / 2 + 3), y in [2 (w % 2), + 4), all z
  const int wx = warp >> 1, wy = 2 * (warp & 1);
  float* part = s_part + warp * kPartNodes * kStride;
  for (int slot = blockIdx.x; slot < nslots; slot += gridDim.x) {
    const int t = L.rec[3 * slot];
    if (slot >= nact) break;
    const int beg = L.rec[3 * slot + 1], end = L.rec[3 * slot + 2];
    int o[3];
    tile_origin(t, L.nt, o);
    for (int c0 = 0; c0 < C; c0 += kSlab) {
      const int cs = min(kSlab, C - c0);
      __syncthreads();               // the last slab's slabs are read
      for (int j = tid; j < kP2GWarps * kPartNodes * kStride / 4;
           j += kP2GThreads)
        reinterpret_cast<float4*>(s_part)[j] = make_float4(0.f, 0.f, 0.f,
                                                           0.f);
      for (int p0 = beg; p0 < end; p0 += kChunk) {
        const int np = min(kChunk, end - p0);
        const bool mine = tid < np;
        __syncthreads();             // the last chunk's reads are done
        if (tid < kTileCells) s_cnt[tid] = 0;
        int4 b = make_int4(0, 0, 0, 0);
        float w[9], v[kSlab];
        int lc = 0, rank = 0;
        if (mine) {
          b = sorted[p0 + tid];
          const float* wp = w_ax + (size_t)b.w * 9;
          const float* vp = vals + (size_t)b.w * C + c0;
#pragma unroll
          for (int k = 0; k < 9; ++k) w[k] = wp[k];
#pragma unroll
          for (int c = 0; c < kSlab; ++c) v[c] = c < cs ? vp[c] : 0.f;
          lc = ((clampi(b.x, res) - o[0]) * kTile + clampi(b.y, res) - o[1])
                   * kTile + clampi(b.z, res) - o[2];
        }
        __syncthreads();
        if (mine) rank = atomicAdd(s_cnt + lc, 1);
        __syncthreads();
        if (tid < 32) {              // exclusive scan, two cells per lane
          const int a0 = s_cnt[2 * tid], a1 = s_cnt[2 * tid + 1];
          int s = a0 + a1;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int ts = __shfl_up_sync(0xffffffffu, s, off);
            if (tid >= off) s += ts;
          }
          s_cell[2 * tid] = s - a0 - a1;
          s_cell[2 * tid + 1] = s - a1;
          if (tid == 31) s_cell[kTileCells] = s;
        }
        __syncthreads();
        if (mine) {
          const int pos = s_cell[lc] + rank;
          s_b[pos] = b;
          merged_weights(b.x, w, res, s_w + pos * 9);
          merged_weights(b.y, w + 1, res, s_w + pos * 9 + 3);
          merged_weights(b.z, w + 2, res, s_w + pos * 9 + 6);
          float4* dv = reinterpret_cast<float4*>(s_v + pos * kSlab);
#pragma unroll
          for (int g = 0; g < kSlab / 4; ++g)
            dv[g] = make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2],
                                v[4 * g + 3]);
        }
        __syncthreads();
        // lane (li, lj, lk) < 27: that node of each of the warp's cells
        if (lane < 27) {
          for (int cy = wy; cy < wy + 2; ++cy) {
            for (int cz = 0; cz < kTile; ++cz) {
              const int cell = (wx * kTile + cy) * kTile + cz;
              const int q0 = s_cell[cell], q1 = s_cell[cell + 1];
              if (q0 == q1) continue;
              float4 acc[kSlab / 4];
#pragma unroll
              for (int g = 0; g < kSlab / 4; ++g)
                acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
              for (int q = q0; q < q1; ++q) {
                const float* mw = s_w + q * 9;
                const float wt = __fmul_rn(__fmul_rn(mw[li], mw[3 + lj]),
                                           mw[6 + lk]);
                const float4* x = reinterpret_cast<const float4*>(
                    s_v + q * kSlab);
#pragma unroll
                for (int g = 0; g < kSlab / 4; ++g) {
                  const float4 y = x[g];
                  acc[g].x = fmaf(wt, y.x, acc[g].x);
                  acc[g].y = fmaf(wt, y.y, acc[g].y);
                  acc[g].z = fmaf(wt, y.z, acc[g].z);
                  acc[g].w = fmaf(wt, y.w, acc[g].w);
                }
              }
              float4* dst = reinterpret_cast<float4*>(
                  part + ((li * 4 + cy - wy + lj) * kSpan + cz + lk)
                             * kStride);
#pragma unroll
              for (int g = 0; g < kSlab / 4; ++g) {
                float4 y = dst[g];
                add4(y, acc[g]);
                dst[g] = y;
              }
              __syncwarp(0x07ffffffu);   // the next cell's lanes read these
            }
          }
        }
      }
      __syncthreads();
      // node (x, y, z) of the block: the slabs of warps (r, h), x - 2 <= r
      // <= x and 2 h <= y < 2 h + 4, in that order
      float* out = scratch + (size_t)slot * kSpanNodes * C + c0;
      for (int j = tid; j < kSpanNodes * (kSlab / 4); j += kP2GThreads) {
        const int node = j >> 2, g = j & 3;
        if (4 * g >= cs) continue;
        const int x = node / (kSpan * kSpan), y = (node / kSpan) % kSpan,
                  z = node % kSpan;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = max(0, x - 2); r <= min(kTile - 1, x); ++r)
          for (int h = max(0, (y - 2) >> 1); h <= min(1, y >> 1); ++h)
            add4(sum, reinterpret_cast<const float4*>(
                          s_part + ((2 * r + h) * kPartNodes
                                    + ((x - r) * 4 + y - 2 * h) * kSpan + z)
                                       * kStride)[g]);
        const float a[4] = {sum.x, sum.y, sum.z, sum.w};
        float* dst = out + (size_t)node * C + 4 * g;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (4 * g + r < cs) dst[r] = a[r];
      }
    }
  }
}

// P2G step 2: one block per (x, y) row of nodes, V floats per store (4
// when every row of the grid starts 16-byte aligned: res C % 4 == 0); each
// node is stored once: 0 in the z-tiles whose 8 neighbours t - {0, 1}^3
// are all empty, else the sum of those neighbours' slots that hold it, in
// a fixed order
template <int V>
__global__ void __launch_bounds__(kOwnThreads)
mpm_p2g_own_kernel(int* meta, const float* __restrict__ scratch,
                   float* __restrict__ grid, int C, int res) {
  extern __shared__ int s_slot[];    // [nt][8] slots of tiles t - d, then
  const Layout L = layout(meta, res);  // [nt] whether any is non-empty
  const int nt = L.nt;
  int* s_any = s_slot + nt * 8;
  const int gx = blockIdx.x / res, gy = blockIdx.x - gx * res;
  const int tx = gx / kTile, ty = gy / kTile;
  const int lx = gx - tx * kTile, ly = gy - ty * kTile;
  for (int j = threadIdx.x; j < nt * 8; j += kOwnThreads) {
    const int d = j & 7;
    const int sx = tx - ((d >> 2) & 1), sy = ty - ((d >> 1) & 1),
              sz = (j >> 3) - (d & 1);
    s_slot[j] = (sx >= 0 && sy >= 0 && sz >= 0)
                    ? L.slot_of[(sx * nt + sy) * nt + sz] : -1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nt; j += kOwnThreads) {
    bool any = false;
#pragma unroll
    for (int d = 0; d < 8; ++d) any |= s_slot[j * 8 + d] >= 0;
    s_any[j] = any;
  }
  __syncthreads();
  float* dst = grid + ((size_t)gx * res + gy) * res * C;
  const float inv_tile = 1.f / (kTile * C);    // floats per z-tile of a row
  const float inv_c = 1.f / C;
  for (int e = threadIdx.x; e < res * C / V; e += kOwnThreads) {
    // e V < res C < 2^16: these float quotients round to the exact integer
    // parts
    const int tz = (int)((e * V + 0.5f) * inv_tile);
    float a[V];
#pragma unroll
    for (int q = 0; q < V; ++q) a[q] = 0.f;
    if (s_any[tz]) {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int f = e * V + q - tz * kTile * C;
        const int lz = (int)((f + 0.5f) * inv_c), c = f - lz * C;
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          const int slot = s_slot[tz * 8 + d];
          const int sx = lx + ((d >> 2) & 1) * kTile;
          const int sy = ly + ((d >> 1) & 1) * kTile;
          const int sz = lz + (d & 1) * kTile;
          if (slot >= 0 && sx < kSpan && sy < kSpan && sz < kSpan)
            a[q] += scratch[((size_t)slot * kSpanNodes
                             + (sx * kSpan + sy) * kSpan + sz) * C + c];
        }
      }
    }
    if constexpr (V == 4)
      reinterpret_cast<float4*>(dst)[e] = make_float4(a[0], a[1], a[2],
                                                      a[3]);
    else
      dst[e] = a[0];
  }
}

// one particle's base, index and weights
__device__ __forceinline__ void load_particle(const int4* __restrict__ sorted,
                                              const float* __restrict__ w_ax,
                                              int p, int4& b, float* w) {
  b = sorted[p];
#pragma unroll
  for (int k = 0; k < 9; ++k) w[k] = w_ax[(size_t)b.w * 9 + k];
}

// G2P of channels [g, g + 4) of one particle from the node block in shared
// memory: 27 terms in a fixed order
__device__ __forceinline__ float4 g2p_group(const int4& b, const float* w,
                                            const float* s_node,
                                            const int* o, int res, int g) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int rx = (clampi(b.x + i, res) - o[0]) * (kSpan * kSpan * kStride);
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      const float wxy = __fmul_rn(w[i * 3], w[jj * 3 + 1]);
      const int ry = rx + (clampi(b.y + jj, res) - o[1]) * kSpan * kStride;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float wk = __fmul_rn(wxy, w[k * 3 + 2]);
        const float4 v = *reinterpret_cast<const float4*>(
            s_node + ry + (clampi(b.z + k, res) - o[2]) * kStride + g);
        acc.x = fmaf(wk, v.x, acc.x);
        acc.y = fmaf(wk, v.y, acc.y);
        acc.z = fmaf(wk, v.z, acc.z);
        acc.w = fmaf(wk, v.w, acc.w);
      }
    }
  }
  return acc;
}

// G2P: one block per non-empty tile (blocks walk the records); the 4 lanes
// of a quad take one particle, lane q its channels [4 q, 4 q + 4) of the
// slab; each quad loads its next particle while it computes this one
__global__ void __launch_bounds__(kG2PThreads, kG2PBlocksPerSM)
mpm_g2p_tile_kernel(const float* __restrict__ w_ax,
                    const float* __restrict__ grid, int* meta,
                    const int4* __restrict__ sorted, float* __restrict__ out,
                    int nslots, int C, int res) {
  __shared__ __align__(16) float s_node[kSpanNodes * kStride];
  const Layout L = layout(meta, res);
  const int tid = threadIdx.x, quad = tid >> 2, g = 4 * (tid & 3);
  constexpr int kQuads = kG2PThreads / 4;
  const bool vec = (C & 3) == 0;
  const int nact = *L.nactive;
  // item = (tile slot, part): part r takes the tile's particles r kQuads +
  // [0, kQuads) + k kG2PParts kQuads, so a tile of up to kG2PParts kQuads
  // particles is spread over kG2PParts blocks, one pass each
  for (int item = blockIdx.x; item < kG2PParts * nslots;
       item += gridDim.x) {
    const int slot = item / kG2PParts, part = item - slot * kG2PParts;
    const int t = L.rec[3 * slot];   // loaded beside nact
    if (slot >= nact) break;
    const int beg = L.rec[3 * slot + 1] + part * kQuads,
              end = L.rec[3 * slot + 2];
    if (beg >= end) continue;        // block-uniform: no particle here
    int o[3];
    tile_origin(t, L.nt, o);
    for (int c0 = 0; c0 < C; c0 += kSlab) {
      const int cs = min(kSlab, C - c0);
      const int per = vec ? cs / 4 : cs;       // copies per node
      __syncthreads();               // the last slab's reads are done
      for (int j = tid; j < kSpanNodes * per; j += kG2PThreads) {
        const int node = j / per, c = (j - node * per) * (vec ? 4 : 1);
        const int lz = node % kSpan, lxy = node / kSpan;
        const int ly = lxy % kSpan, lx = lxy / kSpan;
        const int gx = o[0] + lx, gy = o[1] + ly, gz = o[2] + lz;
        if (gx < res && gy < res && gz < res) {
          const float* src =
              grid + (((size_t)gx * res + gy) * res + gz) * C + c0 + c;
          if (vec)
            ntt::copy_async16(s_node + node * kStride + c, src);
          else
            ntt::copy_async(s_node + node * kStride + c, src);
        }
      }
      int p = beg + quad;
      int4 b = make_int4(0, 0, 0, 0);
      float w[9];
      if (p < end) load_particle(sorted, w_ax, p, b, w);
      ntt::copy_async_wait();
      __syncthreads();
      while (p < end) {
        const int pn = p + kG2PParts * kQuads;
        int4 bn = b;
        float wn[9];
        if (pn < end) load_particle(sorted, w_ax, pn, bn, wn);
        if (g < cs) {
          const float4 acc = g2p_group(b, w, s_node, o, res, g);
          float* dst = out + (size_t)b.w * C + c0 + g;
          if (vec) {
            *reinterpret_cast<float4*>(dst) = acc;
          } else {
            const float a[4] = {acc.x, acc.y, acc.z, acc.w};
            for (int r = 0; r < 4 && g + r < cs; ++r) dst[r] = a[r];
          }
        }
        p = pn;
        b = bn;
#pragma unroll
        for (int k = 0; k < 9; ++k) w[k] = wn[k];
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1)
      sms = 132;
  }
  return sms;
}

int own_smem(int nt) { return nt * 9 * (int)sizeof(int); }


constexpr int kMaxDefaultSmem = 48 * 1024;

}  // namespace

// int32 entries of meta (the bins) at res
extern "C" int mpm_meta_ints(int res) {
  const Layout L = layout(nullptr, res);
  return (int)(L.rec - L.work) + 3 * L.K;
}

extern "C" int mpm_bin_particles(const int* base, int* meta, int* sorted,
                                 int N, int res, void* stream) {
  if (res < 1 || N < 0) return (int)cudaErrorInvalidValue;
  const Layout L = layout(meta, res);
  const int in_smem = L.K <= kBinSmemTiles;
  const int smem = in_smem ? L.K * (int)sizeof(int) : 0;
  static bool opted = false;
  if (!opted) {
    cudaError_t e = cudaFuncSetAttribute(
        mpm_bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBinSmemTiles * (int)sizeof(int));
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBinCluster);
  cfg.blockDim = dim3(kBinThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kBinCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, mpm_bin_kernel, base, meta, reinterpret_cast<int4*>(sorted), N,
      res, in_smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int mpm_p2g_binned_f32(const float* w_ax, const float* vals,
                                  int* meta, const int* sorted,
                                  float* scratch, float* grid, int N, int C,
                                  int res, void* stream) {
  if (res < 1 || N < 0) return (int)cudaErrorInvalidValue;
  if (C <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const Layout L = layout(meta, res);
  const int smem = own_smem(L.nt);
  if (smem > kMaxDefaultSmem || (long long)res * C >= (1 << 16))
    return (int)cudaErrorInvalidValue;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        mpm_p2g_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kP2GSmem);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const int nslots = L.K < N ? L.K : N;
  if (nslots > 0)
    mpm_p2g_tile_kernel<<<min(nslots, 2 * sm_count()), kP2GThreads, kP2GSmem,
                          s>>>(w_ax, vals, meta,
                               reinterpret_cast<const int4*>(sorted),
                               scratch, nslots, C, res);
  if ((res * C) % 4 == 0)
    mpm_p2g_own_kernel<4><<<res * res, kOwnThreads, smem, s>>>(
        meta, scratch, grid, C, res);
  else
    mpm_p2g_own_kernel<1><<<res * res, kOwnThreads, smem, s>>>(
        meta, scratch, grid, C, res);
  return (int)cudaGetLastError();
}

extern "C" int mpm_g2p_binned_f32(const float* w_ax, const float* grid,
                                  int* meta, const int* sorted, float* out,
                                  int N, int C, int res, void* stream) {
  if (res < 1 || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || C <= 0) return 0;
  const Layout L = layout(meta, res);
  const int nslots = L.K < N ? L.K : N;
  mpm_g2p_tile_kernel<<<min(kG2PParts * nslots,
                            kG2PBlocksPerSM * sm_count()), kG2PThreads, 0,
                        (cudaStream_t)stream>>>(
      w_ax, grid, meta, reinterpret_cast<const int4*>(sorted), out, nslots,
      C, res);
  return (int)cudaGetLastError();
}

// which: 0 binning, 1 P2G tile, 2 P2G node rows (float4 stores), 3 G2P;
// registers per thread, shared memory per block (static plus dynamic, the
// binning's and the node rows' at res 64) and resident blocks per SM
extern "C" int mpm_kernel_info(int which, int* regs, int* smem,
                               int* blocks_per_sm) {
  const void* k = nullptr;
  int threads = 0, dyn = 0;
  const int K64 = (64 / kTile) * (64 / kTile) * (64 / kTile);
  switch (which) {
    case 0: k = (const void*)mpm_bin_kernel; threads = kBinThreads;
            dyn = K64 * (int)sizeof(int);
            break;
    case 1: {
      const cudaError_t e = cudaFuncSetAttribute(
          mpm_p2g_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kP2GSmem);
      if (e != cudaSuccess) return (int)e;
      k = (const void*)mpm_p2g_tile_kernel; threads = kP2GThreads;
      dyn = kP2GSmem;
      break;
    }
    case 2: k = (const void*)mpm_p2g_own_kernel<4>; threads = kOwnThreads;
            dyn = own_smem(64 / kTile); break;
    case 3: k = (const void*)mpm_g2p_tile_kernel; threads = kG2PThreads;
            break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *smem = (int)a.sharedSizeBytes + dyn;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k,
                                                            threads, dyn);
}
