// MLS-MPM particle<->grid transfers under the separable quadratic B-spline
// stencil: particle n touches the 27 nodes base[n] + (i, j, k), i, j, k in
// {0, 1, 2}, each index clipped to [0, res - 1] (border duplicates sum),
// with weight w_ax[n, i, 0] * w_ax[n, j, 1] * w_ax[n, k, 2].
// Layouts: base (N, 3) int32, w_ax (N, 3 offsets, 3 axes) f32,
// vals / out (N, C) f32, grid (res, res, res, C) f32, all row-major.
//
// mpm_p2g_f32 replaces the TPU kernel newton_tpu/solvers/mpm_pallas.py ::
// p2g_apply (body _p2g_body): G[node, c] += W_n(node) * vals[n, c].
// mpm_g2p_f32 replaces mpm_pallas.py :: g2p_apply (body _g2p_body):
// out[n, c] = sum over the 27 nodes of W_n(node) * G[node, c].
//
// The TPU kernels turn the scatter into dense algebra: a banded basis
// B (P, res^2) per particle chunk and one MXU matmul against the whole grid
// held in VMEM across sequential grid steps. That is O(res^2) work per
// particle and needs the 13.6 MB grid (64^3 x 13 x 4 B) resident, which no
// Hopper block can hold (227 KB of shared memory). Here the stencil is
// applied directly: 27 nodes per particle, O(1) work.
//
// Thread mapping (both kernels): one thread per (particle, channel) pair,
// so the C threads of one particle touch C consecutive floats of each node
// and a warp's loads, stores and atomics fall on a few contiguous runs
// instead of 32 scattered addresses. The few stencil values are recomputed
// per channel; they are L1 hits.
//
// P2G: bound by float atomics into L2. At N = 32768, C = 13 that is 11.5 M
// atomicAdds per call into a 13.6 MB grid, which fits in the 50 MB L2; the
// wrapper zeroes the grid first. The atomics make the order of each node's
// sum change from run to run, so the result is not bitwise reproducible:
// it agrees with a float64 sum to within float32 rounding of the node's sum
// of magnitudes. Binning particles by cell and accumulating in shared
// memory before one global add per node is later work.
//
// G2P: no atomics; each output is a fixed-order 27-term sum, so it is
// deterministic. It is bound by L2/HBM reads of the grid (27 x C floats per
// particle, mostly L2 hits for spatially coherent particles) and writes
// (N, C) once, coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Stencil {
  int row[3][3];   // (ix * res + iy) * res for the (i, j) offsets
  int iz[3];
  float wxy[3][3];
  float wz[3];
};

__device__ __forceinline__ void load_stencil(const int* __restrict__ base,
                                             const float* __restrict__ w_ax,
                                             int n, int res, Stencil& s) {
  int idx[3][3];
  float w[3][3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const int b = base[(size_t)n * 3 + ax];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      idx[ax][k] = min(max(b + k, 0), res - 1);
      w[ax][k] = w_ax[(size_t)n * 9 + k * 3 + ax];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      s.row[i][j] = (idx[0][i] * res + idx[1][j]) * res;
      s.wxy[i][j] = __fmul_rn(w[0][i], w[1][j]);
    }
    s.iz[i] = idx[2][i];
    s.wz[i] = w[2][i];
  }
}

__global__ void __launch_bounds__(kThreads)
mpm_p2g_kernel(const int* __restrict__ base, const float* __restrict__ w_ax,
               const float* __restrict__ vals, float* __restrict__ grid,
               int N, int C, int res) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)N * C) return;
  const int n = (int)(t / C);
  const int c = (int)(t - (long long)n * C);
  const float v = vals[t];
  Stencil s;
  load_stencil(base, w_ax, n, res, s);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float w = __fmul_rn(s.wxy[i][j], s.wz[k]);
        atomicAdd(grid + (size_t)(s.row[i][j] + s.iz[k]) * C + c,
                  __fmul_rn(w, v));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mpm_g2p_kernel(const int* __restrict__ base, const float* __restrict__ w_ax,
               const float* __restrict__ grid, float* __restrict__ out,
               int N, int C, int res) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)N * C) return;
  const int n = (int)(t / C);
  const int c = (int)(t - (long long)n * C);
  Stencil s;
  load_stencil(base, w_ax, n, res, s);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float w = __fmul_rn(s.wxy[i][j], s.wz[k]);
        acc = fmaf(w, grid[(size_t)(s.row[i][j] + s.iz[k]) * C + c], acc);
      }
    }
  }
  out[t] = acc;
}

int blocks_for(int N, int C) {
  return (int)(((long long)N * C + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int mpm_p2g_f32(const int* base, const float* w_ax,
                           const float* vals, float* grid, int N, int C,
                           int res, void* stream) {
  if (N <= 0 || C <= 0) return 0;
  if (res < 1) return (int)cudaErrorInvalidValue;
  mpm_p2g_kernel<<<blocks_for(N, C), kThreads, 0, (cudaStream_t)stream>>>(
      base, w_ax, vals, grid, N, C, res);
  return (int)cudaGetLastError();
}

extern "C" int mpm_g2p_f32(const int* base, const float* w_ax,
                           const float* grid, float* out, int N, int C,
                           int res, void* stream) {
  if (N <= 0 || C <= 0) return 0;
  if (res < 1) return (int)cudaErrorInvalidValue;
  mpm_g2p_kernel<<<blocks_for(N, C), kThreads, 0, (cudaStream_t)stream>>>(
      base, w_ax, grid, out, N, C, res);
  return (int)cudaGetLastError();
}
