// Batched small SPD factor + solve + explicit inverse, one warp per env
// (d <= 32) or one block per env (any larger d). Called with Minv null, it
// solves for rhs alone (the equality rows' system, whose inverse nothing
// reads): the same factor, then one substitution column, by lane 0 of the
// warp or thread 0 of the block, with the same arithmetic as the full call.
//
// Replaces the TPU kernel newton_tpu/solvers/generalized/linalg_pallas.py
// :: chol_inv_solve_pallas (body _kernel, math _chol_core / _solve_core):
// per env, the lower Cholesky factor of Mi = M + dt*diag(kd) (diagonal
// clamped as sqrt(max(L_jj, 1e-12))), then forward and back substitution
// for the d+1 right-hand sides [I | rhs]. Outputs Minv and x = Mi^-1 rhs.
//
// What bounds it on an H100: neither bytes nor flops. At the humanoid's
// d = 23, W = 4096, a call must move 4,416 B per env (5.4 us of HBM time)
// and do ~29k FLOPs per env (1.8 us at the float32 peak). Nearly all 1024
// blocks of 4 warps fit on the card at once, so the time is one warp's
// instruction stream (d factor steps, then 2d substitution steps, each
// behind the one before) times the warps that share a scheduler.
//
// Design: the matrix dimension is a template parameter D (instances 8,
// 14, 16, 23, 24 and 32; a smaller d runs in the next larger instance,
// padded with the identity, which leaves the d x d block's arithmetic
// unchanged). Lane i holds row i of Mi, then of L, in D registers for the
// whole factor: each column's pivot comes by one shuffle, its entries by
// float4 shared-memory broadcasts, and the trailing update is register
// arithmetic with compile-time indices (no shared-memory read-modify-
// write, no index arithmetic). L then goes to shared memory, as rows and
// as columns, and for the substitutions lane c holds column c of
// [I | rhs] in D registers, reading L four entries at a time by
// broadcast. HBM is read once (asynchronous copies into shared memory) and
// written once (row by row, coalesced). Each instance is compiled for the
// most blocks per SM that it fits in registers without spills (8 up to
// d = 16, 7 at 23 and 24). d = 32 runs its 33rd column in a second pass of
// lane 0.
//
// Above d = 32 a generic instance takes one block per env: the factor
// (lower triangle, row stride d), 1/L_jj and the d + 1 right-hand sides
// (one contiguous column each) live in shared memory while they fit in the
// 227 KB of a block (d <= 169), else in a per-env global scratch buffer
// that the caller allocates (chol_scratch_floats). The factor's column and
// trailing update run over the block's threads between barriers, and each
// thread then substitutes whole columns of [I | rhs]. It is simple, not
// fast: no shape of the port's robots reaches it.
//
// The arithmetic follows the plain version's order and rounding: every
// division is correctly rounded (exact_math.cuh: a reciprocal per pivot,
// then Markstein's correction, inline, so no library slow-path call makes
// the unrolled loops spill), every square root too, and the product is
// rounded before the subtraction (__fmul_rn/__fsub_rn forbid FMA
// contraction). With FMA or a bare reciprocal the result moves by an ulp
// per step, which the humanoid's worst-conditioned mass matrices amplify
// past the 1e-5 + 1e-4 |x| tolerance against the plain version; so the two
// agree bit for bit.

#include <cuda_runtime.h>

#include "exact_math.cuh"

namespace {

using ntt::div_rn;
using ntt::rcp_rn;
using ntt::sqrt_rn;

constexpr int kWarp = 32;
constexpr int kEnvsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sub_prod(float acc, float a, float b) {
  return __fsub_rn(acc, __fmul_rn(a, b));
}

// Keeps the compiler from hoisting the shared-memory reads of later steps
// of an unrolled loop above this point: hoisted all at once they take more
// registers than a thread has, and spill.
__device__ __forceinline__ void fence() { asm volatile("" ::: "memory"); }

// Blocks per SM each instance is compiled for: the most whose register
// budget (65536 / (128 x blocks)) holds the instance without spills; at 8
// all 1024 blocks of W = 4096 are resident at once
constexpr int min_blocks(int D) { return D <= 16 ? 8 : D <= 24 ? 7 : 2; }

__host__ __device__ constexpr int round4(int D) { return (D + 3) & ~3; }

// shared floats per warp: L^T and L (D rows of round4(D)), 1/L_ii, rhs, a
// column
__host__ __device__ constexpr int warp_floats(int D) {
  return 2 * D * round4(D) + 2 * round4(D) + kWarp;
}

template <int D>
__global__ void __launch_bounds__(kEnvsPerBlock * kWarp, min_blocks(D))
chol_kernel(const float* __restrict__ Mi, const float* __restrict__ rhs,
            float* __restrict__ Minv, float* __restrict__ x, int W, int d) {
  constexpr int S = round4(D);                // row stride, float4-aligned
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int env = blockIdx.x * kEnvsPerBlock + warp;
  float* LT = reinterpret_cast<float*>(smem4) + warp * warp_floats(D);
  float* Lr = LT + D * S;                     // Lr[i * S + k] = L[i][k]
  float* rinv = Lr + D * S;                   // rinv[i] = 1 / L[i][i]
  float* rs = rinv + S;                       // rhs, zero-padded
  float* col = rs + S;
  if (env >= W) return;                       // whole warp; no block barrier

  // stage Mi (into Lr, padded to D x D with the identity) and rhs with
  // asynchronous copies: all loads in flight, none held in registers
  const float* A = Mi + (size_t)env * d * d;
  for (int g = lane; g < D * D; g += kWarp) {
    const int i = g / D, k = g - i * D;
    if (i < d && k < d) ntt::copy_async(Lr + i * S + k, A + i * d + k);
    else Lr[i * S + k] = i == k ? 1.f : 0.f;
  }
  if (lane < S) {
    if (lane < d) ntt::copy_async(rs + lane, rhs + (size_t)env * d + lane);
    else rs[lane] = 0.f;
  }
  ntt::copy_async_wait();
  __syncwarp();
  float a[D];
#pragma unroll
  for (int k = 0; k < D; ++k) a[k] = lane < D ? Lr[lane * S + k] : 0.f;
  __syncwarp();

  // right-looking Cholesky, lane i on row i; entries right of the
  // diagonal are updated too (never read) so that no index depends on i
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float dj = sqrt_rn(fmaxf(__shfl_sync(kFull, a[j], j), 1e-12f));
    const float yj = rcp_rn(dj);
    const float cj = lane > j ? div_rn(a[j], dj, yj) : (lane == j ? dj : 0.f);
    col[lane] = cj;
    if (lane == j) rinv[j] = yj;
    __syncwarp();
    const float4* col4 = reinterpret_cast<const float4*>(col);
#pragma unroll
    for (int q = (j + 1) / 4; q < S / 4; ++q) {
      const float4 v = col4[q];
      const float cv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = 4 * q + t;
        if (k > j && k < D) a[k] = sub_prod(a[k], cj, cv[t]);
      }
      fence();
    }
    a[j] = cj;
    __syncwarp();
    fence();
  }
  if (lane < D) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      LT[k * S + lane] = a[k];
      Lr[lane * S + k] = a[k];
    }
  }
  __syncwarp();

  // L y = b then L^T x = y, lane c on column c of [I | rhs]; rows of L and
  // L^T are read by broadcast, four at a time
  // one column per lane; only d = 32 has a 33rd, for lane 0 in a second
  // pass (the loop is kept rolled: two passes' registers would spill)
#pragma unroll 1
  for (int c = Minv ? lane : d + lane; c <= d; c += kWarp) {
    float b[D];
#pragma unroll
    for (int r = 0; r < D; ++r)
      b[r] = c < d ? (r == c ? 1.f : 0.f) : rs[r];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float4* col4 = reinterpret_cast<const float4*>(LT + i * S);
      const float yi = div_rn(b[i], LT[i * S + i], rinv[i]);
#pragma unroll
      for (int q = (i + 1) / 4; q < S / 4; ++q) {
        const float4 v = col4[q];
        const float l[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int r = 4 * q + t;
          if (r > i && r < D) b[r] = sub_prod(b[r], l[t], yi);
        }
        fence();
      }
      b[i] = yi;
      fence();
    }
#pragma unroll
    for (int i = D - 1; i >= 0; --i) {
      const float4* row4 = reinterpret_cast<const float4*>(Lr + i * S);
      const float xi = div_rn(b[i], Lr[i * S + i], rinv[i]);
#pragma unroll
      for (int q = 0; q < (i + 3) / 4; ++q) {
        const float4 v = row4[q];
        const float l[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int r = 4 * q + t;
          if (r < i) b[r] = sub_prod(b[r], l[t], xi);
        }
        fence();
      }
      b[i] = xi;
      fence();
    }
    const size_t e = (size_t)ntt::fresh_bid() * kEnvsPerBlock
                     + ntt::fresh_tid() / kWarp;
    float* out = c < d ? Minv + e * d * d + c : x + e * d;
    const int step = c < d ? d : 1;
#pragma unroll
    for (int r = 0; r < D; ++r)
      if (r < d) out[r * step] = b[r];
  }
}

// floats of one env in the generic instance: the factor (d x d, lower
// triangle used), 1/L_jj (d) and the d + 1 columns of [I | rhs] (d each)
__host__ __device__ size_t generic_floats(int d) {
  return (size_t)d * d + d + (size_t)d * (d + 1);
}

constexpr size_t kMaxSmem = 227 * 1024;

// The generic instance: one block per env, any d. L, rinv and the columns
// of [I | rhs] live at `buf`, in shared memory (kGlobal false) or in this
// env's slice of the caller's scratch (kGlobal true). Same arithmetic, in
// the same order, as chol_kernel and the plain version.
template <bool kGlobal>
__global__ void __launch_bounds__(256)
chol_kernel_generic(const float* __restrict__ Mi,
                    const float* __restrict__ rhs, float* __restrict__ Minv,
                    float* __restrict__ x, int d, float* scratch) {
  extern __shared__ float4 smem4[];
  const size_t e = blockIdx.x;
  float* L = kGlobal ? scratch + e * generic_floats(d)
                     : reinterpret_cast<float*>(smem4);
  float* rinv = L + (size_t)d * d;
  float* B = rinv + d;                        // B[c * d + r]: column c
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* A = Mi + e * d * d;
  for (int g = tid; g < d * d; g += nt) L[g] = A[g];
  for (int g = (Minv ? 0 : d * d) + tid; g < d * (d + 1); g += nt) {
    const int c = g / d, r = g - c * d;
    B[g] = c < d ? (r == c ? 1.f : 0.f) : rhs[e * d + r];
  }
  __syncthreads();

  // right-looking Cholesky; the trailing update keeps the lower triangle
  // (j < k <= i), the only part the later steps and the solves read
  for (int j = 0; j < d; ++j) {
    const float dj = sqrt_rn(fmaxf(L[j * d + j], 1e-12f));
    const float yj = rcp_rn(dj);
    for (int i = j + 1 + tid; i < d; i += nt)
      L[i * d + j] = div_rn(L[i * d + j], dj, yj);
    __syncthreads();
    if (tid == 0) {
      L[j * d + j] = dj;
      rinv[j] = yj;
    }
    const int m = d - j - 1;
    for (int g = tid; g < m * m; g += nt) {
      const int i = j + 1 + g / m, k = j + 1 + g % m;
      if (k <= i) L[i * d + k] = sub_prod(L[i * d + k], L[i * d + j],
                                          L[k * d + j]);
    }
    __syncthreads();
  }

  // L y = b then L^T x = y, one thread per column of [I | rhs] (of rhs
  // alone without Minv)
  for (int c = (Minv ? 0 : d) + tid; c <= d; c += nt) {
    float* b = B + (size_t)c * d;
    for (int i = 0; i < d; ++i) {
      const float yi = div_rn(b[i], L[i * d + i], rinv[i]);
      b[i] = yi;
      for (int r = i + 1; r < d; ++r) b[r] = sub_prod(b[r], L[r * d + i], yi);
    }
    for (int i = d - 1; i >= 0; --i) {
      const float xi = div_rn(b[i], L[i * d + i], rinv[i]);
      b[i] = xi;
      for (int r = 0; r < i; ++r) b[r] = sub_prod(b[r], L[i * d + r], xi);
    }
  }
  __syncthreads();
  for (int g = tid; Minv && g < d * d; g += nt) {
    const int r = g / d, c = g - r * d;
    Minv[e * d * d + g] = B[(size_t)c * d + r];
  }
  for (int r = tid; r < d; r += nt) x[e * d + r] = B[(size_t)d * d + r];
}

using Kernel = void (*)(const float*, const float*, float*, float*, int, int);
using GenericKernel = void (*)(const float*, const float*, float*, float*,
                               int, float*);

// Instance codes, mirrored by linalg.kernel_instance: the register size D,
// or kGenericSmem / kGenericGlobal.
constexpr int kGenericSmem = 100, kGenericGlobal = 101;

int instance(int d) {
  if (d <= kWarp)
    return d <= 8 ? 8 : d == 14 ? 14 : d <= 16 ? 16 : d == 23 ? 23
           : d <= 24 ? 24 : 32;
  return generic_floats(d) * sizeof(float) <= kMaxSmem ? kGenericSmem
                                                      : kGenericGlobal;
}

// the register instance of size D
Kernel pick(int D) {
  switch (D) {
    case 8: return chol_kernel<8>;
    case 14: return chol_kernel<14>;
    case 16: return chol_kernel<16>;
    case 23: return chol_kernel<23>;
    case 24: return chol_kernel<24>;
    default: return chol_kernel<32>;
  }
}

size_t smem_bytes(int D) {
  return (size_t)kEnvsPerBlock * warp_floats(D) * sizeof(float);
}

int generic_threads(int d) { return d < 64 ? 64 : d < 128 ? 128 : 256; }

// The generic kernel for an instance code, its threads and dynamic shared
// memory; the shared-memory kernel opts in above 48 KB.
cudaError_t generic_launch(int inst, int d, GenericKernel* k, int* threads,
                           size_t* smem) {
  *k = inst == kGenericSmem ? chol_kernel_generic<false>
                            : chol_kernel_generic<true>;
  *threads = generic_threads(d);
  *smem = inst == kGenericSmem ? generic_floats(d) * sizeof(float) : 0;
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(
        *k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return cudaSuccess;
}

}  // namespace

// Which instance chol_inv_solve_f32 runs at d (see instance()).
extern "C" int chol_kernel_instance(int d) {
  return d < 1 ? -1 : instance(d);
}

// Floats of global scratch per env that chol_inv_solve_f32 needs at d (0:
// the instance keeps everything on chip).
extern "C" long long chol_scratch_floats(int d) {
  return d >= 1 && instance(d) == kGenericGlobal
             ? (long long)generic_floats(d) : 0;
}

// Minv null: x alone (no inverse is computed or written).
extern "C" int chol_inv_solve_f32(const float* Mi, const float* rhs,
                                  float* Minv, float* x, int W, int d,
                                  float* scratch, void* stream) {
  if (W <= 0) return 0;
  if (d < 1) return (int)cudaErrorInvalidValue;
  const int inst = instance(d);
  if (inst == kGenericGlobal && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (inst < kGenericSmem) {
    const int blocks = (W + kEnvsPerBlock - 1) / kEnvsPerBlock;
    pick(inst)<<<blocks, kEnvsPerBlock * kWarp, smem_bytes(inst),
                 (cudaStream_t)stream>>>(Mi, rhs, Minv, x, W, d);
    return (int)cudaGetLastError();
  }
  GenericKernel k;
  int threads;
  size_t smem;
  const cudaError_t e = generic_launch(inst, d, &k, &threads, &smem);
  if (e != cudaSuccess) return (int)e;
  k<<<W, threads, smem, (cudaStream_t)stream>>>(Mi, rhs, Minv, x, d,
                                                 scratch);
  return (int)cudaGetLastError();
}

// Registers per thread and resident blocks per SM of the launch that
// chol_inv_solve_f32 makes at d.
extern "C" int chol_kernel_info(int d, int* regs, int* blocks_per_sm) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  const int inst = instance(d);
  cudaFuncAttributes a;
  if (inst < kGenericSmem) {
    const Kernel k = pick(inst);
    const cudaError_t e = cudaFuncGetAttributes(&a, k);
    if (e != cudaSuccess) return (int)e;
    *regs = a.numRegs;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, k, kEnvsPerBlock * kWarp, smem_bytes(inst));
  }
  GenericKernel k;
  int threads;
  size_t smem;
  cudaError_t e = generic_launch(inst, d, &k, &threads, &smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, threads, smem);
}

extern "C" const char* ntt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
