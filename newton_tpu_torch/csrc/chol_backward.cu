// Backward of the batched SPD solve (K3).
//
// The TPU kernel newton_tpu/solvers/generalized/linalg_pallas.py ::
// chol_inv_solve_pallas has no backward of its own: jax.grad reaches its
// call site (batched._chol_t / _cho_solve_t) only on the XLA branch, and
// differentiates the plain factor and substitutions. This kernel is the
// backward of the port's B1 launch (csrc/chol_inv_solve.cu), so that a
// gradient through the batched step on the card goes through a kernel.
//
// Per env, from the forward's Minv = Mi^-1 and x = Minv rhs and the
// cotangents gx (of x) and gMinv (of Minv), either of which may be null:
//   grhs = Minv gx                                   (the rhs gradient)
//   G    = -(grhs x^T + Minv gMinv Minv)             (the Mi gradient)
// The plain factor reads only the lower triangle of Mi, so the gradient it
// gives is G folded onto that triangle: G_ij + G_ji below the diagonal,
// G_ii on it and 0 above; the kernel writes the same. Called with Minv null
// (chol_solve, whose forward keeps no inverse), grhs is an input, solved by
// one more B1 launch, and G = -grhs x^T.
//
// What bounds it on an H100: bytes. At the ant's d = 14, W = 4096, a call
// must read Minv, gMinv, x and gx and write gMi and grhs, 2,520 B an env
// (3.1 us at 3.35 TB/s); its 4 d^3 + 4 d^2 FLOPs an env are 0.7 us at the
// float32 peak. The first design (one warp per env, lane i owning rows i,
// i + 32, ... of each product, T = gMinv Minv through global scratch) left
// 18 of 32 lanes idle at d = 14 and ran each lane's 2 d^2 dot products as
// one serial chain of strided global loads: 39.5 us, a chain, not bytes.
//
// Design, for d <= 32 (B1's instance at d, chol_kernel_instance: D = 8,
// 14, 16, 23, 24, 32; a smaller d runs in the next larger one, 14 and 23
// exact):
//   - a warp holds P = 32 / L envs, L = 8, 16 or 32 lanes an env (two
//     envs a warp at d = 14), four warps a block;
//   - the warp stages its envs' Minv and gMinv into shared memory with
//     coalesced loads (the envs' d^2 floats are contiguous), rows padded to
//     a multiple of 4 floats and the padding zero; each env's area is
//     skewed by L banks, so the lanes of a warp never meet in one bank;
//   - lane j of an env owns column j of every product: it holds column j
//     of Minv in registers, forms column j of T = gMinv Minv (rows of gMinv
//     read as float4 broadcasts), keeps it in registers, and forms column j
//     of S = Minv T and G = -(grhs x^T + S) the same way. T never leaves
//     the registers, and each lane runs d chains of d FMAs, not 2 d^2;
//   - G goes to shared memory over gMinv's rows, and the warp writes the
//     folded gMi once, coalesced.
// Each sum runs k = 0 .. d - 1 in order, as before. Above d = 32 the first
// design stays as the generic instance (one warp per env, T in a per-env
// global scratch), as B1 keeps a generic instance above its register ones.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kGeneric = 101;      // linalg.INSTANCE_CODES["generic_global"]

// -------------------------------------------------- d <= 32: in a warp --
template <int D>
struct Shape {
  static constexpr int L = D <= 8 ? 8 : (D <= 16 ? 16 : 32);  // lanes/env
  static constexpr int P = kWarp / L;                         // envs/warp
  static constexpr int SD = (D + 3) & ~3;                     // row stride
  // Minv rows, gMinv rows (then G), grhs, x, gx; rounded up so that env e
  // of a warp starts e L banks on (its column j then sits in bank e L + j)
  static constexpr int kRaw = 2 * D * SD + 3 * SD;
  static constexpr int kEnv = kRaw + ((L - kRaw % kWarp) % kWarp + kWarp)
                                         % kWarp;
  static constexpr int kWarpFloats = P * kEnv;
};

// sum_k row[k] col[k], k = 0 .. D - 1 in order; row is 16-byte aligned
template <int D>
__device__ __forceinline__ float dot_row(const float* row, const float* col) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < D; k += 4) {
    const float4 r = *reinterpret_cast<const float4*>(row + k);
    s += r.x * col[k];
    if (k + 1 < D) s += r.y * col[k + 1];
    if (k + 2 < D) s += r.z * col[k + 2];
    if (k + 3 < D) s += r.w * col[k + 3];
  }
  return s;
}

template <int D>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
chol_backward_warp(const float* __restrict__ Minv,
                   const float* __restrict__ x,
                   const float* __restrict__ gx,
                   const float* __restrict__ gMinv,
                   float* __restrict__ grhs, float* __restrict__ gMi, int W,
                   int d_arg) {
  using S = Shape<D>;
  __shared__ __align__(16) float sh[kWarpsPerBlock * S::kWarpFloats];
  // 14 and 23 run only at their own size: d is then a constant
  const int d = (D == 14 || D == 23) ? D : d_arg;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int env0 = (blockIdx.x * kWarpsPerBlock + warp) * S::P;
  if (env0 >= W) return;  // the whole warp leaves together
  const int n_env = min(S::P, W - env0);
  const int dd = d * d;
  float* base = sh + warp * S::kWarpFloats;
  for (int f = 4 * lane; f < S::kWarpFloats; f += 4 * kWarp)
    *reinterpret_cast<float4*>(base + f) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  // stage: the warp's envs are contiguous in every operand
  const size_t m0 = (size_t)env0 * dd, v0 = (size_t)env0 * d;
  for (int f = lane; f < n_env * dd; f += kWarp) {
    const int e = f / dd, r = f - e * dd, i = r / d, k = r - i * d;
    float* A = base + e * S::kEnv;
    if (Minv) A[i * S::SD + k] = Minv[m0 + f];
    if (gMinv) A[D * S::SD + i * S::SD + k] = gMinv[m0 + f];
  }
  for (int f = lane; f < n_env * d; f += kWarp) {
    const int e = f / d, i = f - e * d;
    float* V = base + e * S::kEnv + 2 * D * S::SD;  // grhs, x, gx
    if (!Minv) V[i] = grhs[v0 + f];
    V[S::SD + i] = x[v0 + f];
    if (gx) V[2 * S::SD + i] = gx[v0 + f];
  }
  __syncwarp();
  const int e = lane / S::L, j = lane % S::L;
  float* A = base + e * S::kEnv;      // Minv, rows of stride SD
  float* B = A + D * S::SD;           // gMinv, then G
  float* gr = B + D * S::SD;
  const float* xs = gr + S::SD;
  const float* gs = xs + S::SD;
  const bool mine = e < n_env && j < d;
  if (Minv && gx) {
    if (mine) gr[j] = dot_row<D>(A + j * S::SD, gs);
    __syncwarp();
  }
  const bool full = Minv && gMinv;
  if (full) {
    // lanes past SD read beyond their column (d = 23: lanes 24-31); their
    // sums are never written
    float cm[D], ct[D];
#pragma unroll
    for (int k = 0; k < D; ++k) cm[k] = A[k * S::SD + j];
#pragma unroll
    for (int i = 0; i < D; ++i) ct[i] = dot_row<D>(B + i * S::SD, cm);
    __syncwarp();  // every lane has read gMinv before G overwrites it
    const float xj = xs[j];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float s = dot_row<D>(A + i * S::SD, ct);
      if (mine) B[i * S::SD + j] = -(gr[i] * xj + s);
    }
    __syncwarp();
  }
  // the fold, written once: the warp's envs' gMi are contiguous
  for (int f = lane; f < n_env * dd; f += kWarp) {
    const int e2 = f / dd, r = f - e2 * dd, i = r / d, k = r - i * d;
    const float* A2 = base + e2 * S::kEnv;
    const float* G = A2 + D * S::SD;
    const float* g2 = G + D * S::SD;
    const float* x2 = g2 + S::SD;
    float v = 0.f;
    if (k <= i) {
      if (full) {
        v = G[i * S::SD + k];
        if (k < i) v += G[k * S::SD + i];
      } else {
        v = -(g2[i] * x2[k]);
        if (k < i) v += -(g2[k] * x2[i]);
      }
    }
    gMi[m0 + f] = v;
  }
  if (Minv)
    for (int f = lane; f < n_env * d; f += kWarp) {
      const int e2 = f / d, i = f - e2 * d;
      grhs[v0 + f] = base[e2 * S::kEnv + 2 * D * S::SD + i];
    }
}

// ------------------------------------------- d > 32: the generic one --
// One warp per env: lane i owns rows i, i + 32, ... of every product; T =
// gMinv Minv goes to a per-env global scratch (L1 and L2 hold it: the card
// reads it back at once) and the second product reads it after a warp
// barrier. The fold runs in two passes so that no lane overwrites an entry
// another lane still reads. Four envs a block.
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
chol_backward_generic(const float* __restrict__ Minv,
                      const float* __restrict__ x,
                      const float* __restrict__ gx,
                      const float* __restrict__ gMinv, float* grhs,
                      float* gMi, float* T, int W, int d) {
  const int env = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (env >= W) return;  // the whole warp leaves together
  const size_t dd = (size_t)d * d;
  const float* Mi = Minv ? Minv + env * dd : nullptr;
  const float* xe = x + (size_t)env * d;
  float* gr = grhs + (size_t)env * d;
  float* G = gMi + env * dd;
  if (Mi) {
    const float* g = gx ? gx + (size_t)env * d : nullptr;
    for (int i = lane; i < d; i += kWarp) {
      float s = 0.f;
      if (g)
        for (int k = 0; k < d; ++k) s += Mi[i * d + k] * g[k];
      gr[i] = s;
    }
  }
  __syncwarp();
  if (Mi && gMinv) {
    const float* gM = gMinv + env * dd;
    float* Te = T + env * dd;
    for (int i = lane; i < d; i += kWarp)
      for (int j = 0; j < d; ++j) {
        float s = 0.f;
        for (int k = 0; k < d; ++k) s += gM[i * d + k] * Mi[k * d + j];
        Te[i * d + j] = s;
      }
    __syncwarp();
    for (int i = lane; i < d; i += kWarp)
      for (int j = 0; j < d; ++j) {
        float s = 0.f;
        for (int k = 0; k < d; ++k) s += Mi[i * d + k] * Te[k * d + j];
        G[i * d + j] = -(gr[i] * xe[j] + s);
      }
  } else {
    for (int i = lane; i < d; i += kWarp)
      for (int j = 0; j < d; ++j) G[i * d + j] = -(gr[i] * xe[j]);
  }
  __syncwarp();
  // fold: lane i writes the lower part of its rows and reads only the
  // upper part of earlier rows, which no lane writes in this pass
  for (int i = lane; i < d; i += kWarp)
    for (int j = 0; j < i; ++j) G[i * d + j] += G[j * d + i];
  __syncwarp();
  for (int i = lane; i < d; i += kWarp)
    for (int j = i + 1; j < d; ++j) G[i * d + j] = 0.f;
}

using Launch = int (*)(const float*, const float*, const float*,
                      const float*, float*, float*, int, int, float*,
                      cudaStream_t);

template <int D>
int launch_warp(const float* Minv, const float* x, const float* gx,
                const float* gMinv, float* grhs, float* gMi, int W, int d,
                float*, cudaStream_t st) {
  const int per_block = kWarpsPerBlock * Shape<D>::P;
  chol_backward_warp<D><<<(W + per_block - 1) / per_block,
                          kWarpsPerBlock * kWarp, 0, st>>>(
      Minv, x, gx, gMinv, grhs, gMi, W, d);
  return (int)cudaGetLastError();
}

int launch_generic(const float* Minv, const float* x, const float* gx,
                   const float* gMinv, float* grhs, float* gMi, int W, int d,
                   float* scratch, cudaStream_t st) {
  if (gMinv && !scratch) return (int)cudaErrorInvalidValue;
  const int blocks = (W + kWarpsPerBlock - 1) / kWarpsPerBlock;
  chol_backward_generic<<<blocks, kWarpsPerBlock * kWarp, 0, st>>>(
      Minv, x, gx, gMinv, grhs, gMi, scratch, W, d);
  return (int)cudaGetLastError();
}

// K3's instances: code (linalg.INSTANCE_CODES), kernel, launch
struct Instance {
  int code;
  const void* kernel;
  Launch launch;
};
const Instance kInstances[] = {
    {8, (const void*)chol_backward_warp<8>, launch_warp<8>},
    {14, (const void*)chol_backward_warp<14>, launch_warp<14>},
    {16, (const void*)chol_backward_warp<16>, launch_warp<16>},
    {23, (const void*)chol_backward_warp<23>, launch_warp<23>},
    {24, (const void*)chol_backward_warp<24>, launch_warp<24>},
    {32, (const void*)chol_backward_warp<32>, launch_warp<32>},
    {kGeneric, (const void*)chol_backward_generic, launch_generic}};

}  // namespace

// B1's instance at d (csrc/chol_inv_solve.cu)
extern "C" int chol_kernel_instance(int d);

// the instance that runs d >= 1: B1's register size D for d <= 32, the
// generic one above (linalg.backward_instance names it)
static const Instance& instance(int d) {
  const int code = d > kWarp ? kGeneric : chol_kernel_instance(d);
  for (const Instance& k : kInstances)
    if (k.code == code) return k;
  return kInstances[sizeof(kInstances) / sizeof(kInstances[0]) - 1];
}

// Minv null: grhs is an input (chol_solve's backward); else it is written.
// gx or gMinv may be null (a zero cotangent); scratch (W d d floats) is
// needed when gMinv is given and d > 32 (the generic instance).
extern "C" int chol_inv_solve_backward_f32(const float* Minv, const float* x,
                                           const float* gx,
                                           const float* gMinv, float* grhs,
                                           float* gMi, int W, int d,
                                           float* scratch, void* stream) {
  if (W <= 0) return 0;
  if (d < 1 || (gMinv && !Minv)) return (int)cudaErrorInvalidValue;
  return instance(d).launch(Minv, x, gx, gMinv, grhs, gMi, W, d, scratch,
                            (cudaStream_t)stream);
}

// Registers per thread and resident blocks per SM of K3's instance at d.
extern "C" int chol_backward_kernel_info(int d, int* regs,
                                         int* blocks_per_sm) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  const void* k = instance(d).kernel;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, kWarpsPerBlock * kWarp, 0);
}
