// Backward of the batched SPD solve (K3), one warp per env.
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
// float32 peak.
//
// Design: simple first. Lane i owns rows i, i + 32, ... of every d x d
// product; T = gMinv Minv goes to a per-env global scratch (L1 and L2 hold
// it: the card reads it back at once) and the second product reads it
// after a warp barrier. The fold runs in two passes so that no lane
// overwrites an entry another lane still reads. Four envs a block.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kEnvsPerBlock = 4;

__global__ void __launch_bounds__(kEnvsPerBlock * kWarp)
chol_backward_kernel(const float* __restrict__ Minv,
                     const float* __restrict__ x,
                     const float* __restrict__ gx,
                     const float* __restrict__ gMinv, float* grhs,
                     float* gMi, float* T, int W, int d) {
  const int env = blockIdx.x * kEnvsPerBlock + threadIdx.x / kWarp;
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

}  // namespace

// Minv null: grhs is an input (chol_solve's backward); else it is written.
// gx or gMinv may be null (a zero cotangent); scratch (W d d floats) is
// needed when gMinv is given.
extern "C" int chol_inv_solve_backward_f32(const float* Minv, const float* x,
                                           const float* gx,
                                           const float* gMinv, float* grhs,
                                           float* gMi, int W, int d,
                                           float* scratch, void* stream) {
  if (W <= 0) return 0;
  if (d < 1 || (gMinv && (!Minv || !scratch)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (W + kEnvsPerBlock - 1) / kEnvsPerBlock;
  chol_backward_kernel<<<blocks, kEnvsPerBlock * kWarp, 0,
                         (cudaStream_t)stream>>>(Minv, x, gx, gMinv, grhs,
                                                 gMi, scratch, W, d);
  return (int)cudaGetLastError();
}

// Registers per thread and resident blocks per SM of K3's launch.
extern "C" int chol_backward_kernel_info(int* regs, int* blocks_per_sm) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, chol_backward_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, chol_backward_kernel, kEnvsPerBlock * kWarp, 0);
}
