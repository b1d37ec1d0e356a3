// Batched small SPD factor + solve + explicit inverse, one warp per env.
//
// Replaces the TPU kernel newton_tpu/solvers/generalized/linalg_pallas.py
// :: chol_inv_solve_pallas (body _kernel, math _chol_core / _solve_core):
// per env, the lower Cholesky factor of Mi = M + dt*diag(kd) (diagonal
// clamped as sqrt(max(L_jj, 1e-12))), then forward and back substitution
// for the d+1 right-hand sides [I | rhs]. Outputs Minv and x = Mi^-1 rhs.
//
// What bounds it on an H100: neither bytes nor flops. At ant size (d = 14,
// W = 4096) a call moves ~6.9 MB (a few microseconds of HBM time) and does
// ~4k FMAs per env. The cost is the serial dependency chain: d factor steps
// and 2d substitution steps, each a shared-memory round trip behind a warp
// barrier. Latency, so occupancy is what hides it.
//
// Design: each env's whole working set (L, the d x (d+1) right-hand-side
// block and one column buffer, ~2.1 KB at d = 14, 8.4 KB at d = 32) stays
// in shared memory from the first load to the last store, as the TPU
// kernel kept it in VMEM; HBM is read once and written once. Lanes run over
// rows during the factorization (one column per step, __syncwarp between
// steps) and over right-hand-side columns during the substitutions, where
// columns are independent and need no barrier at all. Four warps (four
// envs) per block keep enough warps resident per SM to cover the chain.
// d <= 32; the wrapper raises beyond that.
//
// The arithmetic follows the plain version's order (division by the
// pivot, product then subtraction, no FMA contraction) so the two agree to
// a few ulp.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kEnvsPerBlock = 4;

__device__ __forceinline__ float sub_prod(float acc, float a, float b) {
  return __fsub_rn(acc, __fmul_rn(a, b));
}

__global__ void chol_inv_solve_kernel(const float* __restrict__ Mi,
                                      const float* __restrict__ rhs,
                                      float* __restrict__ Minv,
                                      float* __restrict__ x, int W, int d) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int env = blockIdx.x * kEnvsPerBlock + warp;
  const int nb = d + 1;                       // columns of [I | rhs]
  float* L = smem + warp * (d * d + d * nb + d);
  float* B = L + d * d;
  float* col = B + d * nb;
  if (env >= W) return;                       // whole warp; no block barrier

  const float* A = Mi + (size_t)env * d * d;
  for (int i = lane; i < d * d; i += kWarp) L[i] = A[i];
  for (int i = lane; i < d * nb; i += kWarp) {
    const int r = i / nb, c = i - r * nb;
    B[i] = (c < d) ? (r == c ? 1.f : 0.f) : rhs[(size_t)env * d + r];
  }
  __syncwarp();

  // right-looking Cholesky on the lower triangle, lanes over rows
  for (int j = 0; j < d; ++j) {
    const float diag = sqrtf(fmaxf(L[j * d + j], 1e-12f));
    float cj = 0.f;
    if (lane < d) {
      cj = lane > j ? __fdiv_rn(L[lane * d + j], diag)
                    : (lane == j ? diag : 0.f);
      col[lane] = cj;
    }
    __syncwarp();
    if (lane > j && lane < d) {
      for (int k = j + 1; k <= lane; ++k)
        L[lane * d + k] = sub_prod(L[lane * d + k], cj, col[k]);
    }
    if (lane < d) L[lane * d + j] = cj;
    __syncwarp();
  }

  // L y = B then L^T x = y, lanes over right-hand-side columns
  for (int c = lane; c < nb; c += kWarp) {
    for (int i = 0; i < d; ++i) {
      const float yi = __fdiv_rn(B[i * nb + c], L[i * d + i]);
      for (int r = i + 1; r < d; ++r)
        B[r * nb + c] = sub_prod(B[r * nb + c], L[r * d + i], yi);
      B[i * nb + c] = yi;
    }
    for (int i = d - 1; i >= 0; --i) {
      const float xi = __fdiv_rn(B[i * nb + c], L[i * d + i]);
      for (int r = 0; r < i; ++r)
        B[r * nb + c] = sub_prod(B[r * nb + c], L[i * d + r], xi);
      B[i * nb + c] = xi;
    }
  }
  __syncwarp();

  float* out = Minv + (size_t)env * d * d;
  for (int i = lane; i < d * d; i += kWarp) {
    const int r = i / d, c = i - r * d;
    out[i] = B[r * nb + c];
  }
  if (lane < d) x[(size_t)env * d + lane] = B[lane * nb + d];
}

}  // namespace

extern "C" int chol_inv_solve_f32(const float* Mi, const float* rhs,
                                  float* Minv, float* x, int W, int d,
                                  void* stream) {
  if (W <= 0) return 0;
  if (d < 1 || d > kWarp) return (int)cudaErrorInvalidValue;
  const int blocks = (W + kEnvsPerBlock - 1) / kEnvsPerBlock;
  const size_t smem =
      (size_t)kEnvsPerBlock * (d * d + d * (d + 1) + d) * sizeof(float);
  chol_inv_solve_kernel<<<blocks, kEnvsPerBlock * kWarp, smem,
                          (cudaStream_t)stream>>>(Mi, rhs, Minv, x, W, d);
  return (int)cudaGetLastError();
}

extern "C" const char* ntt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
