// Fused Delassus assembly + projected-Jacobi contact solve, one block per env.
//
// Replaces the TPU kernel newton_tpu/solvers/generalized/pgs_pallas.py
// :: pgs_solve_pallas_fused (body _kernel_fused; math pgs_core,
// spectral_lam_max, spectral_iters). Per env:
//   1. MJ = J Minv (= (Minv J^T)^T), the Delassus diagonal
//      diag = rowsum(J * MJ) * diag_scale + reg and v_free = J qd; joint-
//      limit rows are signed one-hots on the dofs in ld, never
//      materialized: their columns are read from Minv[:, ld] directly;
//   2. a matrix-free power-iteration bound on lambda_max(D^-1/2 A D^-1/2)
//      (3 iterations when r < 192, else 8) and the step
//      min(1, 1.8 / max(1.1 lambda, 1e-9)) * omega;
//   3. `iters` JACOBI sweeps (every row reads the same lambda) with a
//      pyramid or cone friction projection and a normal/limit clamp at
//      >= 0, masked by act; non-finite values reset to 0;
//   4. a per-env divergence guard that halves the step when
//      ||dlambda||^2 > 1.02 * previous.
// Outputs lambda (r rows, block order [n | t1 | t2 | lim-lo | lim-hi]),
// dqd = MJ^T lambda_c + Minv[:, ld] (lambda_lo - lambda_hi) and the number
// of halvings per env.
//
// What bounds it on an H100: latency and on-chip traffic, not HBM. At ant
// size (3c = 75 contact rows, d = 14, r = 91, W = 4096) the inputs are
// ~26 MB, read once; the work is 3 + 8 matvecs of ~2 x 75 x 14 FMAs plus
// the 75 x 14 x 14 assembly per env, ~0.3 GFLOP per call. Each matvec is
// two dependent phases (J^T-side reduction into d values, then the J-side
// expansion into rows) separated by block barriers, and every sweep ends
// in a block-wide norm reduction that the divergence guard needs before
// the next sweep may start.
//
// Design: J, MJ, Minv, diag, v_free, b, act, mu and lambda stay in shared
// memory for all 3 + iters matvec rounds (the TPU kernel's VMEM
// residency): ~12 KB per env at ant size, so many blocks fit per SM and
// their barriers overlap. Threads run over rows; the per-env norms are
// warp-shuffle + shared-memory block reductions. Above 48 KB (humanoid
// uncompacted: 3c = 576, d = 23, ~125 KB) the launcher opts in to large
// dynamic shared memory; above the card's 227 KB it refuses the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 227 * 1024;

struct Dims {
  int c, nl, d, r3, r;
};

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
    red[32] = s;
  }
  __syncthreads();
  return red[32];
}

// y = A x with A = J Minv J^T extended by the one-hot limit rows.
// tmp (d) is scratch; x and y must not alias.
__device__ void delassus_matvec(const Dims& D, const float* J,
                                const float* MJ, const float* Minv,
                                const int* ld, const float* x, float* y,
                                float* tmp) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int f = tid; f < D.d; f += nt) {
    float s = 0.f;
    for (int k = 0; k < D.r3; ++k) s += MJ[k * D.d + f] * x[k];
    if (D.nl) {
      float sl = 0.f;
      for (int l = 0; l < D.nl; ++l)
        sl += Minv[f * D.d + ld[l]] * (x[D.r3 + l] - x[D.r3 + D.nl + l]);
      s += sl;
    }
    tmp[f] = s;
  }
  __syncthreads();
  for (int k = tid; k < D.r3; k += nt) {
    float s = 0.f;
    for (int f = 0; f < D.d; ++f) s += J[k * D.d + f] * tmp[f];
    y[k] = s;
  }
  for (int l = tid; l < D.nl; l += nt) {
    const float t = tmp[ld[l]];
    y[D.r3 + l] = t;
    y[D.r3 + D.nl + l] = -t;
  }
  __syncthreads();
}

__device__ __forceinline__ float finite_or_zero(float v) {
  return isfinite(v) ? v : 0.f;
}

__global__ void pgs_kernel(const float* __restrict__ gJ,
                           const float* __restrict__ gMinv,
                           const float* __restrict__ gqd,
                           const float* __restrict__ gb,
                           const float* __restrict__ gact,
                           const float* __restrict__ gmu,
                           const float* __restrict__ glam0,
                           const int* __restrict__ gld,
                           float* __restrict__ glam, float* __restrict__ gdqd,
                           int* __restrict__ ghalv, Dims D, int iters,
                           int spectral_iters, float omega, int use_cone,
                           float diag_scale, float reg) {
  extern __shared__ float sm[];
  const int env = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int c = D.c, nl = D.nl, d = D.d, r3 = D.r3, r = D.r;
  float* J = sm;
  float* MJ = J + r3 * d;
  float* Minv = MJ + r3 * d;
  float* qd = Minv + d * d;
  float* tmp = qd + d;
  float* diag = tmp + d;
  float* vfree = diag + r;
  float* b = vfree + r;
  float* act = b + r;
  float* lam = act + r;
  float* lam_next = lam + r;
  float* y = lam_next + r;
  float* u = y + r;
  float* mu = u + r;
  float* red = mu + c;                         // 33 floats
  int* ld = (int*)(red + 33);

  const size_t e = (size_t)env;
  for (int i = tid; i < r3 * d; i += nt) J[i] = gJ[e * r3 * d + i];
  for (int i = tid; i < d * d; i += nt) Minv[i] = gMinv[e * d * d + i];
  for (int i = tid; i < d; i += nt) qd[i] = gqd[e * d + i];
  for (int i = tid; i < r; i += nt) {
    b[i] = gb[e * r + i];
    act[i] = gact[e * r + i];
    lam[i] = glam0[e * r + i];
  }
  for (int i = tid; i < c; i += nt) mu[i] = gmu[e * c + i];
  for (int i = tid; i < nl; i += nt) ld[i] = gld[i];
  __syncthreads();

  // 1. Delassus pieces: MJ = J Minv, diag, v_free
  for (int i = tid; i < r3 * d; i += nt) {
    const int k = i / d, f = i - k * d;
    float s = 0.f;
    for (int q = 0; q < d; ++q) s += J[k * d + q] * Minv[q * d + f];
    MJ[i] = s;
  }
  __syncthreads();
  for (int k = tid; k < r3; k += nt) {
    float s = 0.f, v = 0.f;
    for (int f = 0; f < d; ++f) {
      s += J[k * d + f] * MJ[k * d + f];
      v += J[k * d + f] * qd[f];
    }
    diag[k] = s * diag_scale + reg;
    vfree[k] = v;
  }
  for (int l = tid; l < nl; l += nt) {
    const int q = ld[l];
    const float dl = Minv[q * d + q] * diag_scale + reg;
    diag[r3 + l] = dl;
    diag[r3 + nl + l] = dl;
    vfree[r3 + l] = qd[q];
    vfree[r3 + nl + l] = -qd[q];
  }
  __syncthreads();

  // 2. power-iteration bound on lambda_max(D^-1/2 A D^-1/2), started from
  //    the active-row indicator; the estimate is ||A u_k|| of the last step
  float part = 0.f;
  for (int k = tid; k < r; k += nt) part += act[k] * act[k];
  const float n0 = sqrtf(block_sum(part, red));
  for (int k = tid; k < r; k += nt) u[k] = act[k] / fmaxf(n0, 1.f);
  float lam_max = 0.f;
  for (int it = 0; it < spectral_iters; ++it) {
    for (int k = tid; k < r; k += nt) lam_next[k] = rsqrtf(diag[k]) * u[k];
    __syncthreads();
    delassus_matvec(D, J, MJ, Minv, ld, lam_next, y, tmp);
    part = 0.f;
    for (int k = tid; k < r; k += nt) {
      const float v = rsqrtf(diag[k]) * y[k] * act[k];
      u[k] = v;
      part += v * v;
    }
    const float nrm = sqrtf(block_sum(part, red));
    lam_max = nrm;
    for (int k = tid; k < r; k += nt) u[k] = u[k] / fmaxf(nrm, 1e-9f);
    __syncthreads();
  }
  float scale =
      omega * fminf(1.f, 1.8f / fmaxf(1.1f * lam_max, 1e-9f));

  // 3-4. projected Jacobi sweeps with the divergence guard
  float prev_dn = 0.f;
  int halvings = 0;
  for (int it = 0; it < iters; ++it) {
    delassus_matvec(D, J, MJ, Minv, ld, lam, y, tmp);
    for (int k = tid; k < r; k += nt)
      y[k] = lam[k] - (scale / diag[k]) * ((y[k] + vfree[k]) - b[k]);
    __syncthreads();
    part = 0.f;
    for (int i = tid; i < c; i += nt) {
      const float ln = fmaxf(y[i], 0.f);
      const float cap = mu[i] * ln;
      float lt1 = y[c + i], lt2 = y[2 * c + i];
      if (use_cone) {
        const float tmag = sqrtf(lt1 * lt1 + lt2 * lt2);
        const float sc = fminf(cap / fmaxf(tmag, 1e-9f), 1.f);
        lt1 *= sc;
        lt2 *= sc;
      } else {
        lt1 = fminf(fmaxf(lt1, -cap), cap);
        lt2 = fminf(fmaxf(lt2, -cap), cap);
      }
      const int rows[3] = {i, c + i, 2 * c + i};
      const float vals[3] = {ln, lt1, lt2};
      for (int q = 0; q < 3; ++q) {
        const float v = finite_or_zero(vals[q] * act[rows[q]]);
        const float dl = v - lam[rows[q]];
        lam_next[rows[q]] = v;
        part += dl * dl;
      }
    }
    for (int k = r3 + tid; k < r; k += nt) {
      const float v = finite_or_zero(fmaxf(y[k], 0.f) * act[k]);
      const float dl = v - lam[k];
      lam_next[k] = v;
      part += dl * dl;
    }
    const float dn = block_sum(part, red);    // barrier: lam_next complete
    if (it > 0 && dn > prev_dn * 1.02f) {
      scale *= 0.5f;
      ++halvings;
    }
    prev_dn = dn;
    float* t = lam;
    lam = lam_next;
    lam_next = t;
  }

  // dqd = MJ^T lambda_c + Minv[:, ld] (lambda_lo - lambda_hi)
  for (int f = tid; f < d; f += nt) {
    float s = 0.f;
    for (int k = 0; k < r3; ++k) s += MJ[k * d + f] * lam[k];
    if (nl) {
      float sl = 0.f;
      for (int l = 0; l < nl; ++l)
        sl += Minv[f * d + ld[l]] * (lam[r3 + l] - lam[r3 + nl + l]);
      s += sl;
    }
    gdqd[e * d + f] = s;
  }
  for (int k = tid; k < r; k += nt) glam[e * r + k] = lam[k];
  if (tid == 0) ghalv[env] = halvings;
}

}  // namespace

extern "C" int pgs_smem_bytes(int c, int nl, int d) {
  const int r3 = 3 * c, r = r3 + 2 * nl;
  return (int)((2 * r3 * d + d * d + 2 * d + 8 * r + c + 33) * sizeof(float)
               + nl * sizeof(int));
}

extern "C" int pgs_solve_fused_f32(const float* J, const float* Minv,
                                   const float* qd, const float* b,
                                   const float* act, const float* mu,
                                   const float* lam0, const int* ld,
                                   float* lam, float* dqd, int* halvings,
                                   int W, int c, int nl, int d, int iters,
                                   float omega, int use_cone,
                                   float diag_scale, float reg,
                                   void* stream) {
  if (W <= 0) return 0;
  if (c < 0 || nl < 0 || d < 1 || 3 * c + 2 * nl < 1)
    return (int)cudaErrorInvalidValue;
  const Dims D{c, nl, d, 3 * c, 3 * c + 2 * nl};
  const int smem = pgs_smem_bytes(c, nl, d);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pgs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = D.r <= 128 ? 128 : 256;
  const int spectral_iters = D.r < 192 ? 3 : 8;
  pgs_kernel<<<W, threads, smem, (cudaStream_t)stream>>>(
      J, Minv, qd, b, act, mu, lam0, ld, lam, dqd, halvings, D, iters,
      spectral_iters, omega, use_cone, diag_scale, reg);
  return (int)cudaGetLastError();
}
