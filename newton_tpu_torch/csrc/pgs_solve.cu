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
// Two-sided contacts (a contact between two articulations or worlds, solved
// in both cells) pass w_other (W, 3c, block order), the point inverse mass
// of the body on the contact's other side along each row: it adds to the
// row's diagonal before the softening, diag = (rowsum(J * MJ) + w) *
// diag_scale + reg, and to every Delassus product as a diagonal term,
// y = J tmp + w x. One load per contact row and one multiply-add per matvec.
// It is a kernel parameter of its own, and the register path has an
// instance of each width with and one without it (kTwoSided), so that a
// null w_other runs the instructions it ran before the operand existed
// (an Args struct past 128 bytes, or the operand's live values, made the
// one-sided reg<24> spill); the shared-memory path branches on the pointer.
// A zero w_other gives the same bits as a null one.
//
// A non-symmetric Minv (the implicit integrator's inverse of M + dt (Kd +
// D + dbias/dqd)) takes minv_t = 1: the block then stages Minv^T, so MJ =
// J Minv^T and MJ^T lambda = Minv J^T lambda, the reference's Delassus
// operator and dqd, and the stage also writes the limit columns Minv[:,
// ld] from the untransposed source (where registers are free), in place
// of limit_rows. The register path has an instance of its own for it
// (kMinvT: the one-sided reg<24> spilled 4 bytes when the flag was read
// at run time; its instances may hold 72 registers, 7 blocks per SM, as
// at 64 the two-sided reg<24> spilled 8 bytes), the shared-memory path
// reads it as a launch argument.
// With minv_t = 0 (every symmetric Minv) the kernels run the instructions
// they ran before the form existed.
//
// What bounds it on an H100: neither bytes nor FLOPs. At the humanoid's
// main-path shape (c, nl, d) = (32, 17, 23), r = 130, W = 4096, a call
// must move 13,344 B per env (16.3 us at 3.35 TB/s) and do ~221k FLOPs per
// env (13.5 us at the 67 TFLOP/s float32 peak): the MJ assembly (50.8k
// FMAs) and 11 Delassus matvecs (3 spectral + 8 sweeps, ~4.8k FMAs each).
// Each matvec is two dependent phases (the d-vector tmp = MJ^T x, then the
// rows y = J tmp), and every sweep ends in a block-wide norm that the
// divergence guard needs before the next sweep may start: short dependent
// steps behind block barriers. What the card spends is the instructions
// and shared-memory reads of those steps, issued from too few warps to
// hide their latency; the design cuts both and keeps 8 blocks on an SM.
//
// Design:
//   - Both matvec phases keep every lane busy. Phase 1: lanes over dofs,
//     the warp split into 32 / pow2(d) groups (two at d <= 16), each group
//     on a block of consecutive rows of MJ extended by the nl limit columns
//     Minv[:, ld]^T (zero-padded to equal blocks, x read four at a time);
//     the partials are summed per dof after one barrier. Phase 2: one quad
//     of lanes per contact, lanes 0-2 its normal and tangent rows, lane 3
//     its limit pair; the quad exchanges n, t1, t2 by shuffles and projects
//     in registers.
//   - The register path (the ant's d = 14 and the humanoid's 23: rows of 16
//     or 24 floats, c, nl <= 32): each lane keeps its J row and its rows'
//     lambda, diag, v_free, b and act in registers for the whole solve and
//     builds its MJ row from them; a limit lane's row is the one-hot e_ld,
//     so that every lane runs the same phase-2 instructions. Every other
//     shape takes the shared-memory path, where the row state lives in
//     shared memory and quads make as many passes as the shape needs.
//   - J and MJ keep contact-interleaved rows (3 i + {n, t1, t2}), padded to
//     a multiple of 4 floats; staging is asynchronous (cp.async), so a
//     block has all of its loads in flight at once.
//   - Norms: a warp-shuffle sum, one slot per warp in a double-buffered
//     shared array, then every thread sums the slots in the same order
//     (all agree on the guard). Three barriers per sweep: partials, tmp,
//     norm.
//   - Divisions and square roots are correctly rounded without the
//     library's slow-path call (exact_math.cuh), which would make the
//     register path spill; scale / diag is divided once, and halving the
//     step halves it exactly.
//   - Occupancy: 128 threads under __launch_bounds__(128, 8) (64
//     registers, no spills) for r <= 160, 8 blocks of <= 27 KB on an SM;
//     4096 envs are ~3.9 waves (the non-symmetric instances: 7 blocks). Above 160 rows (the uncompacted humanoid,
//     r = 610, ~133 KB: one block per SM) 256 threads, with the large-
//     shared-memory opt-in above 48 KB.
//   - A shape whose block would need more than the 227 KB of shared memory
//     an H100 block can hold runs the same shared-memory-path sweep with
//     the same layout in a per-env slice of a global scratch buffer that
//     the caller allocates (pgs_scratch_floats); at these sizes the slices
//     a wave touches sit in L2. It is simple, not fast: no shape of the
//     port's robots reaches it.
// Tensor cores are not used: the float32 parity the port holds forbids
// TF32, and the work is a few microseconds at the float32 peak.

#include <cuda_runtime.h>

#include "exact_math.cuh"

namespace {

using ntt::copy_async;
using ntt::div_rn;
using ntt::rcp_rn;
using ntt::sqrt_rn;

constexpr int kMaxSmem = 227 * 1024;

struct Dims {
  int c, nl, d, r3, r, rows;  // rows = r3 + nl: phase-1 rows (limits last)
  int s;      // row stride of J, MJ, Minv (and length of tmp, qd): d to 4
  int dp, G;  // phase-1 lanes per row (a power of 2 <= 32), rows per warp
  int P, R;   // phase-1 row blocks (warps x G) and rows per block (4k)
};

int threads_for(int r) { return r <= 160 ? 128 : 256; }

Dims make_dims(int c, int nl, int d) {
  Dims D;
  D.c = c, D.nl = nl, D.d = d, D.r3 = 3 * c, D.r = 3 * c + 2 * nl;
  D.rows = D.r3 + nl;
  D.s = (d + 3) & ~3;
  D.dp = 1;
  while (D.dp < d && D.dp < 32) D.dp *= 2;
  D.G = 32 / D.dp;
  D.P = threads_for(D.r) / 32 * D.G;
  D.R = (((D.rows + D.P - 1) / D.P) + 3) & ~3;
  return D;
}

// The register path: 128 threads, one pass of quads (c, nl <= 32), rows of
// 16 or 24 floats; every other shape takes the shared-memory path.
int reg_width(const Dims& D) {
  return D.c <= 32 && D.nl <= 32 && (D.s == 16 || D.s == 24) ? D.s : 0;
}

// floats before the int ld array: the float4-read arrays first (tmp, qd,
// xs, J, MJ, Minv), then the phase-1 partials, the row state of the
// shared-memory path, mu, and the norm slots
size_t smem_floats(const Dims& D) {
  const int nw = threads_for(D.r) / 32;
  size_t n = 2 * (size_t)D.s + (size_t)D.P * D.R
             + (size_t)(D.r3 + D.P * D.R + D.s) * D.s + (size_t)D.P * D.d
             + 2 * nw;
  if (!reg_width(D)) n += 6 * (size_t)D.r + D.c;
  return n;
}

// Keeps the compiler from hoisting the shared-memory reads of later steps
// of an unrolled loop above this point: hoisted all at once they take more
// registers than a thread has, and spill.
__device__ __forceinline__ void fence() { asm volatile("" ::: "memory"); }

// A limit pair's lo - hi, D^-1/2 (x - y) (lo and hi share one diagonal):
// an exact zero when x == y (both rows active), as in the plain version.
// Written as a x - a y, nvcc fuses it into an FMA that keeps the first
// product's rounding error, and the power iteration's start vector no
// longer cancels.
__device__ __forceinline__ float scaled_diff(float a, float x, float y) {
  return __fmul_rn(a, __fsub_rn(x, y));
}

__device__ __forceinline__ float finite_or_zero(float v) {
  return isfinite(v) ? v : 0.f;
}

// sum_f a[f] b[f] over s4 float4 chunks, in f order
__device__ __forceinline__ float dot4(const float* a, const float* b,
                                      int s4) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float y = 0.f;
  for (int q = 0; q < s4; ++q) {
    const float4 u = a4[q], v = b4[q];
    y += u.x * v.x;
    y += u.y * v.y;
    y += u.z * v.z;
    y += u.w * v.w;
  }
  return y;
}

// Sum over the block; every thread returns the same value. red holds two
// slots of NW floats, used in turn (buf flips), so one barrier suffices.
template <int NW>
__device__ __forceinline__ float block_sum(float v, float* red, int& buf) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  float* slot = red + buf * NW;
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) s += slot[w];
  buf ^= 1;
  return s;
}

// tmp = MJx^T xs over the rows of MJx = [MJ; Minv[:, ld]^T]: xs holds x of
// each interleaved contact row and lo - hi of each limit pair. Block p of
// R consecutive rows goes to group p of lanes (lanes over dofs), its x
// read four at a time; rows past r3 + nl up to P R are zero in both.
// Returns with tmp complete for every thread (two barriers).
// SS, GG: the row stride and lane groups when known at compile time (the
// register path), else 0 and read from D.
template <int NT, int SS = 0, int GG = 0>
__device__ __forceinline__ void phase1(const Dims& D, const float* MJx,
                                       const float* xs, float* part,
                                       float* tmp) {
  const int s = SS ? SS : D.s, G = GG ? GG : D.G, dp = 32 / G;
  const int P = NT / 32 * G;
  const int lane = threadIdx.x & 31, g = lane / dp;
  const int p = (threadIdx.x >> 5) * G + g;
  const int k0 = p * D.R, k1 = k0 + D.R;
  const float4* x4 = reinterpret_cast<const float4*>(xs);
  for (int f = lane - g * dp; f < D.d; f += 32) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 2
    for (int k = k0; k < k1; k += 4) {
      const float4 x = x4[k >> 2];
      const float* m = MJx + k * s + f;
      s0 += m[0] * x.x;
      s1 += m[s] * x.y;
      s0 += m[2 * s] * x.z;
      s1 += m[3 * s] * x.w;
    }
    part[p * D.d + f] = s0 + s1;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < s; f += NT) {
    float sum = 0.f;
    if (f < D.d)
      for (int q = 0; q < P; ++q) sum += part[q * D.d + f];
    tmp[f] = sum;
  }
  __syncthreads();
}

// Stage J (block-order row b c + i to interleaved row 3 i + b), Minv (with
// minv_t its transpose, and then the limit rows of MJ, Minv[:, ld]^T) and
// qd with row stride s, zero-padded, ld, and zero the padding rows of MJ
// and xs; asynchronous copies into shared memory, plain ones into global
// scratch (kGlobal). Ends with a barrier.
template <int NT, bool kGlobal = false>
__device__ __forceinline__ void stage(const Dims& D, size_t e,
                                      const float* __restrict__ gJ,
                                      const float* __restrict__ gMinv,
                                      const float* __restrict__ gqd,
                                      const int* __restrict__ gld, float* qd,
                                      float* xs, float* J, float* MJ,
                                      float* Minv, int* ld, int minv_t) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = D.c, d = D.d, s = D.s;
  const float* Je = gJ + e * 3 * c * d;
  const float* Me = gMinv + e * d * d;
  for (int b = 0; b < 3; ++b)
    for (int i = w; i < c; i += NW)
      for (int f = lane; f < s; f += 32) {
        float* dst = J + (3 * i + b) * s + f;
        if (f < d) {
          if constexpr (kGlobal) *dst = Je[(b * c + i) * d + f];
          else copy_async(dst, Je + (b * c + i) * d + f);
        } else {
          *dst = 0.f;
        }
      }
  for (int q = w; q < s; q += NW)
    for (int f = lane; f < s; f += 32) {
      if (q < d && f < d) {
        const int src = minv_t ? f * d + q : q * d + f;
        if constexpr (kGlobal) Minv[q * s + f] = Me[src];
        else copy_async(Minv + q * s + f, Me + src);
      } else {
        Minv[q * s + f] = 0.f;
      }
    }
  if (minv_t)
    for (int l = w; l < D.nl; l += NW)
      for (int f = lane; f < s; f += 32)
        MJ[(D.r3 + l) * s + f] = f < d ? Me[f * d + gld[l]] : 0.f;
  for (int f = threadIdx.x; f < s; f += NT)
    qd[f] = f < d ? gqd[e * d + f] : 0.f;
  for (int g = threadIdx.x; g < D.nl; g += NT) ld[g] = gld[g];
  const int pad = D.P * D.R - D.rows;
  for (int g = threadIdx.x; g < pad * s; g += NT) MJ[D.rows * s + g] = 0.f;
  for (int g = threadIdx.x; g < pad; g += NT) xs[D.rows + g] = 0.f;
  ntt::copy_async_wait();
  __syncthreads();
}

// Minv[:, ld]^T as the limit rows of MJx, zero-padded (before a barrier)
template <int NT>
__device__ __forceinline__ void limit_rows(const Dims& D, const float* Minv,
                                           const int* ld, float* MJx) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, s = D.s;
  for (int l = threadIdx.x >> 5; l < D.nl; l += NW)
    for (int f = lane; f < s; f += 32)
      MJx[(D.r3 + l) * s + f] = f < D.d ? Minv[f * s + ld[l]] : 0.f;
}

struct Args {
  const float *J, *Minv, *qd, *b, *act, *mu, *lam0;
  const int* ld;
  float *lam, *dqd;
  int* halvings;
  int iters, spectral_iters, use_cone;
  float omega, diag_scale, reg;
  float* scratch;         // the global-scratch instance: env e's block
  size_t scratch_floats;  // state starts at scratch + e * scratch_floats
};

// w_other of the register path's contact lane: block-order row q c + i of
// env blockIdx.x, from the block and thread indices at each use
__device__ __forceinline__ float w_own(const float* w, int r3, int c) {
  return w[(size_t)blockIdx.x * r3 + (threadIdx.x & 3) * c
           + (threadIdx.x >> 2)];
}

// The register path: quad lane q < 3 of quad i owns interleaved contact
// row 3 i + q, lane 3 the limit pair i; each keeps its J row (S floats)
// and its rows' lambda, diag, v_free, b and act in registers for the whole
// solve, and builds its MJ row from them.
template <int S, bool kTwoSided, bool kMinvT>
__global__ void __launch_bounds__(128, kMinvT ? 7 : 8)
pgs_kernel_reg(Dims D, Args A, const float* __restrict__ w_other,
               int /* minv_t: this path's is kMinvT */) {
  // lane groups of phase 1: d in (S - 4, S], so 32 / pow2(d) is known
  constexpr int NT = 128, NW = 4, S4 = S / 4, G = S <= 16 ? 2 : 1;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x;
  const int c = D.c, nl = D.nl, d = D.d, r3 = D.r3, r = D.r;
  float* tmp = sm;                             // S, zero beyond d
  float* qd = tmp + S;                         // S, zero beyond d
  float* xs = qd + S;                          // P R: phase-1 inputs
  float* J = xs + D.P * D.R;                   // r3 x S, interleaved rows
  float* MJ = J + r3 * S;                      // P R x S
  float* Minv = MJ + D.P * D.R * S;            // S x S, zero-padded
  float* part = Minv + S * S;                  // P x d
  float* red = part + D.P * d;                 // 2 x NW
  int* ld = reinterpret_cast<int*>(red + 2 * NW);
  const size_t e = blockIdx.x;
  stage<NT>(D, e, A.J, A.Minv, A.qd, A.ld, qd, xs, J, MJ, Minv, ld, kMinvT);

  const int q = tid & 3, i = tid >> 2, base = (tid & 31) & ~3;
  const bool contact = q < 3 && i < c, limit = q == 3 && i < nl;
  const int k = 3 * i + q;                     // interleaved contact row
  // lo and hi of a limit pair share diag, and their v_free are +-qd[dof]
  float jr[S], dg = 1.f, vf = 0.f;

  // 1. MJ row = J row Minv, diag and v_free (contact lanes); the limit
  //    columns Minv[:, ld]^T and the limit rows' diag and v_free. A limit
  //    lane's "row" is the one-hot e_ld, so that J tmp gives it tmp[ld]
  //    and every lane runs the same instructions in phase 2
  const int dof = limit ? ld[i] : -1;
  // the other body's point inverse mass on the lane's contact row: added
  // to its diagonal here and, in each matvec below, times the lane's own x
  // (xs[xi], not yet overwritten there); read where it is used, so that it
  // holds no register across the sweeps
  const bool two_sided = kTwoSided && contact;
#pragma unroll
  for (int f = 0; f < S; ++f)
    jr[f] = contact ? J[k * S + f] : (f == dof ? 1.f : 0.f);
  if (contact) {
    const float4* m4 = reinterpret_cast<const float4*>(Minv);
    float4* mj4 = reinterpret_cast<float4*>(MJ + k * S);
    float dsum = 0.f, vsum = 0.f;
#pragma unroll
    for (int f4 = 0; f4 < S4; ++f4) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int qq = 0; qq < S; ++qq) {
        const float4 m = m4[qq * S4 + f4];
        acc[0] += jr[qq] * m.x;
        acc[1] += jr[qq] * m.y;
        acc[2] += jr[qq] * m.z;
        acc[3] += jr[qq] * m.w;
        if ((qq & 7) == 7) fence();
      }
      mj4[f4] = make_float4(acc[0], acc[1], acc[2], acc[3]);
#pragma unroll
      for (int t = 0; t < 4; ++t) dsum += jr[4 * f4 + t] * acc[t];
    }
#pragma unroll
    for (int f4 = 0; f4 < S4; ++f4) {
      const float4 qv = reinterpret_cast<const float4*>(qd)[f4];
      vsum += jr[4 * f4] * qv.x;
      vsum += jr[4 * f4 + 1] * qv.y;
      vsum += jr[4 * f4 + 2] * qv.z;
      vsum += jr[4 * f4 + 3] * qv.w;
    }
    if constexpr (kTwoSided) dsum += w_own(w_other, r3, c);
    dg = dsum * A.diag_scale + A.reg;
    vf = vsum;
  } else if (limit) {
    dg = Minv[dof * S + dof] * A.diag_scale + A.reg;
    vf = qd[dof];
  }
  if constexpr (!kMinvT) limit_rows<NT>(D, Minv, ld, MJ);
  float lm[2] = {0.f, 0.f}, bb[2] = {0.f, 0.f}, aa[2] = {0.f, 0.f}, mu = 0.f;
  if (contact || limit) {
    // block-order rows: the contact row, or the limit pair lo / hi
    const size_t row0 = e * r + (contact ? q * c + i : r3 + i);
    const size_t row1 = e * r + r3 + nl + i;
    bb[0] = A.b[row0], aa[0] = A.act[row0], lm[0] = A.lam0[row0];
    if (limit) bb[1] = A.b[row1], aa[1] = A.act[row1], lm[1] = A.lam0[row1];
    if (contact) mu = A.mu[e * c + i];
  }

  // phase 2 of a lane: y = its row of J times tmp (two partial sums)
  auto row_dot = [&]() {
    const float4* t4 = reinterpret_cast<const float4*>(tmp);
    float y = 0.f, y2 = 0.f;
#pragma unroll
    for (int f4 = 0; f4 < S4; ++f4) {
      const float4 t = t4[f4];
      y += jr[4 * f4] * t.x;
      y2 += jr[4 * f4 + 1] * t.y;
      y += jr[4 * f4 + 2] * t.z;
      y2 += jr[4 * f4 + 3] * t.w;
    }
    return y + y2;
  };
  // the lane's xs entry: its contact row, or lo - hi of its limit pair (a
  // contact lane's second row is an exact zero)
  const bool owner = contact || limit;
  const int xi = contact ? k : r3 + i;

  // 2. power-iteration bound on lambda_max(D^-1/2 A D^-1/2) from u = act /
  //    max(|act|, 1); xs holds D^-1/2 u (limit pairs: lo - hi)
  int buf = 0;
  const float n0 = fmaxf(
      sqrt_rn(block_sum<NW>(aa[0] * aa[0] + aa[1] * aa[1], red, buf)), 1.f);
  const float rn0 = rcp_rn(n0);
  const float rs = rsqrtf(dg);
  if (owner)
    xs[xi] = scaled_diff(rs, div_rn(aa[0], n0, rn0), div_rn(aa[1], n0, rn0));
  __syncthreads();
  float lam_max = 0.f;
  for (int it = 0; it < A.spectral_iters; ++it) {
    phase1<NT, S, G>(D, MJ, xs, part, tmp);
    float y = row_dot();
    if constexpr (kTwoSided)
      if (two_sided) y += w_own(w_other, r3, c) * xs[xi];
    const float v0 = rs * y * aa[0], v1 = rs * (-y) * aa[1];
    const float nrm = sqrt_rn(block_sum<NW>(v0 * v0 + v1 * v1, red, buf));
    lam_max = nrm;
    // the next step's x = D^-1/2 u, u = v / max(nrm, 1e-9); after the
    // last step the first sweep's x = lam0
    const float nc = fmaxf(nrm, 1e-9f), rnc = rcp_rn(nc);
    if (owner)
      xs[xi] = it + 1 == A.spectral_iters
                   ? lm[0] - lm[1]
                   : scaled_diff(rs, div_rn(v0, nc, rnc),
                                 div_rn(v1, nc, rnc));
    __syncthreads();
  }
  const float bound = fmaxf(1.1f * lam_max, 1e-9f);
  const float scale = A.omega * fminf(1.f, div_rn(1.8f, bound));
  // scale / diag of the lane's rows; halving the step halves it exactly
  float sd = div_rn(scale, dg);

  // 3-4. projected Jacobi sweeps with the divergence guard; phase 2 writes
  //      the next phase 1's xs (the new lambda). Row 0 of a lane is its
  //      contact row or limit lo, row 1 its limit hi (zero state elsewhere)
  float prev_dn = 0.f;
  int halvings = 0;
  const bool friction = contact && q > 0;
  for (int it = 0; it < A.iters; ++it) {
    phase1<NT, S, G>(D, MJ, xs, part, tmp);
    float y = row_dot();
    if constexpr (kTwoSided)
      if (two_sided) y += w_own(w_other, r3, c) * lm[0];
    const float y0 = lm[0] - sd * ((y + vf) - bb[0]);
    // the quad's normal and tangents, exchanged in registers
    const float yn = __shfl_sync(0xffffffffu, y0, base);
    const float y1 = __shfl_sync(0xffffffffu, y0, base + 1);
    const float y2 = __shfl_sync(0xffffffffu, y0, base + 2);
    const float cap = mu * fmaxf(yn, 0.f);
    float fr;
    if (A.use_cone) {
      const float tmag = fmaxf(sqrt_rn(y1 * y1 + y2 * y2), 1e-9f);
      fr = y0 * fminf(div_rn(cap, tmag), 1.f);
    } else {
      fr = fminf(fmaxf(y0, -cap), cap);
    }
    const float v0 = finite_or_zero((friction ? fr : fmaxf(y0, 0.f)) * aa[0]);
    const float yh = lm[1] - sd * ((-y + -vf) - bb[1]);
    const float v1 = finite_or_zero(fmaxf(yh, 0.f) * aa[1]);
    const float dl0 = v0 - lm[0], dl1 = v1 - lm[1];
    lm[0] = v0;
    lm[1] = v1;
    if (owner) xs[xi] = v0 - v1;
    const float dn = block_sum<NW>(dl0 * dl0 + dl1 * dl1, red, buf);
    if (it > 0 && dn > prev_dn * 1.02f) {
      sd *= 0.5f;
      ++halvings;
    }
    prev_dn = dn;
  }

  // dqd = MJ^T lambda_c + Minv[:, ld] (lambda_lo - lambda_hi); the
  // output rows recomputed from a fresh thread index
  phase1<NT, S, G>(D, MJ, xs, part, tmp);
  const int t2 = ntt::fresh_tid(), b2 = ntt::fresh_bid();
  const int q2 = t2 & 3, i2 = t2 >> 2;
  float* lam_e = A.lam + (size_t)b2 * r;
  for (int f = t2; f < d; f += NT) A.dqd[(size_t)b2 * d + f] = tmp[f];
  if (q2 < 3 && i2 < c) lam_e[q2 * c + i2] = lm[0];
  if (q2 == 3 && i2 < nl) {
    lam_e[r3 + i2] = lm[0];
    lam_e[r3 + nl + i2] = lm[1];
  }
  if (t2 == 0) A.halvings[b2] = halvings;
}

// The shared-memory path, for any shape: the row state lives in shared
// memory (interleaved contact rows, limits last), or with kGlobal in the
// env's slice of the global scratch, and quads make as many passes as the
// contacts or limit pairs need.
template <int NT, bool kGlobal = false>
__global__ void __launch_bounds__(NT, NT == 128 && !kGlobal ? 4 : 1)
pgs_kernel_smem(Dims D, Args A, const float* __restrict__ w_other,
                int minv_t) {
  constexpr int NW = NT / 32, NQ = NT / 4;
  extern __shared__ float4 sm4[];
  float* sm = kGlobal ? A.scratch + blockIdx.x * A.scratch_floats
                      : reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x;
  const int c = D.c, nl = D.nl, d = D.d, r3 = D.r3, r = D.r, s = D.s;
  const int s4 = s / 4, rows = D.rows;
  float* tmp = sm;                             // s, zero beyond d
  float* qd = tmp + s;                         // s, zero beyond d
  float* xs = qd + s;                          // P R: phase-1 inputs
  float* J = xs + D.P * D.R;                   // r3 x s, interleaved rows
  float* MJ = J + r3 * s;                      // P R x s
  float* Minv = MJ + D.P * D.R * s;            // s x s, zero-padded
  float* part = Minv + s * s;                  // P x d
  float* diag = part + D.P * d;                // row state: contact rows
  float* vfree = diag + r;                     // interleaved, limits last
  float* b = vfree + r;
  float* act = b + r;
  float* lam = act + r;
  float* lamn = lam + r;
  float* mu = lamn + r;
  float* red = mu + c;                         // 2 x NW
  int* ld = reinterpret_cast<int*>(red + 2 * NW);
  const size_t e = blockIdx.x;
  for (int k = tid; k < r; k += NT) {
    // block-order row k: contact row bc c + i is interleaved row 3 i + bc
    const int bc = k < c ? 0 : k < 2 * c ? 1 : 2;
    const int kk = k < r3 ? 3 * (k - bc * c) + bc : k;
    b[kk] = A.b[e * r + k];
    act[kk] = A.act[e * r + k];
    lam[kk] = A.lam0[e * r + k];
  }
  for (int g = tid; g < c; g += NT) mu[g] = A.mu[e * c + g];
  stage<NT, kGlobal>(D, e, A.J, A.Minv, A.qd, A.ld, qd, xs, J, MJ, Minv,
                     ld, minv_t);

  // 1. Delassus pieces: MJ = J Minv (groups of lanes over dofs, one row
  //    each), the limit columns Minv[:, ld]^T, diag and v_free
  {
    const int lane = tid & 31, g = lane / D.dp;
    for (int k = (tid >> 5) * D.G + g; k < r3; k += D.P)
      for (int f = lane - g * D.dp; f < s; f += 32) {
        const float4* j4 = reinterpret_cast<const float4*>(J + k * s);
        float acc = 0.f;
        for (int q = 0; q < s4; ++q) {
          const float4 jv = j4[q];
          const float* m = Minv + 4 * q * s + f;
          acc += jv.x * m[0];
          acc += jv.y * m[s];
          acc += jv.z * m[2 * s];
          acc += jv.w * m[3 * s];
        }
        MJ[k * s + f] = acc;
      }
    if (!minv_t) limit_rows<NT>(D, Minv, ld, MJ);
  }
  __syncthreads();
  // the other body's point inverse mass of interleaved contact row k
  // (block-order row (k % 3) c + k / 3), read from global memory
  const float* wo_e = w_other ? w_other + e * r3 : nullptr;
  auto w_of = [&](int k) { return wo_e[(k % 3) * c + k / 3]; };
  for (int k = tid; k < r3; k += NT) {
    const float dot = dot4(J + k * s, MJ + k * s, s4);
    diag[k] = (wo_e ? dot + w_of(k) : dot) * A.diag_scale + A.reg;
    vfree[k] = dot4(J + k * s, qd, s4);
  }
  for (int l = tid; l < nl; l += NT) {
    const int q = ld[l];
    const float dl = Minv[q * s + q] * A.diag_scale + A.reg;
    diag[r3 + l] = dl;
    diag[r3 + nl + l] = dl;
    vfree[r3 + l] = qd[q];
    vfree[r3 + nl + l] = -qd[q];
  }

  // phase 2 mapping: quad i (pass p) is contact i = p NQ + tid / 4, lane
  // q = tid & 3 its row 3 i + q (q < 3) or limit pair l = i (q = 3)
  const int q = tid & 3, quad = tid >> 2;
  const int base = (tid & 31) & ~3;
  const int passes = (max(c, nl) + NQ - 1) / NQ;

  // 2. power-iteration bound on lambda_max(D^-1/2 A D^-1/2) from u = act /
  //    max(|act|, 1); xs holds D^-1/2 u (limit pairs: lo - hi)
  int buf = 0;
  float acc0 = 0.f;
  for (int k = tid; k < r; k += NT) acc0 += act[k] * act[k];
  const float n0 = fmaxf(sqrt_rn(block_sum<NW>(acc0, red, buf)), 1.f);
  const float rn0 = rcp_rn(n0);
  for (int k = tid; k < rows; k += NT) {
    const float x = div_rn(act[k], n0, rn0);
    xs[k] = k < r3 ? rsqrtf(diag[k]) * x
                   : scaled_diff(rsqrtf(diag[k]), x,
                                 div_rn(act[k + nl], n0, rn0));
  }
  __syncthreads();
  float lam_max = 0.f;
  for (int it = 0; it < A.spectral_iters; ++it) {
    phase1<NT>(D, MJ, xs, part, tmp);
    float acc = 0.f;
    for (int p = 0; p < passes; ++p) {
      const int i = p * NQ + quad;
      if (q < 3 && i < c) {
        const int k = 3 * i + q;
        float y = dot4(J + k * s, tmp, s4);
        if (wo_e) y += w_of(k) * xs[k];
        const float v = rsqrtf(diag[k]) * y * act[k];
        lamn[k] = v;
        acc += v * v;
      } else if (q == 3 && i < nl) {
        const float t = tmp[ld[i]];
        const int lo = r3 + i, hi = r3 + nl + i;
        const float vlo = rsqrtf(diag[lo]) * t * act[lo];
        const float vhi = rsqrtf(diag[hi]) * (-t) * act[hi];
        lamn[lo] = vlo;
        lamn[hi] = vhi;
        acc += vlo * vlo + vhi * vhi;
      }
    }
    const float nrm = sqrt_rn(block_sum<NW>(acc, red, buf));
    lam_max = nrm;
    // the next step's x = D^-1/2 u, u = lamn / max(nrm, 1e-9); after the
    // last step the first sweep's x = lam0
    const float nc = fmaxf(nrm, 1e-9f), rnc = rcp_rn(nc);
    const bool last = it + 1 == A.spectral_iters;
    for (int k = tid; k < rows; k += NT) {
      if (last) {
        xs[k] = k < r3 ? lam[k] : lam[k] - lam[k + nl];
      } else {
        const float x = div_rn(lamn[k], nc, rnc);
        xs[k] = k < r3 ? rsqrtf(diag[k]) * x
                       : scaled_diff(rsqrtf(diag[k]), x,
                                     div_rn(lamn[k + nl], nc, rnc));
      }
    }
    __syncthreads();
  }
  float scale =
      A.omega * fminf(1.f, div_rn(1.8f, fmaxf(1.1f * lam_max, 1e-9f)));

  // 3-4. projected Jacobi sweeps with the divergence guard; phase 2 also
  //      writes the next phase 1's xs (the new lambda)
  float prev_dn = 0.f;
  int halvings = 0;
  for (int it = 0; it < A.iters; ++it) {
    phase1<NT>(D, MJ, xs, part, tmp);
    float acc = 0.f;
    for (int p = 0; p < passes; ++p) {
      const int i = p * NQ + quad;
      const bool contact = q < 3 && i < c;
      const int k = 3 * i + q;
      float yf = 0.f;
      if (contact) {
        float y = dot4(J + k * s, tmp, s4);
        if (wo_e) y += w_of(k) * lam[k];
        yf = lam[k] - div_rn(scale, diag[k]) * ((y + vfree[k]) - b[k]);
      }
      // the quad's normal and tangents, exchanged in registers
      const float yn = __shfl_sync(0xffffffffu, yf, base);
      const float y1 = __shfl_sync(0xffffffffu, yf, base + 1);
      const float y2 = __shfl_sync(0xffffffffu, yf, base + 2);
      if (contact) {
        const float ln = fmaxf(yn, 0.f);
        float val = ln;
        if (q > 0) {
          const float cap = mu[i] * ln;
          if (A.use_cone) {
            const float tmag = fmaxf(sqrt_rn(y1 * y1 + y2 * y2), 1e-9f);
            val = yf * fminf(div_rn(cap, tmag), 1.f);
          } else {
            val = fminf(fmaxf(yf, -cap), cap);
          }
        }
        const float v = finite_or_zero(val * act[k]);
        const float dl = v - lam[k];
        lamn[k] = v;
        xs[k] = v;
        acc += dl * dl;
      } else if (q == 3 && i < nl) {
        const float t = tmp[ld[i]];
        float v2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = r3 + h * nl + i;
          const float yl =
              lam[kk] - div_rn(scale, diag[kk])
                            * (((h ? -t : t) + vfree[kk]) - b[kk]);
          v2[h] = finite_or_zero(fmaxf(yl, 0.f) * act[kk]);
          const float dl = v2[h] - lam[kk];
          lamn[kk] = v2[h];
          acc += dl * dl;
        }
        xs[r3 + i] = v2[0] - v2[1];
      }
    }
    const float dn = block_sum<NW>(acc, red, buf);   // lamn, xs complete
    if (it > 0 && dn > prev_dn * 1.02f) {
      scale *= 0.5f;
      ++halvings;
    }
    prev_dn = dn;
    float* t = lam;
    lam = lamn;
    lamn = t;
  }

  // dqd = MJ^T lambda_c + Minv[:, ld] (lambda_lo - lambda_hi)
  phase1<NT>(D, MJ, xs, part, tmp);
  for (int f = tid; f < d; f += NT) A.dqd[e * d + f] = tmp[f];
  for (int k = tid; k < r; k += NT) {
    const int bc = k < c ? 0 : k < 2 * c ? 1 : 2;
    A.lam[e * r + k] = lam[k < r3 ? 3 * (k - bc * c) + bc : k];
  }
  if (tid == 0) A.halvings[blockIdx.x] = halvings;
}

// Instance codes, mirrored by pgs.kernel_instance: the register path's
// row width (16, 24), the shared-memory path's threads (128, 256), or
// 1000 + threads for the global-scratch instance.
int instance(const Dims& D) {
  const int threads = threads_for(D.r);
  if (smem_floats(D) * sizeof(float) + D.nl * sizeof(int) > kMaxSmem)
    return 1000 + threads;
  const int w = reg_width(D);
  return w ? w : threads;
}

// Floats of one env's block in the global scratch (16-byte aligned).
size_t scratch_floats(const Dims& D) {
  return (smem_floats(D) + D.nl + 3) & ~(size_t)3;
}

// The kernel of an instance, its threads and dynamic shared memory, with
// the carveout and large-shared-memory opt-in it needs.
using Kernel = void (*)(Dims, Args, const float*, int);

cudaError_t prepare(const Dims& D, bool two_sided, bool minv_t, Kernel* k,
                    int* threads, int* smem) {
  const int inst = instance(D);
  *threads = threads_for(D.r);
  *smem = inst > 1000 ? 0
                      : (int)(smem_floats(D) * sizeof(float)
                              + D.nl * sizeof(int));
  switch (inst) {
    case 16:
      *k = two_sided ? (minv_t ? pgs_kernel_reg<16, true, true>
                               : pgs_kernel_reg<16, true, false>)
                     : (minv_t ? pgs_kernel_reg<16, false, true>
                               : pgs_kernel_reg<16, false, false>);
      break;
    case 24:
      *k = two_sided ? (minv_t ? pgs_kernel_reg<24, true, true>
                               : pgs_kernel_reg<24, true, false>)
                     : (minv_t ? pgs_kernel_reg<24, false, true>
                               : pgs_kernel_reg<24, false, false>);
      break;
    case 128: *k = pgs_kernel_smem<128>; break;
    case 256: *k = pgs_kernel_smem<256>; break;
    case 1128: *k = pgs_kernel_smem<128, true>; break;
    default: *k = pgs_kernel_smem<256, true>; break;
  }
  // the most shared memory per SM, so that 8 blocks fit; above 48 KB per
  // block the large-shared-memory opt-in
  cudaError_t e = cudaFuncSetAttribute(
      *k, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && *smem > 48 * 1024)
    e = cudaFuncSetAttribute(*k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem);
  return e;
}

bool valid(int c, int nl, int d) {
  return c >= 0 && nl >= 0 && d >= 1 && 3 * c + 2 * nl >= 1;
}

}  // namespace

extern "C" int pgs_smem_bytes(int c, int nl, int d) {
  const Dims D = make_dims(c, nl, d);
  return (int)(smem_floats(D) * sizeof(float) + nl * sizeof(int));
}

// Which instance pgs_solve_fused_f32 runs at (c, nl, d) (see instance()).
extern "C" int pgs_kernel_instance(int c, int nl, int d) {
  return valid(c, nl, d) ? instance(make_dims(c, nl, d)) : -1;
}

// Floats of global scratch per env that pgs_solve_fused_f32 needs at
// (c, nl, d) (0: the instance keeps its state on chip).
extern "C" long long pgs_scratch_floats(int c, int nl, int d) {
  if (!valid(c, nl, d)) return 0;
  const Dims D = make_dims(c, nl, d);
  return instance(D) > 1000 ? (long long)scratch_floats(D) : 0;
}

extern "C" int pgs_solve_fused_f32(const float* J, const float* Minv,
                                   const float* qd, const float* b,
                                   const float* act, const float* mu,
                                   const float* lam0, const int* ld,
                                   const float* w_other, float* lam,
                                   float* dqd, int* halvings,
                                   int W, int c, int nl, int d, int iters,
                                   float omega, int use_cone,
                                   float diag_scale, float reg,
                                   float* scratch, int minv_t,
                                   void* stream) {
  if (W <= 0) return 0;
  if (!valid(c, nl, d)) return (int)cudaErrorInvalidValue;
  const Dims D = make_dims(c, nl, d);
  if (instance(D) > 1000 && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  Kernel k;
  int threads = 0, smem = 0;
  const cudaError_t e = prepare(D, w_other != nullptr, minv_t != 0, &k,
                                &threads, &smem);
  if (e != cudaSuccess) return (int)e;
  const Args A{J, Minv, qd, b, act, mu, lam0, ld, lam, dqd, halvings,
               iters, D.r < 192 ? 3 : 8, use_cone, omega, diag_scale, reg,
               scratch, scratch_floats(D)};
  k<<<W, threads, smem, (cudaStream_t)stream>>>(D, A, w_other, minv_t);
  return (int)cudaGetLastError();
}

// Registers per thread and resident blocks per SM of the launch that
// pgs_solve_fused_f32 makes at (c, nl, d) without w_other.
extern "C" int pgs_kernel_info(int c, int nl, int d, int* regs,
                               int* blocks_per_sm) {
  if (!valid(c, nl, d)) return (int)cudaErrorInvalidValue;
  Kernel k;
  int threads = 0, smem = 0;
  cudaError_t e = prepare(make_dims(c, nl, d), false, false, &k, &threads,
                          &smem);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, threads, smem);
}
