// Backward of the fused Delassus assembly + projected-Jacobi solve (K4),
// one block per env.
//
// The TPU kernel newton_tpu/solvers/generalized/pgs_pallas.py ::
// pgs_solve_pallas_fused has no backward of its own: jax.grad reaches its
// call site only on the XLA branch (batched.py: the assembly, then
// pgs_core) and differentiates that. This kernel is the backward of the
// port's B2 launch (csrc/pgs_solve.cu): the vector-Jacobian product of
// what B2 computed, formed as autograd of the plain version
// (solvers/generalized/pgs.py: pgs_solve_fused_plain) forms it, and
// written as the gradients of J, Minv, qd, b, mu, lam0 and w_other from
// the cotangents of lam and dqd.
//
// It reads the forward that B2 saved (pgs_save.cuh; the
// wrapper launches B2's kSave instance where an input requires grad):
// every power iteration's Delassus product, d-vector and norm, every
// sweep's d-vector, residual, pre-projection and new lambda and guard
// flag. So it differentiates the iterates and guard halvings the card
// took, and does not run the forward again. Per env:
//   1. MJx = [J M; Minv[:, ld]^T] (M = Minv, or Minv^T for a
//      non-symmetric Minv), the diagonal and its rsqrt, recomputed; J
//      extended by the limit rows' one-hots (Jx).
//   2. The adjoint of dqd = MJx^T [lambda_c; lambda_lo - lambda_hi].
//   3. The sweeps, last first: through the act mask and the isfinite
//      guard, the box or cone projection (cap = mu ln gives mu and the
//      normal rows their share), lambda - (scale / diag) res (scale, diag,
//      v_free, b), then the Delassus product's adjoint: the d-vector
//      g_tmp = Jx^T g_y, then g_x = MJx g_tmp (and w_other's diagonal).
//   4. The step min(1, 1.8 / max(1.1 lambda_max, 1e-9)) and the power
//      iterations, last first (they get gradient only where the step is
//      below 1), each with the same product adjoint.
//   5. The assembly: g_MJx and g_J as sums over the products' slots of
//      outer products (x_s g_tmp_s^T and g_y_s tmp_s^T), formed once at
//      the end; g_J += g_MJ M^T, g_Minv = J^T g_MJ plus the limit columns
//      and diagonals; g_qd, g_b, g_mu, g_lam0, g_w.
// Ties follow the plain version's autograd (torch.maximum / minimum: half
// the gradient to each side where they are equal); where the plain
// version's gradient is NaN (the cone's sqrt at a zero tangent) so is this
// one, because each local derivative is formed as PyTorch forms it.
//
// What bounds it on an H100: neither bytes nor FLOPs. At the ant's (c,
// nl, d) = (25, 8, 14), r = 91, W = 4096, a call moves ~23 KB an env with
// the saved forward (~28 us at 3.35 TB/s) and does ~0.2 MFLOP an env;
// what the card spends is the 11 adjoint products' short dependent phases
// behind block barriers, as in B2, and its occupancy. The first design
// ran the forward again in the plain version's order, kept every
// iterate and accumulated the rank-1 updates of g_J and g_MJ phase by
// phase, and took 250 registers a thread: 2 blocks of 128 threads on an
// SM. This design:
//   - reads the saved forward instead of redoing it (half the phases);
//   - lays rows out as B2 does: a quad of lanes per contact, lanes 0-2
//     its normal and tangent rows, lane 3 its limit pair, in every row
//     phase (projection, step, product rows); the quad exchanges the
//     contact's values by shuffles for the projection's adjoint, and a
//     row's accumulators (g_lambda, g_diag, g_v_free, g_isd, g_u) stay
//     with its lane, so they need no barrier;
//   - splits the d-vector g_tmp = Jx^T g_y over groups of lanes, each on a
//     block of consecutive rows, then sums the partials per dof (B2's
//     phase 1), so every lane works where the old loop kept 14 of 128;
//   - keeps each product's x, g_y, tmp and g_tmp (one slot each) and forms
//     g_J and g_MJx once at the end: three barriers a sweep;
//   - stages B2's saved forward into shared memory with the inputs
//     (cp.async, all of a thread's copies in flight at once), so no row
//     phase waits on device memory;
//   - forms the assembly's products four outputs a thread (one load of A
//     feeds four sums); takes 1 / diag as isd^2 and each power
//     iteration's divisors' reciprocals once (a division is a slow
//     sequence here, and kept in the row phases it showed in K4's time);
//   - holds no array in registers and no spill (__launch_bounds__ with 7
//     blocks of 128 threads: at most 72 registers; 2 of 256, the rows
//     above 160, whose workspace allows no more blocks anyway: at most
//     128, where 3 blocks' 80 spilled 40 bytes; chip_smoke.py's phase 58
//     prints each instance's ptxas lines), and stages each sweep's lambda
//     where the product reads it, so that 7 blocks of the ant's shape (30
//     KB of shared memory) fit on an SM.
// What still bounds it (K4 at 0, 8 and 16 sweeps, scripts/torch_k1_k4.py;
// PERF.md has the figures): the products' short barrier phases and the
// once-a-block phases (staging, the power iterations, the assembly's
// dependent sums), far above its bytes.
// The env's workspace is dynamic shared memory where it fits in the 227
// KB of a block, else a per-env slice of a global scratch that the caller
// allocates (pgs_backward_scratch_floats); the same code addresses both.

#include <cuda_runtime.h>

#include "exact_math.cuh"
#include "pgs_save.cuh"

namespace {

using ntt::save_layout;
using Saved = ntt::SaveLayout;

constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ inline int threads_for(int r) {
  return r <= 160 ? 128 : 256;
}

__host__ __device__ inline int spectral_iters(int r) {
  return r < 192 ? 3 : 8;
}

// The groups of lanes of the g_tmp partials: dp lanes over dofs (a power
// of 2 <= 32), P groups in the block, each on R consecutive rows.
struct Split {
  int dp, P, R;
};

__host__ __device__ inline Split make_split(int rows, int d, int threads) {
  Split s;
  s.dp = 1;
  while (s.dp < d && s.dp < 32) s.dp *= 2;
  s.P = threads / 32 * (32 / s.dp);
  s.R = (rows + s.P - 1) / s.P;
  return s;
}

struct Layout {
  int Jx, MJx, Mi, diag, isd, GL, gdiag, gvf, gisd, GU, act, gw, mu, gmu,
      XS, GT, GY, part, red, ld, SV, sv_head, total;
};

__host__ __device__ inline int take(int* o, int n) {
  const int p = *o;
  *o += (n + 3) & ~3;
  return p;
}

// Product slots s: x (XS, r floats in block order, lo and hi apart) and
// g_tmp (GT): lambda_0 .. lambda_T (s <= T; g_tmp of sweep s, and of dqd
// at s = T), then the power iterations' z_k (s = T + 1 + k). g_y (GY,
// rows floats: contact rows, then lo - hi of each limit pair): the sweeps
// (t < T), the power iterations (T + k), then g_v_free's (T + K: g_qd is
// Jx^T of it, into GT[T + K + 1]). SV holds B2's saved forward but its
// lambdas (staged into XS): res and yf in a head of max(2 T r, rows d)
// floats that g_MJx takes over at the end, the rest (tmp, py, ptp, nrm,
// grow) after it.
__host__ __device__ inline Layout make_layout(int c, int nl, int d,
                                              int iters) {
  const int r3 = 3 * c, r = r3 + 2 * nl, rows = r3 + nl;
  const int K = spectral_iters(r), NY = iters + K, NS = NY + 1;
  const Split sp = make_split(rows, d, threads_for(r));
  const Saved S = save_layout(r, d, K, iters);
  Layout L;
  int o = 0;
  L.Jx = take(&o, rows * d);
  L.MJx = take(&o, rows * d);
  L.Mi = take(&o, d * d);
  L.diag = take(&o, r);
  L.isd = take(&o, r);
  L.GL = take(&o, r);
  L.gdiag = take(&o, r);
  L.gvf = take(&o, r);
  L.gisd = take(&o, r);
  L.GU = take(&o, r);
  L.act = take(&o, r);
  L.gw = take(&o, r3);
  L.mu = take(&o, c);
  L.gmu = take(&o, c);
  L.XS = take(&o, NS * r);
  L.GT = take(&o, (NS + 1) * d);
  L.GY = take(&o, (NY + 1) * rows);
  L.part = take(&o, sp.P * d);
  L.red = take(&o, 16);
  L.ld = take(&o, nl);
  const int head = S.tmp - S.res;
  L.sv_head = ((head > rows * d ? head : rows * d) + 3) & ~3;
  L.SV = take(&o, L.sv_head + S.total - S.tmp);
  L.total = o;
  return L;
}

bool fits_smem(const Layout& L) { return L.total * 4 <= kMaxSmem; }

struct Args {
  const float *J, *Minv, *qd, *b, *act, *mu, *lam0, *w, *glam, *gdqd, *save;
  const int* ld;
  float *gJ, *gMinv, *gqd, *gb, *gmu, *glam0, *gw, *scratch;
  int c, nl, d, iters, use_cone, minv_t;
  float omega, ds, reg;
};

// PyTorch's maximum / minimum backward: half to each side at a tie; a NaN
// operand passes the whole gradient to both
__device__ __forceinline__ float dmax_dx(float x, float y) {
  return x == y ? 0.5f : (x < y ? 0.f : 1.f);
}
__device__ __forceinline__ float dmax_dy(float x, float y) {
  return x == y ? 0.5f : (x > y ? 0.f : 1.f);
}
__device__ __forceinline__ float dmin_dx(float x, float y) {
  return x == y ? 0.5f : (x > y ? 0.f : 1.f);
}
__device__ __forceinline__ float dmin_dy(float x, float y) {
  return x == y ? 0.5f : (x < y ? 0.f : 1.f);
}
// torch.maximum / minimum: a NaN operand gives NaN
__device__ __forceinline__ float tmax(float x, float y) {
  return (x != x || y != y) ? x + y : (x > y ? x : y);
}
__device__ __forceinline__ float tmin(float x, float y) {
  return (x != x || y != y) ? x + y : (x < y ? x : y);
}

// Sum over the block; every thread returns the same value. Two slots of
// eight floats used in turn, so one barrier suffices.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red, int& buf) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  float* slot = red + 8 * buf;
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += slot[w];
  buf ^= 1;
  return s;
}

// n floats from global memory into the workspace: asynchronous copies
// into shared memory (all of a thread's in flight at once), plain ones
// into the global scratch
template <int NT>
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      bool global) {
  for (int i = threadIdx.x; i < n; i += NT) {
    if (global) dst[i] = src[i];
    else ntt::copy_async(dst + i, src + i);
  }
}

// The adjoint of lam_full = lam - (scale / diag) res for one row k given
// g(lam_full) glf: g(scale) into p, g(diag), g(v_free) (b's is its
// negation), g(y) returned; g(lam) = glf plus w_other's term (x the
// product's input on that row) into GL. 1 / diag is taken as isd^2: no
// division on the row phases' path (a division is a slow sequence here).
__device__ __forceinline__ float step_row(float* ws, const Layout& L, int k,
                                          float glf, float res, float sct,
                                          float x, const float* w, int r3,
                                          float& p) {
  const float idg = ws[L.isd + k] * ws[L.isd + k], gs = -glf * res;
  p += gs * idg;
  ws[L.gdiag + k] += -gs * sct * (idg * idg);
  const float gy = -glf * (sct * idg);
  ws[L.gvf + k] += gy;
  float gl = glf;
  if (w && k < r3) {
    ws[L.gw + k] += gy * x;
    gl += w[k] * gy;
  }
  ws[L.GL + k] = gl;
  return gy;
}

__device__ __forceinline__ float row_dot(const float* m, const float* v,
                                         int d) {
  float acc = 0.f;
  for (int k = 0; k < d; ++k) acc += m[k] * v[k];
  return acc;
}

// C(i, j) = sum_q A(i, q) B(q, j) for i < m, j < n (A(i, q) = A[i ai + q
// aq], B(q, j) = B[q bq + j bj]), four columns a thread so that each A
// value feeds four independent sums; out(i, j, C) takes each entry.
template <int NT, class F>
__device__ __forceinline__ void gemm4(int m, int n, int kk, const float* A,
                                      int ai, int aq, const float* B, int bq,
                                      int bj, F out) {
  const int nt = (n + 3) / 4;
  for (int t = threadIdx.x; t < m * nt; t += NT) {
    const int i = t / nt, j0 = (t - i * nt) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < kk; ++q) {
      const float av = A[i * ai + q * aq];
      const float* b = B + q * bq + j0 * bj;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + u < n) acc[u] += av * b[u * bj];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + u < n) out(i, j0 + u, acc[u]);
  }
}

template <int NT>
__global__ void __launch_bounds__(NT, NT == 128 ? 7 : 2)
pgs_backward_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int c = a.c, nl = a.nl, d = a.d, r3 = 3 * c, r = r3 + 2 * nl;
  const int rows = r3 + nl, T = a.iters, K = spectral_iters(r);
  const int NY = T + K, tid = threadIdx.x;
  const Layout L = make_layout(c, nl, d, T);
  const Saved S = save_layout(r, d, K, T);
  const size_t env = blockIdx.x;
  const bool global = a.scratch != nullptr;
  float* ws = global ? a.scratch + env * (size_t)L.total
                     : reinterpret_cast<float*>(smem4);
  float* red = ws + L.red;
  int* ld = reinterpret_cast<int*>(ws + L.ld);
  // the saved forward, staged: res, yf in the head, tmp onwards after it
  // (both indexed by the saved layout's offsets); its lambdas in XS
  const float* sv = ws + L.SV - S.res;
  const float* svt = ws + L.SV + L.sv_head - S.tmp;
  const float* w = a.w ? a.w + env * r3 : nullptr;
  int buf = 0;

  // ---- 1. stage and assemble
  {
    const float* g = a.save + env * (size_t)S.total;
    stage<NT>(ws + L.XS, a.lam0 + env * r, r, global);
    stage<NT>(ws + L.XS + r, g + S.lam, T * r, global);
    stage<NT>(ws + L.SV, g + S.res, S.tmp - S.res, global);
    stage<NT>(ws + L.SV + L.sv_head, g + S.tmp, S.total - S.tmp, global);
    stage<NT>(ws + L.Jx, a.J + env * r3 * d, r3 * d, global);
    stage<NT>(ws + L.Mi, a.Minv + env * d * d, d * d, global);
    stage<NT>(ws + L.act, a.act + env * r, r, global);
    stage<NT>(ws + L.mu, a.mu + env * c, c, global);
    for (int j = tid; j < nl; j += NT) ld[j] = a.ld[j];
    for (int i = tid; i < r; i += NT) {
      ws[L.GL + i] = a.glam ? a.glam[env * r + i] : 0.f;
      ws[L.gdiag + i] = ws[L.gvf + i] = ws[L.gisd + i] = ws[L.GU + i] = 0.f;
    }
    for (int i = tid; i < r3; i += NT) ws[L.gw + i] = 0.f;
    for (int i = tid; i < c; i += NT) ws[L.gmu + i] = 0.f;
    for (int k = tid; k < d; k += NT)
      ws[L.GT + T * d + k] = a.gdqd ? a.gdqd[env * d + k] : 0.f;
    if (!global) ntt::copy_async_wait();
    __syncthreads();
    float* Jx = ws + L.Jx;
    const float* Mi = ws + L.Mi;
    for (int i = tid; i < nl * d; i += NT) {
      const int l = i / d, k = i % d;
      Jx[(r3 + l) * d + k] = k == ld[l] ? 1.f : 0.f;
      ws[L.MJx + (r3 + l) * d + k] = Mi[k * d + ld[l]];
    }
    // MJ = J M, M = Minv (or Minv^T)
    float* MJx = ws + L.MJx;
    gemm4<NT>(r3, d, d, Jx, d, 1, Mi, a.minv_t ? 1 : d, a.minv_t ? d : 1,
              [&](int i, int j, float v) { MJx[i * d + j] = v; });
    __syncthreads();
    for (int row = tid; row < r; row += NT) {
      float dg;
      if (row < r3) {
        float s = row_dot(Jx + row * d, ws + L.MJx + row * d, d);
        if (w) s += w[row];
        dg = s * a.ds + a.reg;
      } else {
        const int l = ld[(row - r3) % nl];
        dg = Mi[l * d + l] * a.ds + a.reg;
      }
      ws[L.diag + row] = dg;
      ws[L.isd + row] = 1.f / sqrtf(dg);
    }
    __syncthreads();
  }

  // g_tmp = Jx^T g_y of slot s (g_y in GY[s]): partials over row blocks,
  // then the sum per dof into GT[so] (so = s unless given); two barriers,
  // then GT[so] is read
  auto gtmp = [&](int s, int so = -1) {
    const Split sp = make_split(rows, d, NT);
    const int lane = tid & 31, g = lane / sp.dp;
    const int p = (tid >> 5) * (32 / sp.dp) + g;
    const int k0 = p * sp.R, k1 = min(k0 + sp.R, rows);
    const float* gy = ws + L.GY + s * rows;
    if (so < 0) so = s;
    for (int f = lane - g * sp.dp; f < d; f += sp.dp) {
      float acc = 0.f;
      for (int k = k0; k < k1; ++k) acc += ws[L.Jx + k * d + f] * gy[k];
      ws[L.part + p * d + f] = acc;
    }
    __syncthreads();
    for (int f = tid; f < d; f += NT) {
      float acc = 0.f;
      for (int q = 0; q < sp.P; ++q) acc += ws[L.part + q * d + f];
      ws[L.GT + so * d + f] = acc;
    }
    __syncthreads();
  };
  // The row layout of every row phase (B2's phase 2): quad i of a pass
  // is contact i, lane q < 3 its row q c + i (n, t1, t2), lane 3 limit
  // pair i (rows r3 + i and r3 + nl + i); a row keeps its lane throughout
  const int q = tid & 3, quad = tid >> 2, base = (tid & 31) & ~3;
  const int passes = ((c > nl ? c : nl) + NT / 4 - 1) / (NT / 4);
  // g_x += MJx g_tmp of slot s into the rows at acc_at (a contact row's
  // own; a limit pair's +- its limit row's)
  auto adj_rows = [&](int s, int acc_at) {
    const float* gt = ws + L.GT + s * d;
    for (int pp = 0; pp < passes; ++pp) {
      const int i = pp * (NT / 4) + quad;
      if (q < 3 && i < c) {
        const int k = q * c + i;
        ws[acc_at + k] += row_dot(ws + L.MJx + k * d, gt, d);
      } else if (q == 3 && i < nl) {
        const float v = row_dot(ws + L.MJx + (r3 + i) * d, gt, d);
        ws[acc_at + r3 + i] += v;
        ws[acc_at + r3 + nl + i] -= v;
      }
    }
  };
  // lambda_t of a row (t = 0: lam0; else sweep t - 1's output)
  auto lam_at = [&](int t, int row) { return ws[L.XS + t * r + row]; };

  // ---- 2. dqd = MJx^T x_T
  adj_rows(T, L.GL);

  // ---- 3. the sweeps, last first
  const float lam_max = svt[S.nrm + K - 1];
  const float m_step = tmax(1.1f * lam_max, 1e-9f);
  const float v_step = 1.8f / m_step;
  float sct = a.omega * tmin(v_step, 1.f);
  for (int t = 0; t < T; ++t)
    if (svt[S.grow + t] != 0.f) sct *= 0.5f;
  float gS = 0.f;  // this thread's share of g(scale_0)
  for (int t = T - 1; t >= 0; --t) {
    const bool halved = svt[S.grow + t] != 0.f;
    if (halved) sct *= 2.f;  // the scale sweep t used
    const float* yf = sv + S.yf + t * r;
    const float* res = sv + S.res + t * r;
    float* gys = ws + L.GY + t * rows;
    float p = 0.f;
    for (int pp = 0; pp < passes; ++pp) {
      const int i = pp * (NT / 4) + quad;
      const bool contact = q < 3 && i < c;
      const int k = q * c + i;
      // the quad's normal and tangents (yf, act, g(lam)), by shuffles
      float f = 0.f, ac = 0.f, g = 0.f;
      if (contact) f = yf[k], ac = ws[L.act + k], g = ws[L.GL + k];
      const float lfn = __shfl_sync(0xffffffffu, f, base);
      const float l1 = __shfl_sync(0xffffffffu, f, base + 1);
      const float l2 = __shfl_sync(0xffffffffu, f, base + 2);
      const float an = __shfl_sync(0xffffffffu, ac, base);
      const float a1 = __shfl_sync(0xffffffffu, ac, base + 1);
      const float a2 = __shfl_sync(0xffffffffu, ac, base + 2);
      const float gn0 = __shfl_sync(0xffffffffu, g, base);
      const float g10 = __shfl_sync(0xffffffffu, g, base + 1);
      const float g20 = __shfl_sync(0xffffffffu, g, base + 2);
      if (contact) {
        const float m = ws[L.mu + i];
        const float ln = tmax(lfn, 0.f), cap = m * ln;
        float g1, g2, gc = 0.f, gl1, gl2;
        if (a.use_cone) {
          const float tmag = sqrtf(l1 * l1 + l2 * l2);
          const float den = tmax(tmag, 1e-9f), iden = 1.f / den;
          const float qq = cap * iden;
          const float sc = tmin(qq, 1.f);
          g1 = isfinite(l1 * sc * a1) ? g10 * a1 : 0.f;
          g2 = isfinite(l2 * sc * a2) ? g20 * a2 : 0.f;
          const float gsc = g1 * l1 + g2 * l2;
          gl1 = g1 * sc;
          gl2 = g2 * sc;
          const float gq = gsc * dmin_dx(qq, 1.f);
          gc += gq * iden;
          const float gden = -gq * cap * (iden * iden);
          const float gtm = gden * dmax_dx(tmag, 1e-9f);
          const float gsq = gtm / (2.f * tmag);
          gl1 += gsq * l1 + gsq * l1;
          gl2 += gsq * l2 + gsq * l2;
        } else {
          const float m1 = tmax(l1, -cap), m2 = tmax(l2, -cap);
          const float o1 = tmin(m1, cap), o2 = tmin(m2, cap);
          g1 = isfinite(o1 * a1) ? g10 * a1 : 0.f;
          g2 = isfinite(o2 * a2) ? g20 * a2 : 0.f;
          const float gm1 = g1 * dmin_dx(m1, cap), gm2 = g2 * dmin_dx(m2, cap);
          gc += g1 * dmin_dy(m1, cap) + g2 * dmin_dy(m2, cap);
          gl1 = gm1 * dmax_dx(l1, -cap);
          gl2 = gm2 * dmax_dx(l2, -cap);
          gc -= gm1 * dmax_dy(l1, -cap) + gm2 * dmax_dy(l2, -cap);
        }
        const float gn = isfinite(ln * an) ? gn0 * an : 0.f;
        if (q == 0) ws[L.gmu + i] += ln * gc;
        const float glf = q == 0 ? (gn + m * gc) * dmax_dx(lfn, 0.f)
                                 : (q == 1 ? gl1 : gl2);
        gys[k] = step_row(ws, L, k, glf, res[k], sct, lam_at(t, k), w, r3,
                          p);
      } else if (q == 3 && i < nl) {
        const int lo = r3 + i, hi = r3 + nl + i;
        const float flo = yf[lo], fhi = yf[hi];
        const float alo = ws[L.act + lo], ahi = ws[L.act + hi];
        const float glo = isfinite(tmax(flo, 0.f) * alo) ? ws[L.GL + lo] * alo
                                                        : 0.f;
        const float ghi = isfinite(tmax(fhi, 0.f) * ahi) ? ws[L.GL + hi] * ahi
                                                        : 0.f;
        const float xlo = lam_at(t, lo), xhi = lam_at(t, hi);
        const float ylo = step_row(ws, L, lo, glo * dmax_dx(flo, 0.f),
                                   res[lo], sct, xlo, w, r3, p);
        const float yhi = step_row(ws, L, hi, ghi * dmax_dx(fhi, 0.f),
                                   res[hi], sct, xhi, w, r3, p);
        gys[r3 + i] = ylo - yhi;
      }
    }
    gS = (halved ? 0.5f : 1.f) * gS + p;
    __syncthreads();
    gtmp(t);
    adj_rows(t, L.GL);
  }

  // ---- 4. the step bound and the power iterations, last first
  {
    const float gstep = a.omega * block_sum<NT>(gS, red, buf);
    const float gv = gstep * dmin_dx(v_step, 1.f);
    const float gm = -gv * 1.8f / (m_step * m_step);
    const float glmax = 1.1f * (gm * dmax_dx(1.1f * lam_max, 1e-9f));
    float p0 = 0.f;
    for (int i = tid; i < r; i += NT) p0 += ws[L.act + i] * ws[L.act + i];
    const float n0 = tmax(sqrtf(block_sum<NT>(p0, red, buf)), 1.f);
    // u_k of a row: act / n0, or the previous iterate normalized (the
    // divisor's reciprocal taken once an iteration)
    float inv_prev = 1.f / n0;
    auto u_at = [&](int k, int row) {
      const float ac = ws[L.act + row];
      if (k == 0) return ac * inv_prev;
      const float u2 = ws[L.isd + row] * svt[S.py + (k - 1) * r + row] * ac;
      return u2 * inv_prev;
    };
    for (int k = K - 1; k >= 0; --k) {
      const float nk = svt[S.nrm + k];
      const float* Ak = svt + S.py + k * r;
      float gnrm = k == K - 1 ? glmax : 0.f;
      const float den = tmax(nk, 1e-9f), iden = 1.f / den;
      inv_prev = k == 0 ? 1.f / n0 : 1.f / tmax(svt[S.nrm + k - 1], 1e-9f);
      if (k < K - 1) {
        // u_{k+1} = u2 / max(nrm, 1e-9)
        float p = 0.f;
        for (int i = tid; i < r; i += NT)
          p += ws[L.GU + i] * (ws[L.isd + i] * Ak[i] * ws[L.act + i]);
        gnrm += -block_sum<NT>(p, red, buf) * (iden * iden)
                * dmax_dx(nk, 1e-9f);
      }
      const float gn_over = nk == 0.f ? 0.f : gnrm / nk;
      // nrm = ||u2|| (zero gradient where nrm == 0), u2 = (isd a) act;
      // the product's x is z = isd u_k; GU takes g(z) so far
      auto row_a = [&](int i) {
        const float sd = ws[L.isd + i], ac = ws[L.act + i];
        const float u2 = sd * Ak[i] * ac;
        const float gx = k < K - 1 ? ws[L.GU + i] * iden : 0.f;
        const float gu2 = gx + u2 * gn_over;
        const float gia = gu2 * ac;
        const float gy = gia * sd;
        ws[L.gisd + i] += gia * Ak[i];
        const float z = sd * u_at(k, i);
        float g = 0.f;
        if (w && i < r3) {
          ws[L.gw + i] += gy * z;
          g = w[i] * gy;
        }
        ws[L.GU + i] = g;
        return make_float2(gy, z);
      };
      float* xs = ws + L.XS + (T + 1 + k) * r;
      float* gys = ws + L.GY + (T + k) * rows;
      for (int pp = 0; pp < passes; ++pp) {
        const int i = pp * (NT / 4) + quad;
        if (q < 3 && i < c) {
          const float2 v = row_a(q * c + i);
          gys[q * c + i] = v.x;
          xs[q * c + i] = v.y;
        } else if (q == 3 && i < nl) {
          const float2 lo = row_a(r3 + i), hi = row_a(r3 + nl + i);
          gys[r3 + i] = lo.x - hi.x;
          xs[r3 + i] = lo.y;
          xs[r3 + nl + i] = hi.y;
        }
      }
      __syncthreads();
      gtmp(T + k, T + 1 + k);
      adj_rows(T + 1 + k, L.GU);
      // z = isd u_k: g(isd) and g(u_k) (GU), on the rows' own lanes
      auto row_u = [&](int i) {
        const float gz = ws[L.GU + i];
        ws[L.gisd + i] += gz * u_at(k, i);
        ws[L.GU + i] = gz * ws[L.isd + i];
      };
      for (int pp = 0; pp < passes; ++pp) {
        const int i = pp * (NT / 4) + quad;
        if (q < 3 && i < c) {
          row_u(q * c + i);
        } else if (q == 3 && i < nl) {
          row_u(r3 + i);
          row_u(r3 + nl + i);
        }
      }
      __syncthreads();
    }
    // isd = rsqrt(diag)
    for (int i = tid; i < r; i += NT) {
      const float s = ws[L.isd + i];
      ws[L.gdiag + i] += -0.5f * ws[L.gisd + i] * (s * s * s);
    }
    __syncthreads();
  }

  // ---- 5. the assembly; g_MJx takes over the staged lam, res and yf
  const float* Jx = ws + L.Jx;
  const float* MJx = ws + L.MJx;
  const float* Mi = ws + L.Mi;
  float* gMJx = ws + L.SV;
  {
    // g_qd = Jx^T [gvf_c; gvf_lo - gvf_hi], through GY[NY] and GT[NY + 1]
    float* gy = ws + L.GY + NY * rows;
    __syncthreads();
    for (int i = tid; i < r3; i += NT) gy[i] = ws[L.gvf + i];
    for (int l = tid; l < nl; l += NT)
      gy[r3 + l] = ws[L.gvf + r3 + l] - ws[L.gvf + r3 + nl + l];
    __syncthreads();
    gtmp(NY, NY + 1);
    for (int k = tid; k < d; k += NT)
      a.gqd[env * d + k] = ws[L.GT + (NY + 1) * d + k];
  }
  // g_MJx = sum over the slots of x g_tmp^T (+ gdiag ds J on contact rows;
  // a limit row's x is lo - hi)
  gemm4<NT>(r3, d, NY + 1, ws + L.XS, 1, r, ws + L.GT, d, 1,
            [&](int i, int j, float v) {
              gMJx[i * d + j] = v + ws[L.gdiag + i] * a.ds * Jx[i * d + j];
            });
  for (int i = tid; i < nl * d; i += NT) {
    const int l = i / d, k = i - l * d;
    float v = 0.f;
    for (int q2 = 0; q2 <= NY; ++q2)
      v += (ws[L.XS + q2 * r + r3 + l] - ws[L.XS + q2 * r + r3 + nl + l])
           * ws[L.GT + q2 * d + k];
    gMJx[(r3 + l) * d + k] = v;
  }
  __syncthreads();
  // MJ = J M: gJ = sum over the slots of g_y tmp^T (each sweep's tmp, then
  // each power iteration's) + gdiag ds MJ + gvf qd + gMJ M^T
  {
    const int nt = (d + 3) / 4;
    for (int t = tid; t < r3 * nt; t += NT) {
      const int row = t / nt, j0 = (t - row * nt) * 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      auto add = [&](float av, const float* b, int bj) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j0 + u < d) acc[u] += av * b[(j0 + u) * bj];
      };
      for (int q = 0; q < T; ++q)
        add(ws[L.GY + q * rows + row], svt + S.tmp + q * d, 1);
      for (int q = 0; q < K; ++q)
        add(ws[L.GY + (T + q) * rows + row], svt + S.ptp + q * d, 1);
      for (int k = 0; k < d; ++k)
        add(gMJx[row * d + k], a.minv_t ? Mi + k * d : Mi + k,
            a.minv_t ? 1 : d);
      const float gd = ws[L.gdiag + row] * a.ds, gv = ws[L.gvf + row];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = j0 + u;
        if (e < d)
          a.gJ[env * r3 * d + row * d + e] =
              acc[u] + gd * MJx[row * d + e] + gv * a.qd[env * d + e];
      }
    }
  }
  // gMinv = J^T gMJ (its transpose for minv_t), the limit rows' columns
  // Minv[:, ld] and the limit diagonals
  auto put_minv = [&](int e, int k, float v) {
    for (int l = 0; l < nl; ++l)
      if (ld[l] == k) {
        v += gMJx[(r3 + l) * d + e];
        if (e == k)
          v += (ws[L.gdiag + r3 + l] + ws[L.gdiag + r3 + nl + l]) * a.ds;
      }
    a.gMinv[env * d * d + e * d + k] = v;
  };
  gemm4<NT>(d, d, r3, a.minv_t ? gMJx : Jx, 1, d, a.minv_t ? Jx : gMJx, d,
            1, put_minv);
  for (int row = tid; row < r; row += NT) {
    a.gb[env * r + row] = -ws[L.gvf + row];
    a.glam0[env * r + row] = ws[L.GL + row];
  }
  for (int j = tid; j < c; j += NT) a.gmu[env * c + j] = ws[L.gmu + j];
  if (a.gw)
    for (int row = tid; row < r3; row += NT)
      a.gw[env * r3 + row] = ws[L.gw + row] + ws[L.gdiag + row] * a.ds;
}

bool valid(int c, int nl, int d, int iters) {
  return c >= 0 && nl >= 0 && d >= 1 && iters >= 0 && 3 * c + 2 * nl >= 1;
}

using Kernel = void (*)(const Args);

Kernel kernel_for(int r) {
  return threads_for(r) == 128 ? pgs_backward_kernel<128>
                               : pgs_backward_kernel<256>;
}

}  // namespace

// Which instance K4 runs: 0 the workspace in shared memory, 1 in a global
// scratch; -1 for a shape with no system.
extern "C" int pgs_backward_instance(int c, int nl, int d, int iters) {
  if (!valid(c, nl, d, iters)) return -1;
  return fits_smem(make_layout(c, nl, d, iters)) ? 0 : 1;
}

// Floats of one env's workspace (the global scratch holds W of them).
extern "C" long long pgs_backward_scratch_floats(int c, int nl, int d,
                                                 int iters) {
  return valid(c, nl, d, iters) ? make_layout(c, nl, d, iters).total : 0;
}

// lam, dqd cotangents glam (W, r) and gdqd (W, d), either may be null;
// w_other and gw together or neither; save: the W x pgs_save_floats
// floats of B2's saved forward; scratch null for the shared-memory
// instance, W * pgs_backward_scratch_floats floats for the global one.
extern "C" int pgs_solve_backward_f32(
    const float* J, const float* Minv, const float* qd, const float* b,
    const float* act, const float* mu, const float* lam0, const int* ld,
    const float* w_other, const float* glam, const float* gdqd,
    const float* save, float* gJ, float* gMinv, float* gqd, float* gb,
    float* gmu, float* glam0, float* gw, int W, int c, int nl, int d,
    int iters, float omega, int use_cone, float diag_scale, float reg,
    float* scratch, int minv_t, void* stream) {
  if (W <= 0) return 0;
  if (!valid(c, nl, d, iters) || (w_other == nullptr) != (gw == nullptr) ||
      save == nullptr)
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(c, nl, d, iters);
  const bool smem = fits_smem(L);
  if (!smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem ? (size_t)L.total * 4 : 0;
  const int r = 3 * c + 2 * nl;
  const Kernel k = kernel_for(r);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && bytes > 48 * 1024)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.J = J, a.Minv = Minv, a.qd = qd, a.b = b, a.act = act, a.mu = mu;
  a.lam0 = lam0, a.w = w_other, a.glam = glam, a.gdqd = gdqd, a.ld = ld;
  a.save = save;
  a.gJ = gJ, a.gMinv = gMinv, a.gqd = gqd, a.gb = gb, a.gmu = gmu;
  a.glam0 = glam0, a.gw = gw, a.scratch = smem ? nullptr : scratch;
  a.c = c, a.nl = nl, a.d = d, a.iters = iters, a.use_cone = use_cone;
  a.minv_t = minv_t, a.omega = omega, a.ds = diag_scale, a.reg = reg;
  k<<<W, threads_for(r), bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Registers per thread and resident blocks per SM of K4's launch at
// (c, nl, d, iters).
extern "C" int pgs_backward_kernel_info(int c, int nl, int d, int iters,
                                        int* regs, int* blocks_per_sm) {
  if (!valid(c, nl, d, iters)) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(c, nl, d, iters);
  const size_t bytes = fits_smem(L) ? (size_t)L.total * 4 : 0;
  const int r = 3 * c + 2 * nl;
  const Kernel k = kernel_for(r);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && bytes > 48 * 1024)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, threads_for(r), bytes);
}
