// Backward of the fused Delassus assembly + projected-Jacobi solve (K4),
// one block per env.
//
// The TPU kernel newton_tpu/solvers/generalized/pgs_pallas.py ::
// pgs_solve_pallas_fused has no backward of its own: jax.grad reaches its
// call site only on the XLA branch (batched.py: the assembly, then
// pgs_core) and differentiates that. This kernel is the backward of the
// port's B2 launch (csrc/pgs_solve.cu): it computes what autograd of the
// plain version (solvers/generalized/pgs.py: pgs_solve_fused_plain)
// computes, from the same inputs, and writes the gradients of J, Minv, qd,
// b, mu, lam0 and w_other from the cotangents of lam and dqd.
//
// Per env:
//   1. The forward again, in the plain version's order: MJ = J Minv (J
//      Minv^T for a non-symmetric Minv), diag, v_free, the power
//      iterations of the step bound and the `iters` Jacobi sweeps with the
//      divergence guard. Every sweep's lambda, residual and d-vector
//      MJ^T lambda, every step scale and guard flag, and every power
//      iterate are kept.
//   2. The adjoint sweep from the last iteration back to the first:
//      through the act mask and the isfinite guard, the box or cone
//      projection (cap = mu ln gives mu and the normal rows their share),
//      the Jacobi update lam - (scale / diag) res, the guard's halvings
//      (x 0.5 or x 1; the flags themselves carry no gradient), then the
//      step min(1, 1.8 / max(1.1 lambda_max, 1e-9)) and the power
//      iterations, which get gradient only where the step is below 1.
//   3. Back through the assembly to J, Minv, qd, b, mu, lam0 and w_other.
// Ties follow the plain version's autograd (torch.maximum / minimum: half
// the gradient to each side where they are equal); where the plain
// version's gradient is NaN (the cone's sqrt at a zero tangent) so is this
// one, because each local derivative is formed as PyTorch forms it.
//
// What bounds it on an H100: neither bytes nor FLOPs (the sweep's short
// dependent steps behind block barriers, as in B2). At the ant's (c, nl,
// d) = (25, 8, 14), r = 91, W = 4096, a call moves 12.5 KB an env (15 us at
// 3.35 TB/s) and does ~0.25 MFLOP an env (15 us at the float32 peak).
//
// Design: simple first. One block per env, 128 threads (256 above 160
// rows); loops over rows, dofs or matrix entries with the block's stride,
// each entry owned by one thread within a phase, barriers between phases.
// The env's whole state (the inputs it reuses, the kept forward, the
// gradient accumulators) lives in one workspace: dynamic shared memory
// where it fits in the 227 KB of a block, else a per-env slice of a
// global scratch that the caller allocates (pgs_backward_scratch_floats).
// The same code addresses both.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ inline int threads_for(int r) {
  return r <= 160 ? 128 : 256;
}

__host__ __device__ inline int spectral_iters(int r) {
  return r < 192 ? 3 : 8;
}

struct Layout {
  long long J, MJ, gJ, gMJ, Mi, gMi, diag, isd, vf, gdiag, gvf, gb, gisd,
      gmu, gw, U, A, TP, NR, LAM, RES, TS, SC, GR, Z, GL, GY, GX, GU, GT,
      total;
};

__host__ __device__ inline long long take(long long* o, long long n) {
  const long long p = *o;
  *o += (n + 3) & ~3LL;
  return p;
}

__host__ __device__ inline Layout make_layout(int c, int nl, int d,
                                              int iters) {
  const long long r3 = 3LL * c, r = r3 + 2LL * nl, K = spectral_iters(r);
  Layout L;
  long long o = 0;
  L.J = take(&o, r3 * d);
  L.MJ = take(&o, r3 * d);
  L.gJ = take(&o, r3 * d);
  L.gMJ = take(&o, r3 * d);
  L.Mi = take(&o, (long long)d * d);
  L.gMi = take(&o, (long long)d * d);
  L.diag = take(&o, r);
  L.isd = take(&o, r);
  L.vf = take(&o, r);
  L.gdiag = take(&o, r);
  L.gvf = take(&o, r);
  L.gb = take(&o, r);
  L.gisd = take(&o, r);
  L.gmu = take(&o, c);
  L.gw = take(&o, r3);
  L.U = take(&o, (K + 1) * r);
  L.A = take(&o, K * r);
  L.TP = take(&o, K * d);
  L.NR = take(&o, K);
  L.LAM = take(&o, (iters + 1LL) * r);
  L.RES = take(&o, (long long)iters * r);
  L.TS = take(&o, (long long)iters * d);
  L.SC = take(&o, iters + 1LL);
  L.GR = take(&o, iters);
  L.Z = take(&o, r);
  L.GL = take(&o, r);
  L.GY = take(&o, r);
  L.GX = take(&o, r);
  L.GU = take(&o, r);
  L.GT = take(&o, d);
  L.total = o;
  return L;
}

bool fits_smem(const Layout& L) { return L.total * 4 <= kMaxSmem; }

struct Args {
  const float *J, *Minv, *qd, *b, *act, *mu, *lam0, *w, *glam, *gdqd;
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
__device__ __forceinline__ float block_sum(float v, float (*red)[8],
                                           int& buf) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[buf][threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  const int nw = blockDim.x >> 5;
  for (int w = 0; w < nw; ++w) s += red[buf][w];
  buf ^= 1;
  return s;
}

__global__ void __launch_bounds__(256) pgs_backward_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  __shared__ float red[2][8];
  int buf = 0;
  const int c = a.c, nl = a.nl, d = a.d, r3 = 3 * c, r = r3 + 2 * nl;
  const int n3d = r3 * d, iters = a.iters, K = spectral_iters(r);
  const int tid = threadIdx.x, T = blockDim.x;
  const Layout L = make_layout(c, nl, d, iters);
  const size_t env = blockIdx.x;
  float* ws = a.scratch ? a.scratch + env * (size_t)L.total
                        : reinterpret_cast<float*>(smem4);

  const float* J = a.J + env * n3d;
  const float* Minv = a.Minv + env * d * d;
  const float* qd = a.qd + env * d;
  const float* b = a.b + env * r;
  const float* act = a.act + env * r;
  const float* mu = a.mu + env * c;
  const float* lam0 = a.lam0 + env * r;
  const float* w = a.w ? a.w + env * r3 : nullptr;
  const int* ld = a.ld;

  float *sJ = ws + L.J, *MJ = ws + L.MJ, *gJ = ws + L.gJ, *gMJ = ws + L.gMJ;
  float *Mi = ws + L.Mi, *gMi = ws + L.gMi, *diag = ws + L.diag;
  float *isd = ws + L.isd, *vf = ws + L.vf, *gdiag = ws + L.gdiag;
  float *gvf = ws + L.gvf, *gb = ws + L.gb, *gisd = ws + L.gisd;
  float *gmu = ws + L.gmu, *gw = ws + L.gw, *U = ws + L.U, *A = ws + L.A;
  float *TP = ws + L.TP, *NR = ws + L.NR, *LAM = ws + L.LAM;
  float *RES = ws + L.RES, *TS = ws + L.TS, *SC = ws + L.SC, *GR = ws + L.GR;
  float *Z = ws + L.Z, *GL = ws + L.GL, *GY = ws + L.GY, *GX = ws + L.GX;
  float *GU = ws + L.GU, *GT = ws + L.GT;

  // ---- stage the inputs, zero the accumulators
  for (int i = tid; i < n3d; i += T) {
    sJ[i] = J[i];
    gJ[i] = 0.f;
    gMJ[i] = 0.f;
  }
  for (int i = tid; i < d * d; i += T) {
    Mi[i] = Minv[i];
    gMi[i] = 0.f;
  }
  for (int i = tid; i < r; i += T) {
    gdiag[i] = gvf[i] = gb[i] = gisd[i] = 0.f;
    GL[i] = a.glam ? a.glam[env * r + i] : 0.f;
  }
  for (int i = tid; i < r3; i += T) gw[i] = 0.f;
  for (int i = tid; i < c; i += T) gmu[i] = 0.f;
  for (int k = tid; k < d; k += T) GT[k] = a.gdqd ? a.gdqd[env * d + k] : 0.f;
  __syncthreads();

  // ---- assembly: MJ = J Minv (J Minv^T), diag, v_free
  for (int i = tid; i < n3d; i += T) {
    const int row = i / d, k = i % d;
    float s = 0.f;
    for (int e = 0; e < d; ++e)
      s += sJ[row * d + e] * (a.minv_t ? Mi[k * d + e] : Mi[e * d + k]);
    MJ[i] = s;
  }
  __syncthreads();
  for (int row = tid; row < r; row += T) {
    float dg, v;
    if (row < r3) {
      float s = 0.f;
      v = 0.f;
      for (int k = 0; k < d; ++k) {
        s += sJ[row * d + k] * MJ[row * d + k];
        v += sJ[row * d + k] * qd[k];
      }
      if (w) s += w[row];
      dg = s * a.ds + a.reg;
    } else {
      const int j = (row - r3) % nl, l = ld[j];
      dg = Mi[l * d + l] * a.ds + a.reg;
      v = row < r3 + nl ? qd[l] : -qd[l];
    }
    diag[row] = dg;
    isd[row] = 1.f / sqrtf(dg);
    vf[row] = v;
  }
  __syncthreads();

  // y = A x: tmp = MJ^T x_c + Minv[:, ld] (x_lo - x_hi), y_c = J tmp + w x,
  // y_lo = tmp[ld], y_hi = -tmp[ld]
  auto avec = [&](const float* x, float* tmp, float* y) {
    for (int k = tid; k < d; k += T) {
      float s = 0.f;
      for (int row = 0; row < r3; ++row) s += MJ[row * d + k] * x[row];
      for (int j = 0; j < nl; ++j)
        s += Mi[k * d + ld[j]] * (x[r3 + j] - x[r3 + nl + j]);
      tmp[k] = s;
    }
    __syncthreads();
    for (int row = tid; row < r; row += T) {
      float s;
      if (row < r3) {
        s = 0.f;
        for (int k = 0; k < d; ++k) s += sJ[row * d + k] * tmp[k];
        if (w) s += w[row] * x[row];
      } else {
        const int j = (row - r3) % nl;
        s = row < r3 + nl ? tmp[ld[j]] : -tmp[ld[j]];
      }
      y[row] = s;
    }
    __syncthreads();
  };
  // adjoint of tmp(x) for the cotangent gtmp: into gMJ, gMi and gx
  auto adj_tmp = [&](const float* x, const float* gtmp, float* gx) {
    for (int i = tid; i < n3d; i += T) gMJ[i] += x[i / d] * gtmp[i % d];
    for (int row = tid; row < r3; row += T) {
      float s = 0.f;
      for (int k = 0; k < d; ++k) s += MJ[row * d + k] * gtmp[k];
      gx[row] += s;
    }
    for (int j = tid; j < nl; j += T) {
      float s = 0.f;
      for (int k = 0; k < d; ++k) s += Mi[k * d + ld[j]] * gtmp[k];
      gx[r3 + j] += s;
      gx[r3 + nl + j] -= s;
    }
    for (int k = tid; k < d; k += T)
      for (int j = 0; j < nl; ++j)
        gMi[k * d + ld[j]] += gtmp[k] * (x[r3 + j] - x[r3 + nl + j]);
    __syncthreads();
  };
  // adjoint of y = A x for the cotangent gy, given tmp(x): into gJ, gw,
  // gMJ, gMi and gx (GT is the d-vector cotangent of tmp)
  auto adj_avec = [&](const float* gy, const float* tmp, const float* x,
                      float* gx) {
    for (int i = tid; i < n3d; i += T) gJ[i] += gy[i / d] * tmp[i % d];
    if (w)
      for (int row = tid; row < r3; row += T) {
        gw[row] += gy[row] * x[row];
        gx[row] += w[row] * gy[row];
      }
    for (int k = tid; k < d; k += T) {
      float s = 0.f;
      for (int row = 0; row < r3; ++row) s += sJ[row * d + k] * gy[row];
      for (int j = 0; j < nl; ++j)
        if (ld[j] == k) s += gy[r3 + j] - gy[r3 + nl + j];
      GT[k] = s;
    }
    __syncthreads();
    adj_tmp(x, GT, gx);
  };

  // ---- forward: the power iterations of the step bound
  {
    float p = 0.f;
    for (int row = tid; row < r; row += T) p += act[row] * act[row];
    const float den = tmax(sqrtf(block_sum(p, red, buf)), 1.f);
    for (int row = tid; row < r; row += T) U[row] = act[row] / den;
    __syncthreads();
  }
  float nrm = 0.f;
  for (int k = 0; k < K; ++k) {
    const float* u = U + k * r;
    for (int row = tid; row < r; row += T) Z[row] = isd[row] * u[row];
    __syncthreads();
    avec(Z, TP + k * d, A + k * r);
    float p = 0.f;
    for (int row = tid; row < r; row += T) {
      const float u2 = isd[row] * A[k * r + row] * act[row];
      p += u2 * u2;
    }
    nrm = sqrtf(block_sum(p, red, buf));
    if (tid == 0) NR[k] = nrm;
    const float den = tmax(nrm, 1e-9f);
    for (int row = tid; row < r; row += T)
      U[(k + 1) * r + row] = isd[row] * A[k * r + row] * act[row] / den;
    __syncthreads();
  }
  const float lam_max = nrm;
  const float m_step = tmax(1.1f * lam_max, 1e-9f);
  const float v_step = 1.8f / m_step;
  float scale = a.omega * tmin(v_step, 1.f);

  // ---- forward: the Jacobi sweeps
  for (int row = tid; row < r; row += T) LAM[row] = lam0[row];
  if (tid == 0) SC[0] = scale;
  __syncthreads();
  float prev = 0.f;
  for (int t = 0; t < iters; ++t) {
    const float* lam = LAM + t * r;
    float* nxt = LAM + (t + 1) * r;
    float* res = RES + t * r;
    avec(lam, TS + t * d, Z);
    for (int row = tid; row < r; row += T)
      res[row] = Z[row] + vf[row] - b[row];
    __syncthreads();
    for (int j = tid; j < c + nl; j += T) {
      if (j < c) {
        const int n = j, t1 = c + j, t2 = 2 * c + j;
        const float lfn = lam[n] - (scale / diag[n]) * res[n];
        float l1 = lam[t1] - (scale / diag[t1]) * res[t1];
        float l2 = lam[t2] - (scale / diag[t2]) * res[t2];
        const float ln = tmax(lfn, 0.f), cap = mu[j] * ln;
        if (a.use_cone) {
          const float tmag = sqrtf(l1 * l1 + l2 * l2);
          const float sc = tmin(cap / tmax(tmag, 1e-9f), 1.f);
          l1 = l1 * sc;
          l2 = l2 * sc;
        } else {
          l1 = tmin(tmax(l1, -cap), cap);
          l2 = tmin(tmax(l2, -cap), cap);
        }
        const float on = ln * act[n], o1 = l1 * act[t1], o2 = l2 * act[t2];
        nxt[n] = isfinite(on) ? on : 0.f;
        nxt[t1] = isfinite(o1) ? o1 : 0.f;
        nxt[t2] = isfinite(o2) ? o2 : 0.f;
      } else {
        for (int h = 0; h < 2; ++h) {
          const int row = r3 + (j - c) + h * nl;
          const float lf = lam[row] - (scale / diag[row]) * res[row];
          const float o = tmax(lf, 0.f) * act[row];
          nxt[row] = isfinite(o) ? o : 0.f;
        }
      }
    }
    __syncthreads();
    float p = 0.f;
    for (int row = tid; row < r; row += T) {
      const float dl = nxt[row] - lam[row];
      p += dl * dl;
    }
    const float dn = block_sum(p, red, buf);
    const bool grow = t > 0 && dn > prev * 1.02f;
    if (grow) scale = scale * 0.5f;
    if (tid == 0) {
      GR[t] = grow ? 1.f : 0.f;
      SC[t + 1] = scale;
    }
    prev = dn;
  }
  __syncthreads();

  // ---- backward: dqd = tmp(lam_iters); GT holds gdqd, GL glam
  adj_tmp(LAM + iters * r, GT, GL);

  // ---- backward: the sweeps, last first. GL holds g(lam_{t+1}).
  float gS = 0.f;  // g(scale_{t+1})
  for (int t = iters - 1; t >= 0; --t) {
    const float* lam = LAM + t * r;
    const float* res = RES + t * r;
    const float sct = SC[t];
    // g of lam_full into GY (row-wise), g of mu into gmu
    for (int j = tid; j < c + nl; j += T) {
      if (j < c) {
        const int n = j, t1 = c + j, t2 = 2 * c + j;
        const float lfn = lam[n] - (sct / diag[n]) * res[n];
        const float l1 = lam[t1] - (sct / diag[t1]) * res[t1];
        const float l2 = lam[t2] - (sct / diag[t2]) * res[t2];
        const float ln = tmax(lfn, 0.f), cap = mu[j] * ln;
        float o1, o2, g1, g2, gc = 0.f, gl1, gl2;
        if (a.use_cone) {
          const float tmag = sqrtf(l1 * l1 + l2 * l2);
          const float den = tmax(tmag, 1e-9f), q = cap / den;
          const float sc = tmin(q, 1.f);
          o1 = l1 * sc;
          o2 = l2 * sc;
          g1 = isfinite(o1 * act[t1]) ? GL[t1] * act[t1] : 0.f;
          g2 = isfinite(o2 * act[t2]) ? GL[t2] * act[t2] : 0.f;
          const float gsc = g1 * l1 + g2 * l2;
          gl1 = g1 * sc;
          gl2 = g2 * sc;
          const float gq = gsc * dmin_dx(q, 1.f);
          gc += gq / den;
          const float gden = -gq * cap / (den * den);
          const float gtm = gden * dmax_dx(tmag, 1e-9f);
          const float gsq = gtm / (2.f * tmag);
          gl1 += gsq * l1 + gsq * l1;
          gl2 += gsq * l2 + gsq * l2;
        } else {
          const float m1 = tmax(l1, -cap), m2 = tmax(l2, -cap);
          o1 = tmin(m1, cap);
          o2 = tmin(m2, cap);
          g1 = isfinite(o1 * act[t1]) ? GL[t1] * act[t1] : 0.f;
          g2 = isfinite(o2 * act[t2]) ? GL[t2] * act[t2] : 0.f;
          const float gm1 = g1 * dmin_dx(m1, cap), gm2 = g2 * dmin_dx(m2, cap);
          gc += g1 * dmin_dy(m1, cap) + g2 * dmin_dy(m2, cap);
          gl1 = gm1 * dmax_dx(l1, -cap);
          gl2 = gm2 * dmax_dx(l2, -cap);
          gc -= gm1 * dmax_dy(l1, -cap) + gm2 * dmax_dy(l2, -cap);
        }
        const float gn = isfinite(ln * act[n]) ? GL[n] * act[n] : 0.f;
        const float gln = gn + mu[j] * gc;
        gmu[j] += ln * gc;
        GY[n] = gln * dmax_dx(lfn, 0.f);
        GY[t1] = gl1;
        GY[t2] = gl2;
      } else {
        for (int h = 0; h < 2; ++h) {
          const int row = r3 + (j - c) + h * nl;
          const float lf = lam[row] - (sct / diag[row]) * res[row];
          const float o = tmax(lf, 0.f) * act[row];
          const float g = isfinite(o) ? GL[row] * act[row] : 0.f;
          GY[row] = g * dmax_dx(lf, 0.f);
        }
      }
    }
    __syncthreads();
    // lam_full = lam - (scale / diag) res
    float p = 0.f;
    for (int row = tid; row < r; row += T) {
      const float glf = GY[row];
      const float gs = -glf * res[row];
      p += gs / diag[row];
      gdiag[row] += -gs * sct / (diag[row] * diag[row]);
      const float gres = -glf * (sct / diag[row]);
      gvf[row] += gres;
      gb[row] -= gres;
      GL[row] = glf;
      GY[row] = gres;
    }
    const float gscale = block_sum(p, red, buf);  // its barrier orders GL, GY
    gS = (GR[t] != 0.f ? 0.5f : 1.f) * gS + gscale;
    adj_avec(GY, TS + t * d, lam, GL);
  }

  // ---- backward: the step bound and the power iterations
  {
    const float gstep = a.omega * gS;
    const float gv = gstep * dmin_dx(v_step, 1.f);
    const float gm = -gv * 1.8f / (m_step * m_step);
    float glmax = 1.1f * (gm * dmax_dx(1.1f * lam_max, 1e-9f));
    for (int row = tid; row < r; row += T) GU[row] = 0.f;
    __syncthreads();
    for (int k = K - 1; k >= 0; --k) {
      const float nk = NR[k];
      const float* Ak = A + k * r;
      float gnrm = k == K - 1 ? glmax : 0.f;
      if (k < K - 1) {
        // u_{k+1} = u2 / max(nrm, 1e-9)
        const float den = tmax(nk, 1e-9f);
        float p = 0.f;
        for (int row = tid; row < r; row += T)
          p += GU[row] * (isd[row] * Ak[row] * act[row]);
        const float gden = -block_sum(p, red, buf) / (den * den);
        gnrm += gden * dmax_dx(nk, 1e-9f);
        for (int row = tid; row < r; row += T) GX[row] = GU[row] / den;
      } else {
        for (int row = tid; row < r; row += T) GX[row] = 0.f;
      }
      // nrm = ||u2|| (zero gradient where nrm == 0), u2 = (isd a) act
      const float* u = U + k * r;
      for (int row = tid; row < r; row += T) {
        const float u2 = isd[row] * Ak[row] * act[row];
        const float gu2 = GX[row] + (nk == 0.f ? 0.f : u2 * (gnrm / nk));
        const float gia = gu2 * act[row];
        GY[row] = gia * isd[row];
        gisd[row] += gia * Ak[row];
        Z[row] = isd[row] * u[row];
        GX[row] = 0.f;
      }
      __syncthreads();
      adj_avec(GY, TP + k * d, Z, GX);
      for (int row = tid; row < r; row += T) {
        gisd[row] += GX[row] * u[row];
        GU[row] = GX[row] * isd[row];
      }
      __syncthreads();
    }
    // isd = rsqrt(diag)
    for (int row = tid; row < r; row += T) {
      const float s = isd[row];
      gdiag[row] += -0.5f * gisd[row] * (s * s * s);
    }
    __syncthreads();
  }

  // ---- backward: the assembly
  for (int i = tid; i < n3d; i += T) {
    const int row = i / d, k = i % d;
    const float gd0 = gdiag[row] * a.ds;
    gJ[i] += gd0 * MJ[i] + gvf[row] * qd[k];
    gMJ[i] += gd0 * sJ[i];
  }
  if (w)
    for (int row = tid; row < r3; row += T) gw[row] += gdiag[row] * a.ds;
  for (int k = tid; k < d; k += T) {
    float s = 0.f;
    for (int row = 0; row < r3; ++row) s += sJ[row * d + k] * gvf[row];
    for (int j = 0; j < nl; ++j)
      if (ld[j] == k) {
        s += gvf[r3 + j] - gvf[r3 + nl + j];
        gMi[k * d + k] += (gdiag[r3 + j] + gdiag[r3 + nl + j]) * a.ds;
      }
    a.gqd[env * d + k] = s;
  }
  __syncthreads();
  // MJ = J M (M = Minv, or Minv^T): gJ += gMJ M^T, gM += J^T gMJ
  for (int i = tid; i < n3d; i += T) {
    const int row = i / d, e = i % d;
    float s = 0.f;
    for (int k = 0; k < d; ++k)
      s += gMJ[row * d + k] * (a.minv_t ? Mi[k * d + e] : Mi[e * d + k]);
    a.gJ[env * n3d + i] = gJ[i] + s;
  }
  for (int i = tid; i < d * d; i += T) {
    const int e = i / d, k = i % d;
    float s = 0.f;
    for (int row = 0; row < r3; ++row) s += sJ[row * d + e] * gMJ[row * d + k];
    if (a.minv_t)
      gMi[k * d + e] += s;
    else
      gMi[e * d + k] += s;
  }
  __syncthreads();
  for (int i = tid; i < d * d; i += T) a.gMinv[env * d * d + i] = gMi[i];
  for (int row = tid; row < r; row += T) {
    a.gb[env * r + row] = gb[row];
    a.glam0[env * r + row] = GL[row];
  }
  for (int j = tid; j < c; j += T) a.gmu[env * c + j] = gmu[j];
  if (a.gw)
    for (int row = tid; row < r3; row += T) a.gw[env * r3 + row] = gw[row];
}

bool valid(int c, int nl, int d, int iters) {
  return c >= 0 && nl >= 0 && d >= 1 && iters >= 0 && 3 * c + 2 * nl >= 1;
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
// w_other and gw together or neither; scratch null for the shared-memory
// instance, W * pgs_backward_scratch_floats floats for the global one.
extern "C" int pgs_solve_backward_f32(
    const float* J, const float* Minv, const float* qd, const float* b,
    const float* act, const float* mu, const float* lam0, const int* ld,
    const float* w_other, const float* glam, const float* gdqd, float* gJ,
    float* gMinv, float* gqd, float* gb, float* gmu, float* glam0,
    float* gw, int W, int c, int nl, int d, int iters, float omega,
    int use_cone, float diag_scale, float reg, float* scratch, int minv_t,
    void* stream) {
  if (W <= 0) return 0;
  if (!valid(c, nl, d, iters) || (w_other == nullptr) != (gw == nullptr))
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(c, nl, d, iters);
  const bool smem = fits_smem(L);
  if (!smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem ? (size_t)L.total * 4 : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pgs_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  Args a;
  a.J = J, a.Minv = Minv, a.qd = qd, a.b = b, a.act = act, a.mu = mu;
  a.lam0 = lam0, a.w = w_other, a.glam = glam, a.gdqd = gdqd, a.ld = ld;
  a.gJ = gJ, a.gMinv = gMinv, a.gqd = gqd, a.gb = gb, a.gmu = gmu;
  a.glam0 = glam0, a.gw = gw, a.scratch = smem ? nullptr : scratch;
  a.c = c, a.nl = nl, a.d = d, a.iters = iters, a.use_cone = use_cone;
  a.minv_t = minv_t, a.omega = omega, a.ds = diag_scale, a.reg = reg;
  pgs_backward_kernel<<<W, threads_for(3 * c + 2 * nl), bytes,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Registers per thread and resident blocks per SM of K4's launch at
// (c, nl, d, iters).
extern "C" int pgs_backward_kernel_info(int c, int nl, int d, int iters,
                                        int* regs, int* blocks_per_sm) {
  if (!valid(c, nl, d, iters)) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(c, nl, d, iters);
  const size_t bytes = fits_smem(L) ? (size_t)L.total * 4 : 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, pgs_backward_kernel);
  if (e == cudaSuccess && bytes > 48 * 1024)
    e = cudaFuncSetAttribute(pgs_backward_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, pgs_backward_kernel, threads_for(3 * c + 2 * nl),
      bytes);
}
