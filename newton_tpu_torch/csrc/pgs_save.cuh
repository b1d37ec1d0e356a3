// The forward that B2 (csrc/pgs_solve.cu) saves for its backward K4
// (csrc/pgs_backward.cu) where an input requires grad, per env in floats
// (block-order rows; T sweeps, K power iterations): lam (T r, each
// sweep's new lambda), res (T r, its (A lambda + v_free) - b), yf (T r,
// lambda - (scale / diag) res before the projection), tmp (T d, the
// sweep's MJx^T x), py (K r, the power iteration's Delassus product), ptp
// (K d, its d-vector), nrm (K) and grow (T, 1 where the guard halved the
// step after the sweep). solvers/generalized/pgs.py: save_floats mirrors
// the total.

#pragma once

namespace ntt {

struct SaveLayout {
  int lam, res, yf, tmp, py, ptp, nrm, grow, total;
};

__host__ __device__ inline SaveLayout save_layout(int r, int d, int K,
                                                  int T) {
  SaveLayout L;
  L.lam = 0;
  L.res = L.lam + T * r;
  L.yf = L.res + T * r;
  L.tmp = L.yf + T * r;
  L.py = L.tmp + T * d;
  L.ptp = L.py + K * r;
  L.nrm = L.ptp + K * d;
  L.grow = L.nrm + K;
  L.total = L.grow + T;
  return L;
}

}  // namespace ntt
