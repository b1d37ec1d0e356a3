// Host-side SDF bake of a triangle mesh (C++, no CUDA): the signed
// distance of every corner of a res^3 grid over [lower, upper], the
// distance to the nearest triangle and the sign by the parity of a +x ray's
// crossings, its origin jittered off the grid's symmetry planes. Port of
// newton_tpu/native/newton_native.cpp's bake_sdf, the same arithmetic.
// Built with g++ at first use by geometry/sdf.py (plain C interface,
// loaded through ctypes); geometry/sdf.py's numpy loop is its plain twin.

#include <cmath>
#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

static inline double dot3(const double* a, const double* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

static inline void sub3(const double* a, const double* b, double* o) {
    o[0] = a[0] - b[0]; o[1] = a[1] - b[1]; o[2] = a[2] - b[2];
}

static double point_tri_dist_sq(const double* p, const double* a,
                                const double* b, const double* c) {
    double ab[3], ac[3], ap[3];
    sub3(b, a, ab); sub3(c, a, ac); sub3(p, a, ap);
    double d1 = dot3(ab, ap), d2 = dot3(ac, ap);
    if (d1 <= 0 && d2 <= 0) { double d[3]; sub3(p, a, d); return dot3(d, d); }
    double bp[3]; sub3(p, b, bp);
    double d3 = dot3(ab, bp), d4 = dot3(ac, bp);
    if (d3 >= 0 && d4 <= d3) { double d[3]; sub3(p, b, d); return dot3(d, d); }
    double vc = d1 * d4 - d3 * d2;
    if (vc <= 0 && d1 >= 0 && d3 <= 0) {
        double t = d1 / (d1 - d3);
        double q[3] = {a[0] + t * ab[0], a[1] + t * ab[1], a[2] + t * ab[2]};
        double d[3]; sub3(p, q, d); return dot3(d, d);
    }
    double cp[3]; sub3(p, c, cp);
    double d5 = dot3(ab, cp), d6 = dot3(ac, cp);
    if (d6 >= 0 && d5 <= d6) { double d[3]; sub3(p, c, d); return dot3(d, d); }
    double vb = d5 * d2 - d1 * d6;
    if (vb <= 0 && d2 >= 0 && d6 <= 0) {
        double t = d2 / (d2 - d6);
        double q[3] = {a[0] + t * ac[0], a[1] + t * ac[1], a[2] + t * ac[2]};
        double d[3]; sub3(p, q, d); return dot3(d, d);
    }
    double va = d3 * d6 - d5 * d4;
    if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
        double t = (d4 - d3) / ((d4 - d3) + (d5 - d6));
        double q[3] = {b[0] + t * (c[0] - b[0]), b[1] + t * (c[1] - b[1]),
                       b[2] + t * (c[2] - b[2])};
        double d[3]; sub3(p, q, d); return dot3(d, d);
    }
    double denom = 1.0 / (va + vb + vc);
    double v = vb * denom, w = vc * denom;
    double q[3] = {a[0] + v * ab[0] + w * ac[0], a[1] + v * ab[1] + w * ac[1],
                   a[2] + v * ab[2] + w * ac[2]};
    double d[3]; sub3(p, q, d); return dot3(d, d);
}

// +x ray / triangle crossing (Moller-Trumbore)
static int ray_x_hits_tri(const double* o, const double* v0, const double* v1,
                          const double* v2) {
    double e1[3], e2[3];
    sub3(v1, v0, e1); sub3(v2, v0, e2);
    // d = (1, 0, 0); pvec = d x e2 = (0, -e2z, e2y)
    double pvec[3] = {0.0, -e2[2], e2[1]};
    double det = dot3(e1, pvec);
    if (std::fabs(det) < 1e-12) return 0;
    double inv = 1.0 / det;
    double tvec[3]; sub3(o, v0, tvec);
    double u = dot3(tvec, pvec) * inv;
    if (u < 0 || u > 1) return 0;
    double qvec[3] = {tvec[1] * e1[2] - tvec[2] * e1[1],
                      tvec[2] * e1[0] - tvec[0] * e1[2],
                      tvec[0] * e1[1] - tvec[1] * e1[0]};
    double v = qvec[0] * inv;   // dot with (1,0,0)
    if (v < 0 || u + v > 1) return 0;
    double t = dot3(qvec, e2) * inv;
    return t > 0 ? 1 : 0;
}

// out: res^3 floats (x-major: ((x*res)+y)*res+z), signed distance
void bake_sdf(const double* verts, int64_t n_verts,
              const int32_t* tris, int64_t n_tris,
              int32_t res, const double* lower, const double* upper,
              float* out) {
    (void)n_verts;
    std::vector<double> step(3);
    for (int k = 0; k < 3; ++k)
        step[k] = (upper[k] - lower[k]) / (res - 1);
    for (int ix = 0; ix < res; ++ix) {
        for (int iy = 0; iy < res; ++iy) {
            for (int iz = 0; iz < res; ++iz) {
                double p[3] = {lower[0] + ix * step[0],
                               lower[1] + iy * step[1],
                               lower[2] + iz * step[2]};
                // jittered parity-ray origin: grid nodes align with mesh
                // symmetry planes; exact edge hits double-count crossings
                double scale = std::max(std::fabs(upper[1] - lower[1]),
                                        std::fabs(upper[2] - lower[2]));
                double pj[3] = {p[0], p[1] + 1.17e-5 * scale,
                                p[2] + 2.71e-5 * scale};
                double best = 1e30;
                int crossings = 0;
                for (int64_t t = 0; t < n_tris; ++t) {
                    const double* a = verts + 3 * tris[3 * t + 0];
                    const double* b = verts + 3 * tris[3 * t + 1];
                    const double* c = verts + 3 * tris[3 * t + 2];
                    double d2 = point_tri_dist_sq(p, a, b, c);
                    if (d2 < best) best = d2;
                    crossings += ray_x_hits_tri(pj, a, b, c);
                }
                double d = std::sqrt(best);
                if (crossings & 1) d = -d;
                out[((int64_t)ix * res + iy) * res + iz] = (float)d;
            }
        }
    }
}

}  // extern "C"
