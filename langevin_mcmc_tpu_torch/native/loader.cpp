// Native mesh preprocessing (a copy of the per-triangle part of the JAX
// package's native/loader.cpp, same entry points and ABI), exposed via
// ctypes:
//  * Nelson Max's angle-weighted vertex normals, the counterpart of the
//    reference's loadserialized.cpp:114-151 / parseobj.cpp:57-92 and of
//    the numpy scene/mesh.py::compute_vertex_normals;
//  * the Woop inverse-frame tables of the matmul intersection backend
//    (ops/intersect.py build_matmul_tables, which the parser uses).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline void cross3(const double* a, const double* b, double* o) {
    o[0] = a[1] * b[2] - a[2] * b[1];
    o[1] = a[2] * b[0] - a[0] * b[2];
    o[2] = a[0] * b[1] - a[1] * b[0];
}

inline double dot3(const double* a, const double* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

inline double norm3(const double* a) { return std::sqrt(dot3(a, a)); }

inline double unit_angle(const double* u, const double* v) {
    double s[3] = {v[0] + u[0], v[1] + u[1], v[2] + u[2]};
    double d[3] = {v[0] - u[0], v[1] - u[1], v[2] - u[2]};
    if (dot3(u, v) < 0)
        return (M_PI - 2.0) * std::asin(std::min(1.0, 0.5 * norm3(s)));
    return 2.0 * std::asin(std::min(1.0, 0.5 * norm3(d)));
}

}  // namespace

extern "C" {

// Angle-weighted vertex normals (Nelson Max 1999), matching
// reference loadserialized.cpp:114-151 / parseobj.cpp:57-92.
void lmcmc_vertex_normals(const float* verts /*[V,3]*/, int num_verts,
                          const int32_t* indices /*[T,3]*/, int num_tris,
                          int flip, float* normals_out /*[V,3]*/) {
    double* acc = new double[size_t(num_verts) * 3]();
    for (int t = 0; t < num_tris; ++t) {
        const int32_t* idx = indices + 3 * t;
        double p[3][3];
        for (int c = 0; c < 3; ++c)
            for (int k = 0; k < 3; ++k)
                p[c][k] = verts[3 * idx[c] + k];
        double fn[3] = {0, 0, 0};
        bool ok = true;
        for (int c = 0; c < 3; ++c) {
            const double* v0 = p[c];
            const double* v1 = p[(c + 1) % 3];
            const double* v2 = p[(c + 2) % 3];
            double a[3] = {v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2]};
            double b[3] = {v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2]};
            if (c == 0) {
                cross3(a, b, fn);
                double l = norm3(fn);
                if (l == 0) { ok = false; break; }
                for (int k = 0; k < 3; ++k) fn[k] /= l;
            }
            double la = norm3(a), lb = norm3(b);
            if (la == 0 || lb == 0) continue;
            double an[3] = {a[0] / la, a[1] / la, a[2] / la};
            double bn[3] = {b[0] / lb, b[1] / lb, b[2] / lb};
            double w = unit_angle(an, bn);
            double sgn = flip ? -1.0 : 1.0;
            for (int k = 0; k < 3; ++k)
                acc[3 * idx[c] + k] += sgn * w * fn[k];
        }
        (void)ok;
    }
    for (int v = 0; v < num_verts; ++v) {
        double l = norm3(acc + 3 * v);
        for (int k = 0; k < 3; ++k)
            normals_out[3 * v + k] = l > 0 ? float(acc[3 * v + k] / l) : 0.f;
    }
    delete[] acc;
}

// Woop inverse-frame tables for the matmul intersection backend
// (ops/intersect.py build_matmul_tables): per triangle invert
// A = [e1 | e2 | e1 x e2]; outputs B [3, 3T] (A^-T laid out for a
// [R,3] @ [3,3T] matmul), C [3T] (A^-1 p0) and a validity mask.
void lmcmc_woop_tables(const float* tri /*[T,3,3]*/, int num_tris,
                       float* B_out /*[3,3T]*/, float* C_out /*[3T]*/,
                       uint8_t* ok_out /*[T]*/) {
    for (int t = 0; t < num_tris; ++t) {
        const float* p0 = tri + 9 * t;
        const float* p1 = tri + 9 * t + 3;
        const float* p2 = tri + 9 * t + 6;
        double e1[3], e2[3], n[3];
        for (int k = 0; k < 3; ++k) {
            e1[k] = double(p1[k]) - p0[k];
            e2[k] = double(p2[k]) - p0[k];
        }
        cross3(e1, e2, n);
        // A columns = e1, e2, n; det and inverse (adjugate)
        double A[3][3] = {{e1[0], e2[0], n[0]},
                          {e1[1], e2[1], n[1]},
                          {e1[2], e2[2], n[2]}};
        double det = A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1])
                   - A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0])
                   + A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]);
        bool ok = std::abs(det) > 1e-18;
        ok_out[t] = ok ? 1 : 0;
        double inv[3][3];
        if (!ok) {
            std::memset(inv, 0, sizeof(inv));
            inv[0][0] = inv[1][1] = inv[2][2] = 1.0;
        } else {
            double id = 1.0 / det;
            inv[0][0] = (A[1][1] * A[2][2] - A[1][2] * A[2][1]) * id;
            inv[0][1] = (A[0][2] * A[2][1] - A[0][1] * A[2][2]) * id;
            inv[0][2] = (A[0][1] * A[1][2] - A[0][2] * A[1][1]) * id;
            inv[1][0] = (A[1][2] * A[2][0] - A[1][0] * A[2][2]) * id;
            inv[1][1] = (A[0][0] * A[2][2] - A[0][2] * A[2][0]) * id;
            inv[1][2] = (A[0][2] * A[1][0] - A[0][0] * A[1][2]) * id;
            inv[2][0] = (A[1][0] * A[2][1] - A[1][1] * A[2][0]) * id;
            inv[2][1] = (A[0][1] * A[2][0] - A[0][0] * A[2][1]) * id;
            inv[2][2] = (A[0][0] * A[1][1] - A[0][1] * A[1][0]) * id;
        }
        // B layout: [3 rows, T*3 cols], column block t holds A^-T
        for (int r = 0; r < 3; ++r)
            for (int c = 0; c < 3; ++c)
                B_out[size_t(r) * (3 * num_tris) + 3 * t + c] =
                    float(inv[c][r]);
        // C = A^-1 p0
        for (int c = 0; c < 3; ++c) {
            double s = 0;
            for (int k = 0; k < 3; ++k) s += inv[c][k] * p0[k];
            C_out[3 * t + c] = float(s);
        }
    }
}

}  // extern "C"
