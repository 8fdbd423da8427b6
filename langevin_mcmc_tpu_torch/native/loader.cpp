// Native mesh preprocessing: angle-weighted vertex normals (a copy of the
// vertex-normal part of the JAX package's native/loader.cpp; its Woop
// tables feed only the matrix-product intersection backend, which the
// port does not have).
//
// Nelson Max's angle-weighted vertex normals, the counterpart of the
// reference's loadserialized.cpp:114-151 / parseobj.cpp:57-92 and of the
// numpy scene/mesh.py::compute_vertex_normals, exposed via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>

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

}  // extern "C"
