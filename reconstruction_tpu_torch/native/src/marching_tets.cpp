// Marching-tetrahedra isosurface extraction — native host path.
//
// The TPU solves the implicit function (surface/poisson.py); extraction is
// host-bound and O(R^3), so it gets the native treatment the reference gave
// its mesh toolchain (PoissonRecon.exe / meshlabserver, Demo/mesh.bat) —
// except in-process, OpenMP-parallel, and with semantics identical to the
// NumPy fallback in surface/marching.py (same 6-tet cube split around the
// 0-7 diagonal; bit-compatible case handling).
//
// Two-pass API (count, then fill a caller-allocated buffer):
//   long mt_count(const float* chi, long rx, long ry, long rz, float iso);
//   long mt_extract(const float* chi, long rx, long ry, long rz, float iso,
//                   float* out_tris /* count*9 floats */);

#include <cstdint>
#include <cstring>
#include <cmath>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Cube corners: bit pattern x + 2y + 4z.
const int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

// Six tetrahedra around the 0->7 diagonal (matches surface/marching.py).
const int TETS[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

struct V3 { double x, y, z; };

inline V3 interp(const V3& a, const V3& b, double va, double vb) {
    double t = va / (va - vb + 1e-30);
    return {a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
            a.z + t * (b.z - a.z)};
}

// Emit triangles for one tet; returns count (0..2).  out may be null
// (count-only).  Mirrors _tet_triangles in marching.py: one-inside cases
// emit (k-edge) triangles with orientation flip for the complement;
// two-inside cases emit the quad split (a,o0),(a,o1),(b,o1),(b,o0).
inline int tet_tris(const V3 p[4], const double v[4], V3* out) {
    int code = (v[0] < 0) | ((v[1] < 0) << 1) | ((v[2] < 0) << 2)
             | ((v[3] < 0) << 3);
    if (code == 0 || code == 15) return 0;

    // one inside (or one outside)
    for (int k = 0; k < 4; k++) {
        int one = 1 << k;
        if (code == one || code == (15 ^ one)) {
            int o[3], n = 0;
            for (int j = 0; j < 4; j++) if (j != k) o[n++] = j;
            if (out) {
                V3 t0 = interp(p[k], p[o[0]], v[k], v[o[0]]);
                V3 t1 = interp(p[k], p[o[1]], v[k], v[o[1]]);
                V3 t2 = interp(p[k], p[o[2]], v[k], v[o[2]]);
                if (code == one) { out[0] = t0; out[1] = t1; out[2] = t2; }
                else             { out[0] = t2; out[1] = t1; out[2] = t0; }
            }
            return 1;
        }
    }
    // two inside
    static const int PAIRS[6][2] = {{0,1},{0,2},{0,3},{1,2},{1,3},{2,3}};
    for (int pi = 0; pi < 6; pi++) {
        int a = PAIRS[pi][0], b = PAIRS[pi][1];
        if (code == ((1 << a) | (1 << b))) {
            int o[2], n = 0;
            for (int j = 0; j < 4; j++) if (j != a && j != b) o[n++] = j;
            if (out) {
                V3 q0 = interp(p[a], p[o[0]], v[a], v[o[0]]);
                V3 q1 = interp(p[a], p[o[1]], v[a], v[o[1]]);
                V3 q2 = interp(p[b], p[o[1]], v[b], v[o[1]]);
                V3 q3 = interp(p[b], p[o[0]], v[b], v[o[0]]);
                out[0] = q0; out[1] = q1; out[2] = q2;
                out[3] = q0; out[4] = q2; out[5] = q3;
            }
            return 2;
        }
    }
    return 0;
}

inline long process(const float* chi, long rx, long ry, long rz, float iso,
                    float* out_tris, long cap) {
    long total = 0;
#ifdef _OPENMP
#pragma omp parallel reduction(+:total)
#endif
    {
        // Per-thread staging keeps writes ordered deterministically only
        // in count mode; fill mode runs a second ordered pass per slab.
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
        for (long i = 0; i < rx - 1; i++) {
            long local = 0;
            for (long j = 0; j < ry - 1; j++) {
                for (long k = 0; k < rz - 1; k++) {
                    double vals[8];
                    V3 pos[8];
                    bool lo = false, hi = false;
                    for (int c = 0; c < 8; c++) {
                        long ci = i + CORNERS[c][0];
                        long cj = j + CORNERS[c][1];
                        long ck = k + CORNERS[c][2];
                        double v = (double)chi[(ci * ry + cj) * rz + ck] - iso;
                        vals[c] = v;
                        pos[c] = {(double)ci, (double)cj, (double)ck};
                        if (v < 0) lo = true; else hi = true;
                    }
                    if (!lo || !hi) continue;
                    for (int t = 0; t < 6; t++) {
                        V3 tp[4];
                        double tv[4];
                        for (int c = 0; c < 4; c++) {
                            tp[c] = pos[TETS[t][c]];
                            tv[c] = vals[TETS[t][c]];
                        }
                        local += tet_tris(tp, tv, nullptr);
                    }
                }
            }
            total += local;
        }
    }
    if (!out_tris) return total;

    // Fill pass: sequential per x-slab with running offsets (deterministic
    // ordering; slabs are independent so prefix offsets come from a first
    // count sweep per slab).
    long* slab_counts = new long[rx > 1 ? rx - 1 : 1]();
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < rx - 1; i++) {
        long local = 0;
        for (long j = 0; j < ry - 1; j++)
            for (long k = 0; k < rz - 1; k++) {
                double vals[8]; V3 pos[8]; bool lo=false, hi=false;
                for (int c = 0; c < 8; c++) {
                    long ci=i+CORNERS[c][0], cj=j+CORNERS[c][1], ck=k+CORNERS[c][2];
                    double v=(double)chi[(ci*ry+cj)*rz+ck]-iso;
                    vals[c]=v; pos[c]={(double)ci,(double)cj,(double)ck};
                    if (v<0) lo=true; else hi=true;
                }
                if (!lo||!hi) continue;
                for (int t = 0; t < 6; t++) {
                    V3 tp[4]; double tv[4];
                    for (int c = 0; c < 4; c++) { tp[c]=pos[TETS[t][c]]; tv[c]=vals[TETS[t][c]]; }
                    local += tet_tris(tp, tv, nullptr);
                }
            }
        slab_counts[i] = local;
    }
    long offset = 0;
    long* slab_off = new long[rx > 1 ? rx - 1 : 1];
    for (long i = 0; i < rx - 1; i++) { slab_off[i] = offset; offset += slab_counts[i]; }

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < rx - 1; i++) {
        long w = slab_off[i];  // triangle cursor
        for (long j = 0; j < ry - 1; j++)
            for (long k = 0; k < rz - 1; k++) {
                double vals[8]; V3 pos[8]; bool lo=false, hi=false;
                for (int c = 0; c < 8; c++) {
                    long ci=i+CORNERS[c][0], cj=j+CORNERS[c][1], ck=k+CORNERS[c][2];
                    double v=(double)chi[(ci*ry+cj)*rz+ck]-iso;
                    vals[c]=v; pos[c]={(double)ci,(double)cj,(double)ck};
                    if (v<0) lo=true; else hi=true;
                }
                if (!lo||!hi) continue;
                for (int t = 0; t < 6; t++) {
                    V3 tp[4]; double tv[4]; V3 tris[6];
                    for (int c = 0; c < 4; c++) { tp[c]=pos[TETS[t][c]]; tv[c]=vals[TETS[t][c]]; }
                    int n = tet_tris(tp, tv, tris);
                    for (int q = 0; q < n; q++) {
                        if (w < cap) {
                            for (int vtx = 0; vtx < 3; vtx++) {
                                out_tris[w * 9 + vtx * 3 + 0] = (float)tris[q * 3 + vtx].x;
                                out_tris[w * 9 + vtx * 3 + 1] = (float)tris[q * 3 + vtx].y;
                                out_tris[w * 9 + vtx * 3 + 2] = (float)tris[q * 3 + vtx].z;
                            }
                        }
                        w++;
                    }
                }
            }
    }
    delete[] slab_counts;
    delete[] slab_off;
    return total;
}

}  // namespace

extern "C" {

long mt_count(const float* chi, long rx, long ry, long rz, float iso) {
    return process(chi, rx, ry, rz, iso, nullptr, 0);
}

long mt_extract(const float* chi, long rx, long ry, long rz, float iso,
                float* out_tris, long cap_tris) {
    return process(chi, rx, ry, rz, iso, out_tris, cap_tris);
}

}  // extern "C"
