// Binary PLY record packing/unpacking — native host path.
//
// Replaces the reference's vendored rply (CloudOptimization/rply.{h,c})
// and hand-rolled writers (CStereoMatching.cpp:723-757).  The Python layer
// (io/ply.py) handles headers; these kernels move the bulk vertex payloads
// between column arrays and interleaved record buffers without Python-level
// copies.  OpenMP-parallel for multi-million-point clouds.

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// xyz (n,3) f32 [+ optional nrm (n,3) f32] [+ optional rgb (n,3) u8,
// written in `bgr` order when bgr != 0] -> packed records.
// Record layout: 12B xyz [+12B nrm] [+3B color].  Returns record size.
long ply_pack(long n, const float* xyz, const float* nrm,
              const uint8_t* rgb, int bgr, uint8_t* out) {
    long rec = 12 + (nrm ? 12 : 0) + (rgb ? 3 : 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < n; i++) {
        uint8_t* p = out + i * rec;
        std::memcpy(p, xyz + i * 3, 12);
        p += 12;
        if (nrm) { std::memcpy(p, nrm + i * 3, 12); p += 12; }
        if (rgb) {
            const uint8_t* c = rgb + i * 3;
            if (bgr) { p[0] = c[2]; p[1] = c[1]; p[2] = c[0]; }
            else     { p[0] = c[0]; p[1] = c[1]; p[2] = c[2]; }
        }
    }
    return rec;
}

// Packed records -> column arrays (inverse of ply_pack).
void ply_unpack(long n, const uint8_t* recs, long rec_size,
                int has_nrm, int has_rgb, int bgr,
                float* xyz, float* nrm, uint8_t* rgb) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < n; i++) {
        const uint8_t* p = recs + i * rec_size;
        std::memcpy(xyz + i * 3, p, 12);
        p += 12;
        if (has_nrm) { std::memcpy(nrm + i * 3, p, 12); p += 12; }
        if (has_rgb) {
            if (bgr) { rgb[i*3+0] = p[2]; rgb[i*3+1] = p[1]; rgb[i*3+2] = p[0]; }
            else     { rgb[i*3+0] = p[0]; rgb[i*3+1] = p[1]; rgb[i*3+2] = p[2]; }
        }
    }
}

// Triangle faces -> PLY face records (u8 count + 3x i32).
void ply_pack_faces(long n, const int32_t* faces, uint8_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < n; i++) {
        uint8_t* p = out + i * 13;
        p[0] = 3;
        std::memcpy(p + 1, faces + i * 3, 12);
    }
}

}  // extern "C"
