// K8: the rectify maps (rectified pixel -> source pixel, float32 map_x and
// map_y) of one view, built on the card from the calibration alone.
//
// Replaces the host's maps, `core/remap.sampling_maps` (float64 NumPy),
// which the pair path built for both views of every pair and then copied
// up to the card.  The JAX package has no Pallas kernel for this: its
// `reconstruction_tpu/core/remap.py:20-52` (`rectify_map`) builds the maps
// on the host with `einsum` too.  Per pixel (u, v), in float64:
//
//   xyw_i = (m_i0*u + m_i1*v) + m_i2          i = 0, 1, 2
//   x = xyw_0 / xyw_2,  y = xyw_1 / xyw_2
//   map_x = (k00*x + k01*y) + k02,  map_y = k11*y + k12
//
// then each rounded to float32.  Every operation is one IEEE operation
// (__dmul_rn, __dadd_rn, __ddiv_rn: no contraction, a correctly rounded
// division) in the plain version's order, and __double2float_rn rounds as
// NumPy's astype(float32): the maps are bit-equal to the plain version's
// (NaN where xyw_2 and the numerator are both 0, by position).
//
// Bound: 8 bytes written a pixel (nothing is read: M_inv and K arrive as
// kernel arguments), 66 MB at 3840x2160, 19.8 us at 3.35 TB/s; 20 float64
// operations a pixel (a division counted as one) take less at the FP64
// rate.  Design: one pass writes both maps; each thread takes 4 adjacent
// pixels in row-major order (one row, or the end of one and the start of
// the next) and stores each map's 4 values with one 16-byte store, so a
// warp writes 512 contiguous bytes a map.  The row and column are found
// once a thread and then stepped.  256 threads a block: 8,100 blocks at
// 3840x2160 and 2,400 at 1280x1920, many per SM on all 132.  Only the last
// thread's group can be short (H*W not a multiple of 4): it stores what is
// inside the image one float at a time.
#include "common.cuh"

namespace {

constexpr int kPixels = 4;     // adjacent pixels a thread: one float4 a map
constexpr int kThreads = 256;

struct RectifyCoeffs {
  double m[9];                 // M_inv, row-major
  double k00, k01, k02, k11, k12;
};

__device__ __forceinline__ double rtt_row_dot(const double* m, double u, double v) {
  return __dadd_rn(__dadd_rn(__dmul_rn(m[0], u), __dmul_rn(m[1], v)), m[2]);
}

__global__ void __launch_bounds__(kThreads)
    rectify_map_kernel(float* __restrict__ map_x, float* __restrict__ map_y,
                       long long n, int W, RectifyCoeffs c) {
  const long long p0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kPixels;
  if (p0 >= n) return;
  int y = (int)(p0 / W);
  int x = (int)(p0 - (long long)y * W);
  float mx[kPixels], my[kPixels];
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const double u = (double)x, v = (double)y;
    const double xw = rtt_row_dot(c.m, u, v);
    const double yw = rtt_row_dot(c.m + 3, u, v);
    const double ww = rtt_row_dot(c.m + 6, u, v);
    const double xs = __ddiv_rn(xw, ww);
    const double ys = __ddiv_rn(yw, ww);
    mx[k] = __double2float_rn(
        __dadd_rn(__dadd_rn(__dmul_rn(c.k00, xs), __dmul_rn(c.k01, ys)), c.k02));
    my[k] = __double2float_rn(__dadd_rn(__dmul_rn(c.k11, ys), c.k12));
    if (++x == W) {
      x = 0;
      ++y;
    }
  }
  if (p0 + kPixels <= n) {
    // p0 is a multiple of 4 and torch's allocations are 16-byte aligned.
    *reinterpret_cast<float4*>(map_x + p0) = make_float4(mx[0], mx[1], mx[2], mx[3]);
    *reinterpret_cast<float4*>(map_y + p0) = make_float4(my[0], my[1], my[2], my[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPixels; ++k)
      if (p0 + k < n) {
        map_x[p0 + k] = mx[k];
        map_y[p0 + k] = my[k];
      }
  }
}

}  // namespace

// map_x, map_y: (H, W) float32, contiguous.  m: M_inv row-major; k: K's
// entries (0,0), (0,1), (0,2), (1,1), (1,2).
RTT_API int rtt_rectify_map(void* map_x, void* map_y, int H, int W, double m00,
                            double m01, double m02, double m10, double m11,
                            double m12, double m20, double m21, double m22,
                            double k00, double k01, double k02, double k11,
                            double k12, void* stream) {
  const long long n = (long long)H * W;
  if (n <= 0) return 0;
  RectifyCoeffs c = {{m00, m01, m02, m10, m11, m12, m20, m21, m22},
                     k00, k01, k02, k11, k12};
  const long long groups = (n + kPixels - 1) / kPixels;
  const unsigned blocks = (unsigned)((groups + kThreads - 1) / kThreads);
  rectify_map_kernel<<<blocks, kThreads, 0, rtt_stream(stream)>>>(
      static_cast<float*>(map_x), static_cast<float*>(map_y), n, W, c);
  return (int)cudaGetLastError();
}
