// K9: one pyramid step (5-tap binomial blur down the rows, then along
// them, and 2x decimation) in one pass over the image.
//
// Replaces the plain version, `core/pyramid.pyr_down`: two separable
// blurs over the whole image, each tap a correctly rounded float32
// multiply-add emulated in float64 (`utils/fp.fma32`), about 184 launches
// a step.  No Pallas kernel stands behind it: the JAX package's
// `reconstruction_tpu/core/pyramid.py:22-38` (`pyr_down`) is plain XLA.
// Per output value (i, j, c), with reflect-101 indices (-t, 2(n-1)-t):
//
//   v(y)  = blur(x[2i-2 .. 2i+2, y, c])          y = 2j-2 .. 2j+2
//   out   = blur(v(2j-2) .. v(2j+2))
//   blur(a0..a4) = fmaf(k4, a4, fmaf(k3, a3, fmaf(k2, a2, fmaf(k1, a1, k0*a0))))
//
// with k = (1, 4, 6, 4, 1) / 16, exact in float32.  That is the plain
// version's own order (the JAX package's contraction compiled by XLA:CPU),
// and __fmaf_rn rounds as fma32 does, once: the output is bit-equal.  The
// library is built with --fmad=false and without flush-to-zero, so
// subnormals stay as the plain version keeps them.  Optionally the same
// pass writes the output rounded to the uint8 grid (`quantize_u8`:
// clamp(rint(v), 0, 255)), and the input so rounded: a mask pyramid's
// levels need nothing else.
//
// Bound: the input read once and a quarter of it written (twice with the
// rounded copies): 124 MB at 3840x2160x3, 37 us at 3.35 TB/s.  Design: a
// block owns a tile of 8 x 32 output pixels and one chunk of channels (all
// of 1 or 3; 4 at a time otherwise).  Its 256 threads stage the 19 x 67
// input pixels the tile reads (rows 2*i0-2 .. 2*i0+16, reflected at the
// image's edges) in shared memory with loads along the contiguous W*C
// axis, blur down the rows at the tile's 8 even rows into a second buffer,
// then along the rows at its 32 even columns, and store along W*C.
#include "common.cuh"

namespace {

constexpr int kTileRows = 8;                  // output rows a block
constexpr int kTileCols = 32;                 // output columns a block
constexpr int kInRows = 2 * kTileRows + 3;    // staged input rows
constexpr int kInCols = 2 * kTileCols + 3;    // staged input columns
constexpr int kChunk = 4;                     // channels a block for C other than 1, 3
constexpr int kThreads = 256;

// jnp.pad(mode="reflect") index for t in [-(n-1), 2(n-1)]; clamped beyond,
// where only rows and columns of outputs outside the image land.
__device__ __forceinline__ int rtt_reflect101(int t, int n) {
  t = t < 0 ? -t : t;
  t = t >= n ? 2 * (n - 1) - t : t;
  return min(max(t, 0), n - 1);
}

__device__ __forceinline__ float rtt_blur5(float a0, float a1, float a2, float a3,
                                           float a4) {
  float acc = __fmul_rn(0.0625f, a0);
  acc = __fmaf_rn(0.25f, a1, acc);
  acc = __fmaf_rn(0.375f, a2, acc);
  acc = __fmaf_rn(0.25f, a3, acc);
  return __fmaf_rn(0.0625f, a4, acc);
}

// torch.clamp(torch.round(v), 0, 255): half to even; NaN stays NaN.
__device__ __forceinline__ float rtt_quantize_u8(float v) {
  const float r = rintf(v);
  return r < 0.0f ? 0.0f : (r > 255.0f ? 255.0f : r);
}

// CT: the channel count (1 or 3), or 0 for any other, taken kChunk at a time.
template <int CT>
__global__ void __launch_bounds__(kThreads)
    pyr_down_kernel(const float* __restrict__ in, float* __restrict__ out,
                    float* __restrict__ out_q, float* __restrict__ in_q, int H, int W,
                    int C) {
  constexpr int CB = CT > 0 ? CT : kChunk;
  constexpr int kRowElems = kInCols * CB;
  constexpr int kOutElems = kTileCols * CB;
  constexpr int kCoreElems = 2 * kTileCols * CB;
  __shared__ float s_in[kInRows][kRowElems];
  __shared__ float s_v[kTileRows][kRowElems];

  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int i0 = blockIdx.y * kTileRows, j0 = blockIdx.x * kTileCols;
  const int c0 = blockIdx.z * CB;
  const int cb = CT > 0 ? CT : min(CB, C - c0);
  const int y0 = 2 * i0 - 2, x0 = 2 * j0 - 2;

  rtt_stage(
      kInRows, kRowElems,
      [&](int r, int e) {
        const int col = e / CB, c = e - col * CB;
        if (c >= cb) return 0.0f;
        const int y = rtt_reflect101(y0 + r, H), x = rtt_reflect101(x0 + col, W);
        return __ldg(in + ((size_t)y * W + x) * C + c0 + c);
      },
      [&](int r, int e, float v) { s_in[r][e] = v; });
  __syncthreads();

  if (in_q != nullptr) {
    // The block's own input pixels: rows 2*i0 .. 2*i0+15, columns
    // 2*j0 .. 2*j0+63, inside the image (so never a reflected copy).
    for (int t = threadIdx.x; t < 2 * kTileRows * kCoreElems; t += kThreads) {
      const int rr = t / kCoreElems, e = t - rr * kCoreElems;
      const int col = e / CB, c = e - col * CB;
      const int y = 2 * i0 + rr, x = 2 * j0 + col;
      if (y < H && x < W && c < cb)
        in_q[((size_t)y * W + x) * C + c0 + c] = rtt_quantize_u8(s_in[rr + 2][e + 2 * CB]);
    }
  }

  for (int t = threadIdx.x; t < kTileRows * kRowElems; t += kThreads) {
    const int r = t / kRowElems, e = t - r * kRowElems;
    s_v[r][e] = rtt_blur5(s_in[2 * r][e], s_in[2 * r + 1][e], s_in[2 * r + 2][e],
                          s_in[2 * r + 3][e], s_in[2 * r + 4][e]);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < kTileRows * kOutElems; t += kThreads) {
    const int r = t / kOutElems, e = t - r * kOutElems;
    const int jj = e / CB, c = e - jj * CB;
    const int i = i0 + r, j = j0 + jj;
    if (i < Ho && j < Wo && c < cb) {
      const float* v = &s_v[r][2 * jj * CB + c];
      const float o = rtt_blur5(v[0], v[CB], v[2 * CB], v[3 * CB], v[4 * CB]);
      const size_t k = ((size_t)i * Wo + j) * C + c0 + c;
      out[k] = o;
      if (out_q != nullptr) out_q[k] = rtt_quantize_u8(o);
    }
  }
}

template <int CT>
int rtt_launch_pyr_down(const float* in, float* out, float* out_q, float* in_q, int H,
                        int W, int C, cudaStream_t stream) {
  constexpr int CB = CT > 0 ? CT : kChunk;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const dim3 grid((Wo + kTileCols - 1) / kTileCols, (Ho + kTileRows - 1) / kTileRows,
                  (C + CB - 1) / CB);
  pyr_down_kernel<CT><<<grid, kThreads, 0, stream>>>(in, out, out_q, in_q, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// in: (H, W, C) float32, contiguous, H and W at least 3; out (and out_q when
// not null): (ceil(H/2), ceil(W/2), C); in_q, when not null: (H, W, C).
RTT_API int rtt_pyr_down(void* in, void* out, void* out_q, void* in_q, int H, int W,
                         int C, void* stream) {
  if (H < 3 || W < 3 || C <= 0) return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(in);
  float* o = static_cast<float*>(out);
  float* oq = static_cast<float*>(out_q);
  float* iq = static_cast<float*>(in_q);
  const cudaStream_t s = rtt_stream(stream);
  if (C == 1) return rtt_launch_pyr_down<1>(x, o, oq, iq, H, W, C, s);
  if (C == 3) return rtt_launch_pyr_down<3>(x, o, oq, iq, H, W, C, s);
  return rtt_launch_pyr_down<0>(x, o, oq, iq, H, W, C, s);
}
