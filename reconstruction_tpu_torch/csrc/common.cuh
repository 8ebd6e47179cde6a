// Shared helpers of the port's CUDA kernels.
//
// Every entry point has a plain C interface (bound from Python with
// ctypes): pointers and the stream arrive as void*, sizes as int, and
// each entry returns cudaGetLastError() right after its launch.
//
// The library is compiled with --fmad=false, so no multiply and add are
// ever fused behind the source's back.  Where the JAX reference, as
// XLA:CPU compiles it, rounds a multiply-add once, the kernels say so
// explicitly with __fmaf_rn; everything else is one IEEE operation per
// source operator, in the reference's order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RTT_NOMATCH (-10000.0f)

#define RTT_API extern "C" __attribute__((visibility("default")))

static inline cudaStream_t rtt_stream(void* s) {
  return reinterpret_cast<cudaStream_t>(s);
}

// The zero-mean NCC score of the sweeps (K1, K5), rounded as the reference
// compiles (cross - n*muL*muR) * invL * invR: one fused multiply-add, then
// two products.  nmu is n * muL, precomputed.
__device__ __forceinline__ float rtt_ncc_score(float cross, float nmu,
                                               float muR, float invL,
                                               float invR) {
  return __fmul_rn(__fmul_rn(__fmaf_rn(-nmu, muR, cross), invL), invR);
}

// The sweeps' images are centered uint8 values, integers in [-128, 127]:
// exact in int8, and their products and window sums are exact integers
// (below 2^22 for a window of up to 7x7 pixels and 4 channels), equal in
// any order to the reference's float sums.  The kernels convert each value
// they read and set ``bad`` for one off that grid (a fraction, out of
// range, NaN); their wrappers raise on the flag.
__device__ __forceinline__ int rtt_int8(float v, bool& bad) {
  bad |= !(v == rintf(v) && v >= -128.0f && v <= 127.0f);
  return __float2int_rn(v);
}

// Channels of pixel (y, x) packed as int8x4 (zero padded), 0 outside the
// image (the reference's zero padding).  No branch: the (up to four)
// loads are predicated and independent, so a thread keeps those of many
// pixels in flight at once.
__device__ __forceinline__ int rtt_pack_px(const float* __restrict__ img, int y,
                                           int x, int H, int W, int C,
                                           bool& bad) {
  const bool in = y >= 0 && y < H && x >= 0 && x < W;
  const float* p = img + (in ? ((size_t)y * W + x) * C : 0);
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = in && c < C ? p[c] : 0.0f;
  unsigned w = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    w |= ((unsigned)rtt_int8(v[c], bad) & 0xffu) << (8 * c);
  return (int)w;
}

// Cost-volume elements (K3 writes, K2 reads): float32, or bfloat16 that K3
// rounds to nearest even from the float32 score (__float2bfloat16_rn, as
// jnp.astype(bfloat16) and torch's .to(torch.bfloat16) round).  K2 widens
// a bfloat16 tap to float32 exactly: its bits are the float's top half.
__device__ __forceinline__ float rtt_ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float rtt_ldg_f32(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// An integer below 2^22 in magnitude as float, exactly: two operations on
// the full-rate pipes instead of one conversion.
__device__ __forceinline__ float rtt_small_int_to_float(int v) {
  return __fsub_rn(__int_as_float(0x4B400000 + v), 12582912.0f);
}

// for (r, c) in [0, rows) x [0, n), row-major over the block's threads:
// v = load(r, c), then store(r, c, v), BATCH loads of each thread in
// flight at a time; a thread finds its next element by stepping, not
// dividing.
template <int BATCH = 4, typename Load, typename Store>
__device__ __forceinline__ void rtt_stage(int rows, int n, Load load, Store store) {
  const int nt = blockDim.x, dr = nt / n, dc = nt % n;
  int r = threadIdx.x / n, c = threadIdx.x % n;
  while (r < rows) {
    int rb[BATCH], cb[BATCH];
    decltype(load(0, 0)) v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      rb[u] = r;
      cb[u] = c;
      if (r < rows) v[u] = load(r, c);
      r += dr;
      c += dc;
      if (c >= n) {
        c -= n;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (rb[u] < rows) store(rb[u], cb[u], v[u]);
  }
}
