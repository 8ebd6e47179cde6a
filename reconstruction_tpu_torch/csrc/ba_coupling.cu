// K4: the bundle adjustment's point-camera coupling contraction
//
//   W_t[e, c, m] = sum_o He[e, o, m] * [cam[o, m] == c]
//
// for the Schur reduction of `ba/bundle_adjust.ba_blocks`.  It replaces the
// TPU kernel `_coupling_kernel`
// (reconstruction_tpu/ops/ba_coupling_pallas.py:39, launched by
// `ba_coupling_pallas`), which kept an (18, C, 512) accumulator in VMEM.
//
// What bounds it on this card.  The contraction is elementwise in m and
// tiny in (o -> c): at the bench shape (E=18, O=8, C=16, M=65,536) it
// reads He (37.7 MB) and cam (2.1 MB) and writes W_t (75.5 MB), 115 MB
// in all, about 35 us at 3.35 TB/s, against E*C*O = 2,304 multiply-adds
// per m (0.3 GFLOP): device memory bounds it.
//
// What the design does about it.  One thread per m, so every load and
// store is coalesced along m; the O camera ids and one row He[e, :, m]
// sit in registers, and each W_t entry is summed there and written once.
// Every operand crosses device memory exactly once.
//
// Exactness.  The sum over o runs in ascending order as
// acc = mask_0 * He_0, acc = acc + mask_o * He_o, each product and sum
// rounded once (the library is built with --fmad=false), which is the
// Pallas kernel's arithmetic.  Camera ids outside [0, C) (the -1 padding)
// match no c and contribute nothing.
#include "common.cuh"

namespace {

constexpr int K4_THREADS = 256;

template <int MAXO>
__global__ void __launch_bounds__(K4_THREADS)
ba_coupling_kernel(const float* __restrict__ He, const int* __restrict__ cam,
                   float* __restrict__ Wt, int E, int O, int C, int M) {
  const int m = blockIdx.x * K4_THREADS + threadIdx.x;
  if (m >= M) return;
  int cid[MAXO];
#pragma unroll
  for (int o = 0; o < MAXO; ++o) cid[o] = o < O ? cam[(size_t)o * M + m] : -1;
  for (int e = 0; e < E; ++e) {
    float h[MAXO];
#pragma unroll
    for (int o = 0; o < MAXO; ++o)
      h[o] = o < O ? He[((size_t)e * O + o) * M + m] : 0.0f;
    for (int c = 0; c < C; ++c) {
      float acc = __fmul_rn(cid[0] == c ? 1.0f : 0.0f, h[0]);
#pragma unroll
      for (int o = 1; o < MAXO; ++o)
        if (o < O) acc = __fadd_rn(acc, __fmul_rn(cid[o] == c ? 1.0f : 0.0f, h[o]));
      Wt[((size_t)e * C + c) * M + m] = acc;
    }
  }
}

}  // namespace

RTT_API int rtt_ba_coupling(const void* He, const void* cam, void* Wt, int E,
                            int O, int C, int M, void* stream) {
  const unsigned grid = (unsigned)((M + K4_THREADS - 1) / K4_THREADS);
  const float* h = static_cast<const float*>(He);
  const int* k = static_cast<const int*>(cam);
  float* w = static_cast<float*>(Wt);
  if (O <= 8)
    ba_coupling_kernel<8><<<grid, K4_THREADS, 0, rtt_stream(stream)>>>(
        h, k, w, E, O, C, M);
  else if (O <= 32)
    ba_coupling_kernel<32><<<grid, K4_THREADS, 0, rtt_stream(stream)>>>(
        h, k, w, E, O, C, M);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
