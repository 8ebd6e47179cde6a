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
