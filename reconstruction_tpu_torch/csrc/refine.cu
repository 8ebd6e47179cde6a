// K2: Jacobi sweeps of the subpixel disparity refine, T sweeps per launch.
//
// Replaces the TPU kernel `_segment_kernel`
// (reconstruction_tpu/ops/refine_pallas.py:69, launched by
// `disparity_refine_pallas`), the refine's default on the TPU, and the
// XLA mini-CV loop `_refine_minicv` (reconstruction_tpu/stereo/refine.py:298)
// that it equals.
//
// What bounds it on this card.  The function needs per pixel and sweep
// three 4-byte cost taps (2-byte in bfloat16) of the pixels that can move
// and about 70 flops there (two exps and three IEEE divisions included);
// per call it reads d, j0, jref (4 bytes) and inner (1) and writes d (4)
// once, and each volume tap that one of its sweeps reads once: the anchors rarely move, so six
// sweeps at 1920x1280 read 28 M taps but only 6.6 M distinct ones
// (chip_smoke.py counts them).  With the 42 MB of maps that is ~68 MB a
// launch of six sweeps: device memory bounds it, ~0.020 ms a launch.  One
// launch per sweep would move the 42 MB and the taps every sweep, and in
// a pixel-major volume (H, W, s_cap) a warp's tap load would touch 32
// sectors 512 bytes apart.
//
// What the design does about it.  The volume is slot-major, (H, s_cap, W):
// the taps of neighbouring pixels at one slot lie on neighbouring
// addresses, so a warp's tap load touches about as many 128-byte rows as
// its pixels have distinct anchors (a few on a smooth surface).  One
// launch runs T sweeps (the TPU kernel's temporal blocking): a block holds
// its tile of d plus a T-pixel halo in shared memory (two buffers, one per
// parity of the sweep), with j0, jref and inner beside it, sweeps T times
// over a region that shrinks by one pixel a side each sweep (what lies
// outside it no longer matters for the tile), and writes its inner tile
// once.  Only the taps come from memory during the sweeps, from L2 after
// the first (the anchors rarely move).  What remains is latency and the
// instruction count: each thread requests the taps of two pixels before it
// uses either, and 512 threads a block, two blocks an SM, keep 32 warps in
// flight.  The tile is 128x32 (1.2 times as many pixel updates as the
// tile's own at T = 6) and shrinks on coarse levels until there are two
// blocks per SM.
// The caller never lets a launch cross a window re-extraction, where j0
// and jref change.
//
// The taps are read by direct index from the volume, which equals the TPU
// kernel's 32-way select chain exactly (each select returns a volume value
// or the neutral 0.5).  The volume's element type is a template parameter:
// float32, or bfloat16 (the TPU kernel's `cv_dtype="bfloat16"` window,
// cast at reconstruction_tpu/ops/refine_pallas.py:225 and widened at :96).
// Rounding commutes with selection, so taps of a bfloat16 volume equal the
// TPU kernel's taps of its bfloat16 window; each is widened to float32
// exactly and everything after the load is the float32 arithmetic below.
// A bfloat16 volume halves the tap bytes; shared memory does not change.
// T sweeps of one launch are bit-equal to T launches of one sweep: each
// sweep is the same per-pixel arithmetic on the same neighbour values.
//
// Numerics: the reference's op order, one IEEE operation per operator
// (--fmad=false), IEEE division, and the reference's rounding where
// XLA:CPU fuses: its exp (Cephes polynomial with fused multiply-adds,
// results below FLT_MIN flushed to zero) and one fused multiply-add in
// each blend numerator.  Neighbours outside the image read NOMATCH; only
// pixels that are valid and inside the margin box inset by one change.
#include "common.cuh"

namespace {

constexpr int K2_THREADS = 512;
constexpr int K2_PIX = 2;   // pixels a thread handles at once (taps in flight)
constexpr int K2_MAX_T = 6;  // ops/refine.py SWEEPS_PER_LAUNCH
constexpr int MINI = 32;    // window slots of the reference's mini volume
constexpr int CENTER = 16;  // slot of the window's center candidate

// float32 exp as the reference computes it (reconstruction_tpu_torch/utils/fp.py
// has the same sequence in PyTorch).
__device__ __forceinline__ float exp_xla(float x) {
  const float xx = fminf(fmaxf(x, -88.0f), 88.0f);
  const float n = floorf(__fmaf_rn(xx, 1.44269504088896341f, 0.5f));
  float r = __fmaf_rn(-n, 0.693359375f, xx);
  r = __fmaf_rn(-n, -2.12194440e-4f, r);
  const float z = r * r;
  float y = 1.9875691500e-4f;
  y = __fmaf_rn(y, r, 1.3981999507e-3f);
  y = __fmaf_rn(y, r, 8.3334519073e-3f);
  y = __fmaf_rn(y, r, 4.1665795894e-2f);
  y = __fmaf_rn(y, r, 1.6666665459e-1f);
  y = __fmaf_rn(y, r, 5.0000001201e-1f);
  y = __fmaf_rn(y, z, r) + 1.0f;
  const int e = (int)n;
  if (e < -126) return 0.0f;
  const float out = y * __int_as_float((e + 127) << 23);
  return fabsf(out) < 1.17549435e-38f ? 0.0f : out;
}

// Tap at window slot jj of a pixel whose volume column starts at cvp
// (slot k at cvp[k * W]); V is float or __nv_bfloat16, widened exactly.
template <typename V>
__device__ __forceinline__ float tap(const V* __restrict__ cvp, int j0, int jj,
                                     int S, int W) {
  const int k = j0 + jj;
  return (jj >= 0 && jj < MINI && k >= 0 && k < S)
             ? rtt_ldg_f32(cvp + (size_t)k * W)
             : 0.5f;
}

// The three parabola taps of a pixel with value dc, around its anchor
// trunc(dc - 1.5).
template <typename V>
__device__ __forceinline__ void refine_taps(float dc, const V* __restrict__ cvp,
                                            int jb, float jr, int S, int W,
                                            float xi[3]) {
  const float c0 = truncf(dc - 1.5f);
  const int j = (int)((float)CENTER + (c0 - jr));
  xi[0] = tap(cvp, jb, j - 1, S, W);
  xi[1] = tap(cvp, jb, j, S, W);
  xi[2] = tap(cvp, jb, j + 1, S, W);
}

// One sweep's update of a valid inner pixel with value dc, neighbours
// dN, dS, dW, dE and taps xi0, xi1, xi2.
__device__ __forceinline__ float refine_pixel(float dc, float dN, float dS,
                                              float dW, float dE, float xi0,
                                              float xi1, float xi2, float ws) {
  const bool mode_x = dE != RTT_NOMATCH && dW != RTT_NOMATCH;
  const bool mode_y = dS != RTT_NOMATCH && dN != RTT_NOMATCH;

  int idx = xi0 >= xi1 ? 1 : 0;
  const float xi_at = idx == 0 ? xi0 : xi1;
  if (xi_at > xi2) idx = 2;
  const float denom = (xi0 + xi2) - 2.0f * xi1;
  const float pwp1 = 0.5f * (xi0 + xi2) - xi1;
  float pdp1 = dc + (0.5f * (xi0 - xi2)) / (denom == 0.0f ? 1.0f : denom);
  if (pwp1 == 0.0f) pdp1 = 0.0f;  // the reference's quirk
  const float pwp = idx == 0 ? xi1 - xi0 : (idx == 1 ? pwp1 : xi1 - xi2);
  const float pdp = idx == 0 ? dc - 0.5f : (idx == 1 ? pdp1 : dc + 0.5f);

  const float ax = fabsf(dE - dc) - fabsf(dW - dc);
  const float ay = fabsf(dS - dc) - fabsf(dN - dc);
  const float ex = exp_xla(-(ax * ax));
  const float ey = exp_xla(-(ay * ay));
  const float wsum = ex + ey;
  const float ds_both =
      wsum == 0.0f ? (((dE + dW) + dS) + dN) * 0.25f
                   : __fmaf_rn(ex, dE + dW, ey * (dN + dS)) / (2.0f * wsum);
  const float dsv = (mode_x && mode_y)
                        ? ds_both
                        : (mode_x ? (dE + dW) * 0.5f : (dN + dS) * 0.5f);
  const float blended = __fmaf_rn(ws, dsv, pdp * pwp) / (pwp + ws);
  return (mode_x || mode_y) ? blended : dc;
}

struct Tile {
  int tx, ty;
};

// Shared memory of a (tx + 2T) x (ty + 2T) extended tile: two d buffers,
// j0, jref (4 bytes each) and inner (1).
size_t refine_smem_bytes(Tile t, int T) {
  return (size_t)(t.tx + 2 * T) * (t.ty + 2 * T) * 17;
}

template <typename V>
__global__ void __launch_bounds__(K2_THREADS, 2)
refine_sweeps_kernel(const float* __restrict__ d, float* __restrict__ out,
                     const V* __restrict__ cv, const int* __restrict__ j0,
                     const float* __restrict__ jref,
                     const uint8_t* __restrict__ inner, float ws, int H, int W,
                     int S, int T, int TX, int TY) {
  extern __shared__ __align__(16) float k2_smem[];
  const int EW = TX + 2 * T, EH = TY + 2 * T, E = EW * EH;
  float* buf0 = k2_smem;
  float* buf1 = buf0 + E;
  int* sj0 = reinterpret_cast<int*>(buf1 + E);
  float* sjref = reinterpret_cast<float*>(sj0 + E);
  uint8_t* sinner = reinterpret_cast<uint8_t*>(sjref + E);
  const int gx0 = blockIdx.x * TX - T, gy0 = blockIdx.y * TY - T;

  // The extended tile; outside the image d reads NOMATCH and never moves.
  for (int i = threadIdx.x; i < E; i += K2_THREADS) {
    const int ey = i / EW, gy = gy0 + ey, gx = gx0 + (i - ey * EW);
    float v = RTT_NOMATCH, jr = 0.0f;
    int jb = 0;
    uint8_t a = 0;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t p = (size_t)gy * W + gx;
      v = d[p];
      jb = j0[p];
      jr = jref[p];
      a = inner[p];
    }
    buf0[i] = v;
    buf1[i] = v;
    sj0[i] = jb;
    sjref[i] = jr;
    sinner[i] = a;
  }
  __syncthreads();

  // Sweep k reads buffer (k - 1) & 1 and writes the other, over the pixels
  // at least k from the extended tile's edge: their neighbours are at least
  // k - 1 from it, which sweep k - 1 wrote (or the load, for k = 1).
  for (int k = 1; k <= T; ++k) {
    const float* src = (k & 1) ? buf0 : buf1;
    float* dst = (k & 1) ? buf1 : buf0;
    const int RW = EW - 2 * k, n = RW * (EH - 2 * k);
    for (int i0 = threadIdx.x; i0 < n; i0 += K2_PIX * K2_THREADS) {
      // All taps of the thread's pixels are requested before any is used.
      int es[K2_PIX];
      bool upd[K2_PIX];
      float xi[K2_PIX][3];
#pragma unroll
      for (int u = 0; u < K2_PIX; ++u) {
        const int i = i0 + u * K2_THREADS;
        upd[u] = false;
        es[u] = -1;
        if (i < n) {
          const int ry = i / RW;
          const int ey = ry + k, ex = i - ry * RW + k;
          const int e = ey * EW + ex;
          es[u] = e;
          const float dc = src[e];
          if (sinner[e] != 0 && dc != RTT_NOMATCH) {
            upd[u] = true;
            refine_taps(dc, cv + (size_t)(gy0 + ey) * S * W + gx0 + ex,
                        sj0[e], sjref[e], S, W, xi[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < K2_PIX; ++u) {
        const int e = es[u];
        if (e < 0) continue;
        const float dc = src[e];
        dst[e] = upd[u] ? refine_pixel(dc, src[e - EW], src[e + EW],
                                       src[e - 1], src[e + 1], xi[u][0],
                                       xi[u][1], xi[u][2], ws)
                        : dc;
      }
    }
    __syncthreads();
  }

  const float* fin = (T & 1) ? buf1 : buf0;
  for (int i = threadIdx.x; i < TX * TY; i += K2_THREADS) {
    const int ty = i / TX, tx = i - ty * TX;
    const int gy = gy0 + T + ty, gx = gx0 + T + tx;
    if (gy < H && gx < W) out[(size_t)gy * W + gx] = fin[(ty + T) * EW + tx + T];
  }
}

// The largest tile, down to 32x8, that still gives two blocks per SM.
Tile refine_tile(int H, int W) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const Tile tiles[] = {{128, 32}, {128, 16}, {64, 16}, {64, 8}, {32, 8}};
  for (const Tile& t : tiles) {
    const long blocks = (long)((W + t.tx - 1) / t.tx) * ((H + t.ty - 1) / t.ty);
    if (blocks >= 2L * sms) return t;
  }
  return tiles[4];
}

template <typename V>
int refine_sweeps_launch(const void* d, void* out, const void* cv,
                         const void* j0, const void* jref, const void* inner,
                         float ws, int H, int W, int S, int T, void* stream) {
  if (T < 1 || T > K2_MAX_T) return static_cast<int>(cudaErrorInvalidValue);
  const Tile t = refine_tile(H, W);
  const size_t smem = refine_smem_bytes(t, T);
  cudaError_t err = cudaFuncSetAttribute(
      refine_sweeps_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + t.tx - 1) / t.tx, (H + t.ty - 1) / t.ty);
  refine_sweeps_kernel<V><<<grid, K2_THREADS, smem, rtt_stream(stream)>>>(
      static_cast<const float*>(d), static_cast<float*>(out),
      static_cast<const V*>(cv), static_cast<const int*>(j0),
      static_cast<const float*>(jref), static_cast<const uint8_t*>(inner), ws,
      H, W, S, T, t.tx, t.ty);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

RTT_API int rtt_refine_sweeps(const void* d, void* out, const void* cv,
                              const void* j0, const void* jref,
                              const void* inner, float ws, int H, int W,
                              int S, int T, void* stream) {
  return refine_sweeps_launch<float>(d, out, cv, j0, jref, inner, ws, H, W, S,
                                     T, stream);
}

RTT_API int rtt_refine_sweeps_bf16(const void* d, void* out, const void* cv,
                                   const void* j0, const void* jref,
                                   const void* inner, float ws, int H, int W,
                                   int S, int T, void* stream) {
  return refine_sweeps_launch<__nv_bfloat16>(d, out, cv, j0, jref, inner, ws, H,
                                             W, S, T, stream);
}
