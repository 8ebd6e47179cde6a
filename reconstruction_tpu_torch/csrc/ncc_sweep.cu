// K1: zero-mean NCC shift sweep with a running argmax.
// K3: banded 3x3 NCC cost volume for the subpixel refine.
//
// K1 replaces the TPU kernel `_sweep_kernel`
// (reconstruction_tpu/ops/ncc_sweep_pallas.py:48, launched by
// `ncc_sweep_match_pallas`) and the XLA shift loop of
// `reconstruction_tpu/stereo/matching.py::ncc_sweep_match`, which brute,
// guided and rematch all reduce to.  Semantics are the unbanded XLA
// sweep's, without the Pallas kernel's +-128 shift clip.
//
// K3 replaces the XLA band loop of
// `reconstruction_tpu/stereo/refine.py::_banded_cost_volume`, including
// its clamped slot writes.
//
// What bounds them on this card.  K1 does per output pixel and shift
// C multiplies for the product, 2r adds for each box direction and the
// score: about (2r+1)^2 C multiply-adds before the box reuse, ~6 flops
// after it, so it is bound by shared-memory traffic and synchronisation,
// not by device memory (each block reads its R rows from L2 once per
// shift).  K3 writes H*W*s_cap floats (1.26 GB at 1920x1280x128), which
// makes it a device-memory write stream; its 27 multiply-adds per slot
// come out of L1/L2.
//
// What the design does about it.  K1: one block per 32x8 pixel tile; the
// block reduces its own active pixels' bounds to its own shift range (the
// reference's banded and tiled sweeps, which equal the unbanded one), so
// a wide-bound hole pixel costs only its own tile.  Per shift, the channel
// products of the tile plus an r-pixel halo go to shared memory, then the
// horizontal and vertical box sums, then the score and the strict '>'
// update in registers.  K3: one thread per (pixel, slot) with the slot
// index fastest, so the dominant write is fully coalesced.
//
// Exactness.  Images are centered uint8 values, so the products and box
// sums are integers below 2^24 and exact in any order; they are still
// summed in the reference's order.  The score follows the reference as
// XLA:CPU compiles it: fma(-(n*muL), muR, cross) * invL * invR for K1,
// and xi = fma(-(a*0.5), invR, 0.5) with a = fma(-(n*muL), muR, cross) *
// invL for K3 (XLA distributes (1 - ncc)*0.5).  Padding at the image's
// columns is the reference's: muR 0, invR 1, validR 0.
#include <climits>

#include "common.cuh"

namespace {

constexpr int K1_TX = 32;
constexpr int K1_TY = 8;
constexpr int K1_THREADS = K1_TX * K1_TY;

__global__ void __launch_bounds__(K1_THREADS)
ncc_sweep_kernel(const float* __restrict__ L, const float* __restrict__ R,
                 const float* __restrict__ nmuL,
                 const float* __restrict__ invL,
                 const float* __restrict__ muR,
                 const float* __restrict__ invR,
                 const uint8_t* __restrict__ validR,
                 const uint8_t* __restrict__ active,
                 const int* __restrict__ lo, const int* __restrict__ hi,
                 float* __restrict__ score, int* __restrict__ tbest,
                 int H, int W, int C, int r) {
  extern __shared__ float smem[];
  const int PW = K1_TX + 2 * r;
  const int PH = K1_TY + 2 * r;
  float* sL = smem;                  // PH*PW*C: left tile + halo, 0 outside
  float* sP = sL + PH * PW * C;      // PH*PW: channel products at shift s
  float* sH = sP + PH * PW;          // PH*TX: horizontal box sums
  __shared__ int s_lo, s_hi;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * K1_TX + tx;
  const int x0 = blockIdx.x * K1_TX, y0 = blockIdx.y * K1_TY;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const size_t pix = (size_t)y * W + x;

  for (int i = tid; i < PH * PW; i += K1_THREADS) {
    const int gy = y0 - r + i / PW, gx = x0 - r + i % PW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    for (int c = 0; c < C; ++c)
      sL[i * C + c] = in ? L[((size_t)gy * W + gx) * C + c] : 0.0f;
  }
  bool act = false;
  int plo = 0, phi = -1;
  float nmu = 0.0f, invl = 1.0f;
  if (inside) {
    act = active[pix] != 0;
    plo = lo[pix];
    phi = hi[pix];
    nmu = nmuL[pix];
    invl = invL[pix];
  }
  if (tid == 0) {
    s_lo = INT_MAX;
    s_hi = INT_MIN;
  }
  __syncthreads();
  if (act) {
    atomicMin(&s_lo, plo - x);
    atomicMax(&s_hi, phi - x);
  }
  __syncthreads();
  // The reference clips its sweep range to +-(W-1); shifts beyond a
  // pixel's own bounds never update it, so a per-tile range is exact.
  const int s_min = min(max(s_lo, -(W - 1)), W - 1);
  const int s_max = max(min(s_hi, W - 1), -(W - 1));

  float best = -1.0f;
  int bt = -1;
  for (int s = s_min; s <= s_max; ++s) {
    for (int i = tid; i < PH * PW; i += K1_THREADS) {
      const int gy = y0 - r + i / PW, gx = x0 - r + i % PW;
      const int rx = gx + s;
      float p = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && rx >= 0 && rx < W) {
        const float* rp = R + ((size_t)gy * W + rx) * C;
        const float* lp = sL + i * C;
        p = __fmul_rn(lp[0], rp[0]);
        for (int c = 1; c < C; ++c) p = __fadd_rn(p, __fmul_rn(lp[c], rp[c]));
      }
      sP[i] = p;
    }
    __syncthreads();
    for (int i = tid; i < PH * K1_TX; i += K1_THREADS) {
      const float* row = sP + (i / K1_TX) * PW + (i % K1_TX) + r;
      float h = row[0];
      for (int d = 1; d <= r; ++d) h = __fadd_rn(__fadd_rn(h, row[d]), row[-d]);
      sH[i] = h;
    }
    __syncthreads();
    if (act) {
      const float* col = sH + (ty + r) * K1_TX + tx;
      float cross = col[0];
      for (int d = 1; d <= r; ++d)
        cross = __fadd_rn(__fadd_rn(cross, col[d * K1_TX]), col[-d * K1_TX]);
      const int t = x + s;
      if (t >= plo && t <= phi && t >= 0 && t < W &&
          validR[(size_t)y * W + t] != 0) {
        const size_t q = (size_t)y * W + t;
        const float sc = rtt_ncc_score(cross, nmu, muR[q], invl, invR[q]);
        if (sc > best) {  // strict: the first maximum wins
          best = sc;
          bt = t;
        }
      }
    }
    __syncthreads();  // sP and sH are rewritten at the next shift
  }
  if (inside) {
    score[pix] = best;
    tbest[pix] = bt;
  }
}

constexpr int K3_THREADS = 256;

__global__ void __launch_bounds__(K3_THREADS)
cost_volume_kernel(const float* __restrict__ L, const float* __restrict__ R,
                   const float* __restrict__ nmuL,
                   const float* __restrict__ invL,
                   const float* __restrict__ muR,
                   const float* __restrict__ invR,
                   const int* __restrict__ base_b,
                   const int* __restrict__ lo_b,
                   const int* __restrict__ hi_b, float* __restrict__ cv,
                   int H, int W, int C, int S, int band) {
  const size_t idx = (size_t)blockIdx.x * K3_THREADS + threadIdx.x;
  if (idx >= (size_t)H * W * S) return;
  const int j = (int)(idx % S);
  const size_t pix = idx / S;
  const int x = (int)(pix % W), y = (int)(pix / W);
  const int b = y / band;
  const int base = base_b[b], lo = lo_b[b], hi = hi_b[b];
  // The reference writes shift s at slot clamp(s - base, 0, S - 1), in
  // ascending s, so slot j holds the largest such s in [lo, hi].  Inside
  // (0, S - 1) that is base + j; the edge slots also take shifts past them,
  // which happens only when the band's range lies wholly beyond its slots.
  int s;
  bool has;
  if (j == S - 1) {
    s = hi;
    has = hi >= lo && (j == 0 || hi - base >= S - 1);
  } else {
    s = min(hi, base + j);
    has = s >= lo && (j == 0 || s == base + j);
  }
  float xi = 0.5f;
  if (has) {
    const int off[3] = {0, 1, -1};  // the reference's box order
    float bx[3];
    for (int k = 0; k < 3; ++k) {
      const int yy = y + off[k];
      float p[3];
      for (int m = 0; m < 3; ++m) {
        const int xx = x + off[m], rx = xx + s;
        float v = 0.0f;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W && rx >= 0 && rx < W) {
          const float* lp = L + ((size_t)yy * W + xx) * C;
          const float* rp = R + ((size_t)yy * W + rx) * C;
          v = __fmul_rn(lp[0], rp[0]);
          for (int c = 1; c < C; ++c) v = __fadd_rn(v, __fmul_rn(lp[c], rp[c]));
        }
        p[m] = v;
      }
      bx[k] = __fadd_rn(__fadd_rn(p[0], p[1]), p[2]);
    }
    const float cross = __fadd_rn(__fadd_rn(bx[0], bx[1]), bx[2]);
    const int t = x + s;
    const bool tin = t >= 0 && t < W;
    const float muRs = tin ? muR[(size_t)y * W + t] : 0.0f;
    const float invRs = tin ? invR[(size_t)y * W + t] : 1.0f;
    const float a = __fmul_rn(__fmaf_rn(-nmuL[pix], muRs, cross), invL[pix]);
    xi = __fmaf_rn(-__fmul_rn(a, 0.5f), invRs, 0.5f);
  }
  cv[idx] = xi;
}

}  // namespace

RTT_API const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

RTT_API int rtt_ncc_sweep(const void* L, const void* R, const void* nmuL,
                          const void* invL, const void* muR, const void* invR,
                          const void* validR, const void* active,
                          const void* lo, const void* hi, void* score,
                          void* tbest, int H, int W, int C, int r,
                          void* stream) {
  const dim3 block(K1_TX, K1_TY);
  const dim3 grid((W + K1_TX - 1) / K1_TX, (H + K1_TY - 1) / K1_TY);
  const int PW = K1_TX + 2 * r, PH = K1_TY + 2 * r;
  const size_t smem = sizeof(float) * ((size_t)PH * PW * C + PH * PW + PH * K1_TX);
  ncc_sweep_kernel<<<grid, block, smem, rtt_stream(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const float*>(nmuL), static_cast<const float*>(invL),
      static_cast<const float*>(muR), static_cast<const float*>(invR),
      static_cast<const uint8_t*>(validR), static_cast<const uint8_t*>(active),
      static_cast<const int*>(lo), static_cast<const int*>(hi),
      static_cast<float*>(score), static_cast<int*>(tbest), H, W, C, r);
  return static_cast<int>(cudaGetLastError());
}

RTT_API int rtt_cost_volume(const void* L, const void* R, const void* nmuL,
                            const void* invL, const void* muR,
                            const void* invR, const void* base_b,
                            const void* lo_b, const void* hi_b, void* cv,
                            int H, int W, int C, int S, int band,
                            void* stream) {
  const size_t total = (size_t)H * W * S;
  const unsigned grid = (unsigned)((total + K3_THREADS - 1) / K3_THREADS);
  cost_volume_kernel<<<grid, K3_THREADS, 0, rtt_stream(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const float*>(nmuL), static_cast<const float*>(invL),
      static_cast<const float*>(muR), static_cast<const float*>(invR),
      static_cast<const int*>(base_b), static_cast<const int*>(lo_b),
      static_cast<const int*>(hi_b), static_cast<float*>(cv), H, W, C, S,
      band);
  return static_cast<int>(cudaGetLastError());
}
