// K1: zero-mean NCC shift sweep with a running argmax.
// K3: banded 3x3 NCC cost volume for the subpixel refine, slot-major.
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
// its clamped slot writes, with the volume laid out (H, s_cap, W).
//
// What bounds them on this card.  K1 does per output pixel and shift
// C multiplies for the product, 2r adds for each box direction and the
// score: about (2r+1)^2 C multiply-adds before the box reuse, ~6 flops
// after it, so it is bound by shared-memory traffic and synchronisation,
// not by device memory (each block reads its R rows from L2 once per
// shift).  K3 must write H*s_cap*W floats (1.26 GB at 1920x1280x128,
// ~0.38 ms at 3.35 TB/s), which makes it a device-memory write stream, as
// long as its 27 C multiply-adds per filled slot stay off the load path.
//
// What the design does about it.  K1: one block per 32x8 pixel tile; the
// block reduces its own active pixels' bounds to its own shift range (the
// reference's banded and tiled sweeps, which equal the unbanded one), so
// a wide-bound hole pixel costs only its own tile.  Per shift, the channel
// products of the tile plus an r-pixel halo go to shared memory, then the
// horizontal and vertical box sums, then the score and the strict '>'
// update in registers.  K3: one block per (2-row chunk of one band,
// up to 640 columns: up to five warps side by side, 128 columns each), so
// the band's base and filled range are the block's.  It stages once, in
// shared memory, R as int8x4 words over its rows plus one above and below
// and its columns widened by the band's filled shift range, with muR and
// invR over the same columns (plain loads, four in flight per thread, that
// convert to int8: cp.async could not convert, and staging is a few per
// cent of the block's traffic).  Each lane owns four columns and holds the
// L words of its 4x6 neighbourhood in registers.  Per filled slot it forms
// the channel products of its 6 columns in the 4 rows (one dp4a each),
// the 3-column sums, the 3-row sums and the scores of its 2x4 outputs,
// and writes each row with one 16-byte store: a block writes 2.5 KB of a
// (row, slot) line at once.  Shared-memory rows that lanes read at
// stride 4 are skewed by one word per 32, so those reads are free of bank
// conflicts; their pitches are fixed (s_cap <= 128), so a column's rows
// are immediate offsets.  Unfilled slots get 0.5.  What still holds it
// back is the store stream itself: the same launch with nothing to fill
// takes ~1.3 times a plain fill of the volume (chip_smoke.py's K3
// yardsticks).
//
// Exactness.  Images are centered uint8 values, so the products and box
// sums are integers below 2^24 and exact in any order: K1 sums them in
// float in the reference's order, K3 in int32 (dp4a) and converts once;
// both equal the reference.  K3 checks every image value it reads as it
// converts it and sets a flag for one off that grid, on which its wrapper
// raises: no pass of its own over the images.
// The score follows the reference as XLA:CPU compiles it: fma(-(n*muL),
// muR, cross) * invL * invR for K1, and xi = fma(-(a*0.5), invR, 0.5) with
// a = fma(-(n*muL), muR, cross) * invL for K3 (XLA distributes
// (1 - ncc)*0.5); K3 multiplies by invL*0.5 instead, which is the same
// float because halving is exact (no operand or product here is
// subnormal).  Padding at the image's columns is the reference's:
// muR 0, invR 1, validR 0.
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

constexpr int K3_WX = 128;     // columns per warp, 4 per lane
constexpr int K3_MAX_NX = 5;   // warps side by side along x in a block
constexpr int K3_TX = K3_WX * K3_MAX_NX;
constexpr int K3_TY = 2;       // output rows per block (and per warp)
constexpr int K3_MAX_S = 128;  // slots; a band's filled range spans <= S shifts
constexpr int K3_BATCH = 4;    // staging loads a thread keeps in flight

// Shared-memory word index of column c in a skewed row: one pad word per
// 32, so that lanes reading columns 4*lane + k hit 32 different banks.
__device__ __forceinline__ int skew(int c) { return c + (c >> 5); }

__host__ __device__ constexpr int skewed_pitch(int n) {
  return (n + (n - 1) / 32 + 3) & ~3;  // skew(n - 1) + 1, rounded up to 4
}

// Row pitches (words) of the staged R words and of muR, invR: fixed, so
// that a lane's loads of one column in successive rows are one address
// plus immediate offsets.
constexpr int K3_RP = skewed_pitch(K3_TX + 2 + K3_MAX_S - 1);
constexpr int K3_MP = skewed_pitch(K3_TX + K3_MAX_S - 1);
constexpr int K3_SMEM_WORDS =
    (K3_TY + 2) * K3_RP + 2 * K3_TY * K3_MP + 2 * K3_TY * K3_TX;

// Channels of pixel (y, x) packed as int8x4 (zero padded), 0 outside the
// image (the reference's zero padding).  Centered uint8 values are exact;
// any other value (a fraction, out of [-128, 127], NaN) sets ``bad``.
__device__ __forceinline__ int pack_px(const float* __restrict__ img, int y,
                                       int x, int H, int W, int C, bool& bad) {
  if (y < 0 || y >= H || x < 0 || x >= W) return 0;
  const float* p = img + ((size_t)y * W + x) * C;
  unsigned w = 0;
  for (int c = 0; c < C; ++c) {
    const float v = p[c];
    bad |= !(v == rintf(v) && v >= -128.0f && v <= 127.0f);
    w |= ((unsigned)__float2int_rn(v) & 0xffu) << (8 * c);
  }
  return (int)w;
}

// for i in [0, n) over the block's threads: v = load(i), then store(i, v),
// K3_BATCH loads of each thread in flight at a time.
template <typename Load, typename Store>
__device__ __forceinline__ void stage(int n, Load load, Store store) {
  const int nt = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += K3_BATCH * nt) {
    decltype(load(0)) v[K3_BATCH];
#pragma unroll
    for (int u = 0; u < K3_BATCH; ++u)
      if (i0 + u * nt < n) v[u] = load(i0 + u * nt);
#pragma unroll
    for (int u = 0; u < K3_BATCH; ++u)
      if (i0 + u * nt < n) store(i0 + u * nt, v[u]);
  }
}

__device__ __forceinline__ void store4(float* __restrict__ row, int x, int W,
                                       float4 v) {
  if ((W & 3) == 0 && x + 3 < W) {
    *reinterpret_cast<float4*>(row + x) = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
    for (int q = 0; q < 4 && x + q < W; ++q) row[x + q] = e[q];
  }
}

__global__ void __launch_bounds__(32 * K3_MAX_NX)
cost_volume_kernel(const float* __restrict__ L, const float* __restrict__ R,
                   const float* __restrict__ nmuL,
                   const float* __restrict__ invL,
                   const float* __restrict__ muR,
                   const float* __restrict__ invR,
                   const int* __restrict__ base_b,
                   const int* __restrict__ lo_b,
                   const int* __restrict__ hi_b, float* __restrict__ cv,
                   int* __restrict__ off_grid, int H, int W, int C, int S,
                   int band, int chunks) {
  extern __shared__ __align__(16) int k3_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y / chunks;
  const int y0 = b * band + (blockIdx.y % chunks) * K3_TY;
  const int y1 = min(min(y0 + K3_TY, (b + 1) * band), H);  // rows [y0, y1)
  const int tx = K3_WX * (blockDim.x >> 5);   // the block's columns
  const int x0 = blockIdx.x * tx;
  const int xq = K3_WX * warp + 4 * lane;     // the lane's first column - x0
  const int base = base_b[b], lo = lo_b[b], hi = hi_b[b];
  const bool any = hi >= lo;
  const int span = any ? hi - lo : 0;      // < S
  // sR: int8x4 R over rows y0-1..y0+TY, columns x0-1+lo .. x0+tx+hi.
  // sMu, sInv: muR, invR over rows y0..y0+TY-1, columns x0+lo .. x0+tx-1+hi.
  // sNmu, sInvL: the block's own -nmuL and invL / 2 (both exact).
  int* sR = k3_smem;
  float* sMu = reinterpret_cast<float*>(sR + (K3_TY + 2) * K3_RP);
  float* sInv = sMu + K3_TY * K3_MP;
  float* sNmu = sInv + K3_TY * K3_MP;
  float* sInvL = sNmu + K3_TY * K3_TX;

  int lw[K3_TY + 2][6];  // int8x4 L at the lane's rows and columns -1..4
  if (any) {
    bool bad = false;  // a value read off the integer grid
    const int RW = tx + 2 + span, MW = tx + span;
    stage(
        (K3_TY + 2) * RW,
        [&](int i) {
          const int r = i / RW;
          return pack_px(R, y0 - 1 + r, x0 - 1 + lo + i - r * RW, H, W, C,
                         bad);
        },
        [&](int i, int v) {
          const int r = i / RW;
          sR[r * K3_RP + skew(i - r * RW)] = v;
        });
    stage(
        K3_TY * MW,
        [&](int i) {
          const int r = i / MW, y = y0 + r, t = x0 + lo + i - r * MW;
          const bool in = y < y1 && t >= 0 && t < W;
          return make_float2(in ? muR[(size_t)y * W + t] : 0.0f,
                             in ? invR[(size_t)y * W + t] : 1.0f);
        },
        [&](int i, float2 v) {
          const int r = i / MW, m = r * K3_MP + skew(i - r * MW);
          sMu[m] = v.x;
          sInv[m] = v.y;
        });
    stage(
        K3_TY * tx,
        [&](int i) {
          const int r = i / tx, y = y0 + r, x = x0 + i - r * tx;
          const bool in = y < y1 && x < W;
          return make_float2(in ? nmuL[(size_t)y * W + x] : 0.0f,
                             in ? invL[(size_t)y * W + x] : 1.0f);
        },
        [&](int i, float2 v) {
          const int r = i / tx, m = r * K3_TX + i - r * tx;
          sNmu[m] = -v.x;
          sInvL[m] = v.y * 0.5f;
        });
#pragma unroll
    for (int r = 0; r < K3_TY + 2; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k)
        lw[r][k] = pack_px(L, y0 - 1 + r, x0 + xq - 1 + k, H, W, C, bad);
    if (bad) *off_grid = 1;
    __syncthreads();
  }

  for (int j = 0; j < S; ++j) {
    // The reference writes shift s at slot clamp(s - base, 0, S - 1), in
    // ascending s, so slot j holds the largest such s in [lo, hi].  Inside
    // (0, S - 1) that is base + j; the edge slots also take shifts past
    // them, which happens only when the band's range lies wholly beyond its
    // slots.
    int s;
    bool has;
    if (j == S - 1) {
      s = hi;
      has = hi >= lo && (j == 0 || hi - base >= S - 1);
    } else {
      s = min(hi, base + j);
      has = s >= lo && (j == 0 || s == base + j);
    }
    float4 out[K3_TY];
    if (has) {
      const int so = s - lo;
      // acc[i][q]: the 3x3 box sum of the channel products at the warp's
      // row i and column xq + q, built from the horizontal 3-sums of the
      // product rows; exact integers.
      int acc[K3_TY][4];
#pragma unroll
      for (int r = 0; r < K3_TY + 2; ++r) {
        int p[6];
#pragma unroll
        for (int k = 0; k < 6; ++k)
          p[k] = __dp4a(lw[r][k], sR[r * K3_RP + skew(xq + k + so)], 0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = p[q] + p[q + 1] + p[q + 2];
#pragma unroll
          for (int i = 0; i < K3_TY; ++i) {
            if (r == i) acc[i][q] = h;
            if (r == i + 1 || r == i + 2) acc[i][q] += h;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < K3_TY; ++i) {
        const float4 nm = *reinterpret_cast<const float4*>(sNmu + i * K3_TX + xq);
        const float4 il = *reinterpret_cast<const float4*>(sInvL + i * K3_TX + xq);
        const float nmv[4] = {nm.x, nm.y, nm.z, nm.w};
        const float ilv[4] = {il.x, il.y, il.z, il.w};
        float o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // a * 0.5 with a = fma(-(n muL), muR, cross) * invL, then
          // fma(-(a * 0.5), invR, 0.5): halving is exact, so it moves into
          // invL.
          const int m = i * K3_MP + skew(xq + q + so);
          const float ah = __fmul_rn(__fmaf_rn(nmv[q], sMu[m], (float)acc[i][q]),
                                     ilv[q]);
          o[q] = __fmaf_rn(-ah, sInv[m], 0.5f);
        }
        out[i] = make_float4(o[0], o[1], o[2], o[3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < K3_TY; ++i) out[i] = make_float4(0.5f, 0.5f, 0.5f, 0.5f);
    }
#pragma unroll
    for (int i = 0; i < K3_TY; ++i) {
      const int y = y0 + i;
      if (y < y1 && x0 + xq < W)
        store4(cv + ((size_t)y * S + j) * W, x0 + xq, W, out[i]);
    }
  }
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
                            void* off_grid, int H, int W, int C, int S,
                            int band, void* stream) {
  if (C < 1 || C > 4 || S < 1 || S > K3_MAX_S)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int) * K3_SMEM_WORDS;
  cudaError_t err = cudaFuncSetAttribute(
      cost_volume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // Warps side by side along x, as few blocks per row as K3_MAX_NX
  // allows, the row's 128-column tiles split evenly among them.
  const int tiles = (W + K3_WX - 1) / K3_WX;
  const int bx = (tiles + K3_MAX_NX - 1) / K3_MAX_NX;
  const int nx = (tiles + bx - 1) / bx;
  const int nb = (H + band - 1) / band;
  const int chunks = (band + K3_TY - 1) / K3_TY;
  const dim3 grid((W + K3_WX * nx - 1) / (K3_WX * nx), nb * chunks);
  cost_volume_kernel<<<grid, 32 * nx, smem, rtt_stream(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const float*>(nmuL), static_cast<const float*>(invL),
      static_cast<const float*>(muR), static_cast<const float*>(invR),
      static_cast<const int*>(base_b), static_cast<const int*>(lo_b),
      static_cast<const int*>(hi_b), static_cast<float*>(cv),
      static_cast<int*>(off_grid), H, W, C, S, band, chunks);
  return static_cast<int>(cudaGetLastError());
}
