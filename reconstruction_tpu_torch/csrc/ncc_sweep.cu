// K1: zero-mean NCC shift sweep with a running argmax.
// K3: banded 3x3 NCC cost volume for the subpixel refine, slot-major.
//
// K1 replaces the TPU kernel `_sweep_kernel`
// (reconstruction_tpu/ops/ncc_sweep_pallas.py:48, launched by
// `ncc_sweep_match_pallas`) and the XLA shift loop of
// `reconstruction_tpu/stereo/matching.py::ncc_sweep_match`, which brute,
// guided and rematch all reduce to.  Semantics are the unbanded XLA
// sweep's, without the Pallas kernel's +-128 shift clip: each pixel is
// gated by `active`, its own [lo, hi] (clipped to the image's columns) and
// validR at the target, and a strict '>' over ascending targets keeps the
// first maximum.
//
// K3 replaces the XLA band loop of
// `reconstruction_tpu/stereo/refine.py::_banded_cost_volume`, including
// its clamped slot writes, with the volume laid out (H, s_cap, W).
//
// What bounds K1 on this card.  Not bytes: the 64-shift cell's inputs move
// in 0.04 ms.  Its work is ~20 integer and float operations a (pixel,
// shift) pair on the CUDA cores, and on the main path a launch lasts as
// long as its slowest block: guided and rematch bounds give hole pixels
// ranges up to ~1,000 targets wide beside pixels that score 5, and a block
// that sweeps such a range one shift at a time holds the whole launch
// (chip_smoke.py's per-launch table).
//
// What the K1 design does about it.  A block covers 120 x 16 outputs (112
// for r = 3) with 8 warps.  Per chunk of its range it stages, in shared
// memory, L and R as int8x4 words over its rows +-r and the columns the
// chunk reaches, and muR and invR over the same targets (invR NaN where the
// target is invalid or outside the image, so its score never wins); the
// loops below read nothing from device memory and cross no barrier.  Two
// modes, chosen per block, uniformly:
//  - sweep (shift outer): a lane owns two adjacent columns of a warp's 4
//    output rows and keeps their L words and state in registers.  Per shift
//    it forms 16 dp4a products, a running column sum down its rows, the box
//    sums with 4 shuffles (its neighbours' column sums), and scores its 8
//    outputs.  R's words and moments at a column serve the lane's two
//    columns one shift apart, so a shift loads one new column.  Each warp
//    sweeps its own union of shifts.
//  - candidate (pixel outer): each active pixel's targets are cut into
//    items of 17 (odd, so that lanes on neighbouring items read apart in
//    the banks), spread over the block's 256 threads, so a wide hole does
//    not hold up a warp.  An item sums each (2r+1)^2 window directly, one
//    dp4a a tap (the C <= 4 channels share a word), from a ring of R words
//    in registers; items merge per pixel with one 64-bit atomicMax on
//    (score, -target), which is the first maximum.
// The rule.  A sweep block takes as long as its longest warp, whose steps
// are latency-bound (~1,000 cycles a shift); candidate mode costs ~3 times
// a sweep slot for each pair it scores, spread over the block, plus ~26k
// cycles to stage each chunk, the time of ~32 sweep shifts (cycles per
// block and phase: tools/k1_phase_clocks.py).  So a block takes candidate
// mode when 256 slots x 8 warps x (its longest warp's shift span - 32)
// exceeds 3 times its useful pairs (K1_CAND_RATIO, K1_CAND_SPAN0;
// `ops/ncc_sweep.sweep_plan` mirrors the rule for measurements).
//
// What bounds K3.  It must write H*s_cap*W floats (1.26 GB at
// 1920x1280x128, ~0.38 ms at 3.35 TB/s; half of that in bfloat16, the TPU
// refine's `cv_dtype="bfloat16"`, whose cast at
// reconstruction_tpu/ops/refine_pallas.py:225 K3 performs as it stores),
// which makes it a device-memory write stream, as long as its 27 C
// multiply-adds per filled slot stay off the load path.  K3's design: one block per (2-row chunk of one band, up
// to 640 columns: up to five warps side by side, 128 columns each), so the
// band's base and filled range are the block's.  It stages once, in shared
// memory, R as int8x4 words over its rows plus one above and below and its
// columns widened by the band's filled shift range, with muR and invR over
// the same columns (plain loads, four in flight per thread, that convert to
// int8: cp.async could not convert, and staging is a few per cent of the
// block's traffic).  Each lane owns four columns and holds the L words of
// its 4x6 neighbourhood in registers.  Per filled slot it forms the channel
// products of its 6 columns in the 4 rows (one dp4a each), the 3-column
// sums, the 3-row sums and the scores of its 2x4 outputs, and writes each
// row with one 16-byte store: a block writes 2.5 KB of a (row, slot) line
// at once.  Shared-memory rows that lanes read at stride 4 are skewed by
// one word per 32, so those reads are free of bank conflicts; their pitches
// are fixed (s_cap <= 128), so a column's rows are immediate offsets.
// Unfilled slots get 0.5.  What still holds it back is the store stream
// itself: the same launch with nothing to fill takes ~1.3 times a plain
// fill of the volume (chip_smoke.py's K3 yardsticks).  The volume's
// element type is a template parameter: float32, or bfloat16 rounded from
// the same float32 score at the store (8-byte stores; 0.5 is exact).
//
// Exactness.  Images are centered uint8 values, so the products and box
// sums are integers below 2^22 and exact in any order: K1 and K3 sum them
// in int32 (dp4a) and convert each sum to float once, exactly; both equal
// the reference's float sums.  Both check every image value they read
// as they pack it and set a flag for one off that grid, on which their
// wrappers raise: no pass of their own over the images.
// The score follows the reference as XLA:CPU compiles it: fma(-(n*muL),
// muR, cross) * invL * invR for K1 (rtt_ncc_score), and xi = fma(-(a*0.5),
// invR, 0.5) with a = fma(-(n*muL), muR, cross) * invL for K3 (XLA
// distributes (1 - ncc)*0.5); K3 multiplies by invL*0.5 instead, which is
// the same float because halving is exact (no operand or product here is
// subnormal).  Padding at the image's columns is the reference's: muR 0,
// invR 1, validR 0.  K1's merge orders +0 and -0 alike, as '>' does, and a
// winning zero takes the sign of its own recomputed score.
#include <climits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

constexpr unsigned K1_FULL = 0xffffffffu;
constexpr int K1_TYW = 4;          // output rows per warp
constexpr int K1_NWX = 2;          // warps side by side in a block
constexpr int K1_NWY = 4;          // warps stacked in a block
constexpr int K1_NW = K1_NWX * K1_NWY;
constexpr int K1_THREADS = 32 * K1_NW;
constexpr int K1_BY = K1_TYW * K1_NWY;   // output rows per block
constexpr int K1_BLOCKS_PER_SM = 512 / K1_THREADS;   // 16 warps an SM
constexpr int K1_SC = 128;         // shifts per staged chunk (sweep mode)
constexpr int K1_SEG = 17;         // targets per work item (candidate mode; odd)
constexpr int K1_CAND_RATIO = 3;   // candidate mode: union pairs > 3 x useful
constexpr int K1_CAND_SPAN0 = 32;  // ... the union counted from 32 shifts on
constexpr int K1_INACTIVE = 1 << 30;

// Block geometry for window radius R.  A lane owns two adjacent columns;
// HL lanes at each end of a warp only lend their column sums to their
// neighbours, so a warp writes WOUT columns.
template <int R>
struct K1Tile {
  static constexpr int HL = (R + 1) / 2;
  static constexpr int WOUT = 2 * (32 - 2 * HL);
  static constexpr int BX = K1_NWX * WOUT;            // output columns per block
  static constexpr int NPIX = BX * K1_BY;
  static constexpr int PPT = (NPIX + K1_THREADS - 1) / K1_THREADS;
  static constexpr int NSLOT = PPT * K1_THREADS;
  static constexpr int NK = K1_TYW + 2 * R;           // product rows of a warp
  static constexpr int ROWS = K1_BY + 2 * R;          // staged rows of L and R
  static constexpr int LW = BX + 4 * HL;              // staged L columns
  static constexpr int RWID = LW + K1_SC - 1;         // staged R / moment columns
  static constexpr int TSPAN = RWID - 4 * HL;         // targets of a candidate chunk
  static constexpr int HALF = (RWID + 1) / 2;         // even columns, then odd
  static constexpr int RP = 2 * HALF;                 // row pitch (words)
  static constexpr size_t SM_M = sizeof(float2) * K1_BY * RP;
  static constexpr size_t SM_KEY = sizeof(unsigned long long) * NPIX;
  static constexpr size_t SM_R = sizeof(int) * ROWS * RP;
  static constexpr size_t SM_L = sizeof(int) * ROWS * LW;
  static constexpr size_t SM_PRE = sizeof(int) * (NSLOT + 1);
  static constexpr size_t SMEM = SM_M + SM_KEY + SM_R + SM_L + SM_PRE + NPIX;
};

// Staged rows keep even columns first, then odd ones: lanes that read
// columns 2*lane + j then hit 32 consecutive words.
template <int R>
__device__ __forceinline__ int k1_sidx(int j) {
  return (j & 1) * K1Tile<R>::HALF + (j >> 1);
}

// Candidate mode merges the pixels' work items with one 64-bit atomicMax:
// the score's order (+0 and -0 alike), then the smaller target.
__device__ __forceinline__ unsigned long long k1_key(float sc, int t) {
  unsigned u = __float_as_uint(sc);
  if ((u << 1) == 0) u = 0;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(INT_MAX - t);
}

__device__ __forceinline__ float k1_key_score(unsigned long long k) {
  const unsigned u = (unsigned)(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int k1_key_t(unsigned long long k) {
  return INT_MAX - (int)(unsigned)(k & 0xffffffffu);
}

// Exclusive prefix sum of v over the block; ``total`` gets the sum.
__device__ __forceinline__ int k1_block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(K1_FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < K1_NW ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < K1_NW; o <<= 1) {
      const int y = __shfl_up_sync(K1_FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < K1_NW) s_warp[lane] = w;
  }
  __syncthreads();
  total = s_warp[K1_NW - 1];
  return (warp ? s_warp[warp - 1] : 0) + x - v;
}

// Candidate mode's window of one pixel: its L words and a ring of R words,
// column c of R in slot (c - ta + R) mod (2R+1).
template <int R>
struct K1Window {
  static constexpr int D = 2 * R + 1;
  int lw[D][D], rw[D][D];
};

// Target t = ta + U (mod 2R+1): load its new column of R words, sum the
// window (one dp4a a tap: the C channels share a word; one accumulator a
// row, so the rows' chains run side by side), score, and keep the first
// maximum.  U is a constant, so every ring slot is a register.
template <int R, int U>
__device__ __forceinline__ void k1_target(K1Window<R>& w, const int* __restrict__ sR,
                                          const float2* __restrict__ sM, int iy,
                                          int RB, int t, float nmu, float invl,
                                          float& best, int& bt) {
  using G = K1Tile<R>;
  constexpr int D = K1Window<R>::D;
  const int o = k1_sidx<R>(t + R - RB);
#pragma unroll
  for (int dy = 0; dy < D; ++dy) w.rw[dy][(U + D - 1) % D] = sR[(iy + dy) * G::RP + o];
  int acc = 0;
#pragma unroll
  for (int dy = 0; dy < D; ++dy) {
    int row = 0;
#pragma unroll
    for (int dx = 0; dx < D; ++dx) row = __dp4a(w.lw[dy][dx], w.rw[dy][(U + dx) % D], row);
    acc += row;
  }
  const float2 m = sM[iy * G::RP + k1_sidx<R>(t - RB)];
  const float sc = rtt_ncc_score(rtt_small_int_to_float(acc), nmu, m.x, invl, m.y);
  if (sc > best) {  // strict: the first maximum wins
    best = sc;
    bt = t;
  }
}

// Targets t0 + U .. t0 + D - 1 with no branch (a whole round from U = 0),
// or, in the tail, up to tb.
template <int R, int U, bool TAIL>
__device__ __forceinline__ void k1_round(K1Window<R>& w, const int* __restrict__ sR,
                                         const float2* __restrict__ sM, int iy,
                                         int RB, int t0, int tb, float nmu,
                                         float invl, float& best, int& bt) {
  if constexpr (U < K1Window<R>::D) {
    if (TAIL && t0 + U > tb) return;
    k1_target<R, U>(w, sR, sM, iy, RB, t0 + U, nmu, invl, best, bt);
    k1_round<R, U + 1, TAIL>(w, sR, sM, iy, RB, t0, tb, nmu, invl, best, bt);
  }
}

// Candidate mode: pixel (iy, ix) of the block scored at targets ta..tb,
// ascending, with the direct (2R+1)^2 window sum; best and bt keep the
// first maximum.  Whole rounds of 2R+1 targets run without a branch, so
// that their window sums overlap.
template <int R>
__device__ __forceinline__ void k1_candidates(
    const int* __restrict__ sL, const int* __restrict__ sR,
    const float2* __restrict__ sM, int iy, int ix, int RB, int ta, int tb,
    float nmu, float invl, float& best, int& bt) {
  using G = K1Tile<R>;
  constexpr int D = K1Window<R>::D;
  K1Window<R> w;
#pragma unroll
  for (int dy = 0; dy < D; ++dy) {
#pragma unroll
    for (int dx = 0; dx < D; ++dx)
      w.lw[dy][dx] = sL[(iy + dy) * G::LW + ix + 2 * G::HL - R + dx];
#pragma unroll
    for (int k = 0; k < D - 1; ++k)
      w.rw[dy][k] = sR[(iy + dy) * G::RP + k1_sidx<R>(ta - R + k - RB)];
  }
  int t0 = ta;
  for (; t0 + D - 1 <= tb; t0 += D)
    k1_round<R, 0, false>(w, sR, sM, iy, RB, t0, tb, nmu, invl, best, bt);
  k1_round<R, 0, true>(w, sR, sM, iy, RB, t0, tb, nmu, invl, best, bt);
}

template <int R>
__global__ void __launch_bounds__(K1_THREADS, K1_BLOCKS_PER_SM)
ncc_sweep_kernel(const float* __restrict__ L, const float* __restrict__ Rim,
                 const float* __restrict__ nmuL,
                 const float* __restrict__ invL,
                 const float* __restrict__ muR,
                 const float* __restrict__ invR,
                 const uint8_t* __restrict__ validR,
                 const uint8_t* __restrict__ active,
                 const int* __restrict__ lo, const int* __restrict__ hi,
                 float* __restrict__ score, int* __restrict__ tbest,
                 int* __restrict__ off_grid, int H, int W, int C) {
  using G = K1Tile<R>;
  constexpr int NK = G::NK;
  extern __shared__ __align__(16) unsigned char k1_smem[];
  float2* sM = reinterpret_cast<float2*>(k1_smem);   // (mu, inv) of R's targets
  unsigned long long* sKey =
      reinterpret_cast<unsigned long long*>(sM + K1_BY * G::RP);  // candidate merge
  int* sR = reinterpret_cast<int*>(sKey + G::NPIX);
  int* sL = sR + G::ROWS * G::RP;
  int* sPre = sL + G::ROWS * G::LW;                   // candidate: item offsets
  unsigned char* sNeg = reinterpret_cast<unsigned char*>(sPre + G::NSLOT + 1);
  __shared__ int s_lo, s_hi, s_tmin, s_tmax, s_span;
  __shared__ unsigned long long s_useful;
  __shared__ int s_warp[K1_NW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wx = warp % K1_NWX, wy = warp / K1_NWX;
  const int bx0 = blockIdx.x * G::BX, by0 = blockIdx.y * K1_BY;
  const int jc = wx * G::WOUT + 2 * lane;        // the lane's first staged column
  const int tcol = bx0 - 2 * G::HL + jc;         // ... and its image column
  const int y0 = by0 + wy * K1_TYW;
  const bool vlane = lane >= G::HL && lane < 32 - G::HL;
  bool bad = false;

  // Sweep layout: the lane's outputs (rows y0 + i, columns tcol + q), each
  // with its target range [oa, oa + ow] clipped to the image.
  float nmu[K1_TYW][2], invl[K1_TYW][2], best[K1_TYW][2];
  int oa[K1_TYW][2], bt[K1_TYW][2];
  unsigned ow[K1_TYW][2];
  int wlo = INT_MAX, whi = INT_MIN, tmn = INT_MAX, tmx = INT_MIN;
  unsigned useful = 0;
#pragma unroll
  for (int i = 0; i < K1_TYW; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int y = y0 + i, c = tcol + q;
      oa[i][q] = K1_INACTIVE;
      ow[i][q] = 0;
      nmu[i][q] = 0.0f;
      invl[i][q] = 1.0f;
      best[i][q] = -1.0f;
      bt[i][q] = -1;
      if (vlane && y < H && c < W) {
        const size_t p = (size_t)y * W + c;
        nmu[i][q] = nmuL[p];
        invl[i][q] = invL[p];
        if (active[p]) {
          const int a = max(lo[p], 0), b = min(hi[p], W - 1);
          if (a <= b) {
            oa[i][q] = a;
            ow[i][q] = (unsigned)(b - a);
            useful += (unsigned)(b - a + 1);
            wlo = min(wlo, a - c);
            whi = max(whi, b - c);
            tmn = min(tmn, a);
            tmx = max(tmx, b);
          }
        }
      }
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wlo = min(wlo, __shfl_xor_sync(K1_FULL, wlo, o));
    whi = max(whi, __shfl_xor_sync(K1_FULL, whi, o));
    tmn = min(tmn, __shfl_xor_sync(K1_FULL, tmn, o));
    tmx = max(tmx, __shfl_xor_sync(K1_FULL, tmx, o));
    useful += __shfl_xor_sync(K1_FULL, useful, o);
  }
  if (tid == 0) {
    s_lo = INT_MAX;
    s_hi = INT_MIN;
    s_tmin = INT_MAX;
    s_tmax = INT_MIN;
    s_span = 0;
    s_useful = 0;
  }
  __syncthreads();
  if (lane == 0 && wlo <= whi) {
    atomicMin(&s_lo, wlo);
    atomicMax(&s_hi, whi);
    atomicMin(&s_tmin, tmn);
    atomicMax(&s_tmax, tmx);
    atomicAdd(&s_useful, (unsigned long long)useful);
    atomicMax(&s_span, whi - wlo + 1);
  }
  __syncthreads();
  const bool any = s_useful > 0;
  // The mode, uniform over the block (see the note at the top).
  const bool cand =
      any && s_span > K1_CAND_SPAN0 &&
      32ull * K1_TYW * 2 * K1_NW * (s_span - K1_CAND_SPAN0) > K1_CAND_RATIO * s_useful;

  // One chunk's R (int8x4, rows by0-R .. by0+BY+R-1) and target moments
  // (rows by0 .. by0+BY-1) over the n columns from RB: invR is NaN where
  // the target is invalid or outside the image, so its score never wins.
  auto stage_chunk = [&](int RB, int n) {
    rtt_stage<8>(
        G::ROWS, n,
        [&](int r, int c) {
          return rtt_pack_px(Rim, by0 - R + r, RB + c, H, W, C, bad);
        },
        [&](int r, int c, int v) { sR[r * G::RP + k1_sidx<R>(c)] = v; });
    rtt_stage<8>(
        K1_BY, n,
        [&](int r, int c) {
          const int y = by0 + r, t = RB + c;
          const bool in = y < H && t >= 0 && t < W;
          const size_t p = in ? (size_t)y * W + t : 0;
          const float mu = in ? muR[p] : 0.0f, inv = in ? invR[p] : 0.0f;
          const bool ok = in && validR[p];
          return make_float2(mu, ok ? inv : __int_as_float(0x7fffffff));
        },
        [&](int r, int c, float2 v) { sM[r * G::RP + k1_sidx<R>(c)] = v; });
  };

  if (any) {
    // L as int8x4 over the block's rows +-R and its lanes' columns.
    rtt_stage<8>(
        G::ROWS, G::LW,
        [&](int r, int c) {
          return rtt_pack_px(L, by0 - R + r, bx0 - 2 * G::HL + c, H, W, C, bad);
        },
        [&](int r, int c, int v) { sL[r * G::LW + c] = v; });
  }

  if (!cand) {
    // Sweep mode: shifts outer, the lane's 2 x TYW outputs in registers.
    int lw[NK][2];
    __syncthreads();
    if (any) {
#pragma unroll
      for (int k = 0; k < NK; ++k)
#pragma unroll
        for (int q = 0; q < 2; ++q) lw[k][q] = sL[(wy * K1_TYW + k) * G::LW + jc + q];
    }
    for (int s0c = s_lo; s0c <= s_hi; s0c += K1_SC) {   // block-uniform
      const int s1c = min(s0c + K1_SC - 1, s_hi);
      const int RB = bx0 - 2 * G::HL + s0c;
      __syncthreads();   // the previous chunk is read
      stage_chunk(RB, G::LW + s1c - s0c);
      __syncthreads();
      const int a = max(s0c, wlo), b = min(s1c, whi);   // warp-uniform
      if (a > b) continue;
      const int jb = jc - s0c;   // staged column of the lane's column 0 at shift s: jb + s
      auto ldR = [&](int (&Z)[NK], int j) {
        const int o = k1_sidx<R>(j);
#pragma unroll
        for (int k = 0; k < NK; ++k) Z[k] = sR[(wy * K1_TYW + k) * G::RP + o];
      };
      auto ldM = [&](float2 (&Z)[K1_TYW], int j) {
        const int o = k1_sidx<R>(j);
#pragma unroll
        for (int i = 0; i < K1_TYW; ++i) Z[i] = sM[(wy * K1_TYW + i) * G::RP + o];
      };
      // One shift: X, Y hold R at the lane's two columns shifted by s, MX,
      // MY the moments of their targets.
      auto step = [&](const int (&X)[NK], const int (&Y)[NK],
                      const float2 (&MX)[K1_TYW], const float2 (&MY)[K1_TYW],
                      int s) {
        int p0[NK], p1[NK];
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          p0[k] = __dp4a(lw[k][0], X[k], 0);
          p1[k] = __dp4a(lw[k][1], Y[k], 0);
        }
        int v0 = 0, v1 = 0;
#pragma unroll
        for (int k = 0; k < 2 * R; ++k) {
          v0 += p0[k];
          v1 += p1[k];
        }
        const int t0 = tcol + s;
#pragma unroll
        for (int i = 0; i < K1_TYW; ++i) {
          v0 += p0[i + 2 * R];   // column sums over rows i .. i + 2R
          v1 += p1[i + 2 * R];
          int c0, c1;   // box sums at the lane's two columns
          if constexpr (R == 1) {
            c0 = __shfl_up_sync(K1_FULL, v1, 1) + v0 + v1;
            c1 = v0 + v1 + __shfl_down_sync(K1_FULL, v0, 1);
          } else if constexpr (R == 2) {
            const int pr = v0 + v1;
            c0 = __shfl_up_sync(K1_FULL, pr, 1) + pr + __shfl_down_sync(K1_FULL, v0, 1);
            c1 = __shfl_up_sync(K1_FULL, v1, 1) + pr + __shfl_down_sync(K1_FULL, pr, 1);
          } else {
            const int pr = v0 + v1;
            const int t3 = __shfl_up_sync(K1_FULL, pr, 1) + pr +
                           __shfl_down_sync(K1_FULL, pr, 1);
            c0 = __shfl_up_sync(K1_FULL, v1, 2) + t3;
            c1 = t3 + __shfl_down_sync(K1_FULL, v0, 2);
          }
          const float sc0 = rtt_ncc_score(rtt_small_int_to_float(c0), nmu[i][0],
                                          MX[i].x, invl[i][0], MX[i].y);
          const float sc1 = rtt_ncc_score(rtt_small_int_to_float(c1), nmu[i][1],
                                          MY[i].x, invl[i][1], MY[i].y);
          if ((unsigned)(t0 - oa[i][0]) <= ow[i][0] && sc0 > best[i][0]) {
            best[i][0] = sc0;   // strict: the first maximum wins
            bt[i][0] = t0;
          }
          if ((unsigned)(t0 + 1 - oa[i][1]) <= ow[i][1] && sc1 > best[i][1]) {
            best[i][1] = sc1;
            bt[i][1] = t0 + 1;
          }
          v0 -= p0[i];
          v1 -= p1[i];
        }
      };
      int X[NK], Y[NK];
      float2 MX[K1_TYW], MY[K1_TYW];
      ldR(X, jb + a);
      ldR(Y, jb + a + 1);
      ldM(MX, jb + a);
      ldM(MY, jb + a + 1);
      // Two shifts an iteration, the registers trading roles: a column's
      // words serve both of the lane's columns, one shift apart.
      for (int s = a;; s += 2) {
        step(X, Y, MX, MY, s);
        if (s + 1 > b) break;
        ldR(X, jb + s + 2);
        ldM(MX, jb + s + 2);
        step(Y, X, MY, MX, s + 1);
        if (s + 2 > b) break;
        ldR(Y, jb + s + 3);
        ldM(MY, jb + s + 3);
      }
    }
#pragma unroll
    for (int i = 0; i < K1_TYW; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int y = y0 + i, c = tcol + q;
        if (vlane && y < H && c < W) {
          score[(size_t)y * W + c] = best[i][q];
          tbest[(size_t)y * W + c] = bt[i][q];
        }
      }
  } else {
    // Candidate mode: pixels outer.  Each active pixel's targets in a chunk
    // are cut into items of at most SEG, spread over the block's threads
    // (a wide hole's range does not hold up a warp); items merge by score,
    // then the smaller target.
    for (int p = tid; p < G::NPIX; p += K1_THREADS) {
      sKey[p] = 0;
      sNeg[p] = 0;
    }
    for (int T0 = s_tmin; T0 <= s_tmax; T0 += G::TSPAN) {   // block-uniform
      const int T1 = min(T0 + G::TSPAN - 1, s_tmax);
      const int RB = T0 - 2 * G::HL;
      __syncthreads();   // the previous chunk is read (and sL, sKey written)
      stage_chunk(RB, T1 - T0 + 1 + 4 * G::HL);
      // Pixel p of the block: its image offset q and its targets [a, b]
      // in this chunk (a > b: none).
      auto range = [&](int p, size_t& q, int& a, int& b) {
        const int y = by0 + p / G::BX, x = bx0 + p % G::BX;
        const bool in = p < G::NPIX && y < H && x < W;
        q = in ? (size_t)y * W + x : 0;
        const int l = in ? lo[q] : 1, h = in ? hi[q] : 0;   // loads side by side
        const bool act = in && active[q];
        a = act ? max(max(l, 0), T0) : 1;
        b = act ? min(min(h, W - 1), T1) : 0;
      };
      int cnt[G::PPT], own = 0;
#pragma unroll
      for (int u = 0; u < G::PPT; ++u) {
        size_t q;
        int a, b;
        range(tid * G::PPT + u, q, a, b);
        cnt[u] = a <= b ? (b - a) / K1_SEG + 1 : 0;
        own += cnt[u];
      }
      int total;
      int off = k1_block_scan(own, s_warp, total);   // synchronises the block
#pragma unroll
      for (int u = 0; u < G::PPT; ++u) {
        sPre[tid * G::PPT + u] = off;
        off += cnt[u];
      }
      __syncthreads();
      for (int g = tid; g < total; g += K1_THREADS) {
        int l0 = 0, l1 = G::NSLOT - 1;   // the last p with sPre[p] <= g
        while (l0 < l1) {
          const int mid = (l0 + l1 + 1) >> 1;
          if (sPre[mid] <= g) l0 = mid;
          else l1 = mid - 1;
        }
        const int p = l0;
        size_t q;
        int a, b;
        range(p, q, a, b);
        const int ta = a + (g - sPre[p]) * K1_SEG, tb = min(b, ta + K1_SEG - 1);
        float bs = -1.0f;
        int bti = -1;
        k1_candidates<R>(sL, sR, sM, p / G::BX, p % G::BX, RB, ta, tb, nmuL[q],
                         invL[q], bs, bti);
        if (bti >= 0) atomicMax(&sKey[p], k1_key(bs, bti));
      }
      __syncthreads();
      // The merge orders +0 and -0 alike: a winning zero takes its sign
      // from its own score, recomputed while its chunk is staged.
      for (int p = tid; p < G::NPIX; p += K1_THREADS) {
        const unsigned long long k = sKey[p];
        const int t = k1_key_t(k);
        if (k != 0 && (unsigned)(k >> 32) == 0x80000000u && t >= T0 && t <= T1) {
          size_t q;
          int a, b;
          range(p, q, a, b);
          float z = __int_as_float(0xff800000);   // -inf: any score replaces it
          int tz = -1;
          k1_candidates<R>(sL, sR, sM, p / G::BX, p % G::BX, RB, t, t, nmuL[q],
                           invL[q], z, tz);
          sNeg[p] = __float_as_uint(z) >> 31;
        }
      }
    }
    __syncthreads();
    for (int p = tid; p < G::NPIX; p += K1_THREADS) {
      const int y = by0 + p / G::BX, x = bx0 + p % G::BX;
      if (y < H && x < W) {
        const unsigned long long k = sKey[p];
        float sc = -1.0f;
        int t = -1;
        if (k != 0) {
          t = k1_key_t(k);
          sc = k1_key_score(k);
          if (sNeg[p]) sc = -0.0f;
        }
        score[(size_t)y * W + x] = sc;
        tbest[(size_t)y * W + x] = t;
      }
    }
  }
  if (bad) *off_grid = 1;
}

template <int R>
cudaError_t k1_launch(const void* L, const void* Rim, const void* nmuL,
                      const void* invL, const void* muR, const void* invR,
                      const void* validR, const void* active, const void* lo,
                      const void* hi, void* score, void* tbest, void* off_grid,
                      int H, int W, int C, cudaStream_t stream) {
  using G = K1Tile<R>;
  cudaError_t err = cudaFuncSetAttribute(
      ncc_sweep_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((W + G::BX - 1) / G::BX, (H + K1_BY - 1) / K1_BY);
  ncc_sweep_kernel<R><<<grid, K1_THREADS, G::SMEM, stream>>>(
      static_cast<const float*>(L), static_cast<const float*>(Rim),
      static_cast<const float*>(nmuL), static_cast<const float*>(invL),
      static_cast<const float*>(muR), static_cast<const float*>(invR),
      static_cast<const uint8_t*>(validR), static_cast<const uint8_t*>(active),
      static_cast<const int*>(lo), static_cast<const int*>(hi),
      static_cast<float*>(score), static_cast<int*>(tbest),
      static_cast<int*>(off_grid), H, W, C);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

constexpr int K3_WX = 128;     // columns per warp, 4 per lane
constexpr int K3_MAX_NX = 5;   // warps side by side along x in a block
constexpr int K3_TX = K3_WX * K3_MAX_NX;
constexpr int K3_TY = 2;       // output rows per block (and per warp)
constexpr int K3_MAX_S = 128;  // slots; a band's filled range spans <= S shifts

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

// Four consecutive volume entries of one (row, slot) line: one 16-byte
// store for float32, one 8-byte store of four bfloat16 for bfloat16.
__device__ __forceinline__ void store4(float* __restrict__ row, int x, int W,
                                       float4 v) {
  if ((W & 3) == 0 && x + 3 < W) {
    *reinterpret_cast<float4*>(row + x) = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
    for (int q = 0; q < 4 && x + q < W; ++q) row[x + q] = e[q];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* __restrict__ row, int x,
                                       int W, float4 v) {
  const float e[4] = {v.x, v.y, v.z, v.w};
  if ((W & 3) == 0 && x + 3 < W) {
    unsigned short h[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) h[q] = __bfloat16_as_ushort(__float2bfloat16_rn(e[q]));
    *reinterpret_cast<uint2*>(row + x) =
        make_uint2(h[0] | ((unsigned)h[1] << 16), h[2] | ((unsigned)h[3] << 16));
  } else {
    for (int q = 0; q < 4 && x + q < W; ++q) row[x + q] = __float2bfloat16_rn(e[q]);
  }
}

// V: the volume's element type, float or __nv_bfloat16 (the scores are
// float32 either way; only the store rounds).
template <typename V>
__global__ void __launch_bounds__(32 * K3_MAX_NX)
cost_volume_kernel(const float* __restrict__ L, const float* __restrict__ R,
                   const float* __restrict__ nmuL,
                   const float* __restrict__ invL,
                   const float* __restrict__ muR,
                   const float* __restrict__ invR,
                   const int* __restrict__ base_b,
                   const int* __restrict__ lo_b,
                   const int* __restrict__ hi_b, V* __restrict__ cv,
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
    rtt_stage(
        K3_TY + 2, RW,
        [&](int r, int c) {
          return rtt_pack_px(R, y0 - 1 + r, x0 - 1 + lo + c, H, W, C, bad);
        },
        [&](int r, int c, int v) { sR[r * K3_RP + skew(c)] = v; });
    rtt_stage(
        K3_TY, MW,
        [&](int r, int c) {
          const int y = y0 + r, t = x0 + lo + c;
          const bool in = y < y1 && t >= 0 && t < W;
          return make_float2(in ? muR[(size_t)y * W + t] : 0.0f,
                             in ? invR[(size_t)y * W + t] : 1.0f);
        },
        [&](int r, int c, float2 v) {
          const int m = r * K3_MP + skew(c);
          sMu[m] = v.x;
          sInv[m] = v.y;
        });
    rtt_stage(
        K3_TY, tx,
        [&](int r, int c) {
          const int y = y0 + r, x = x0 + c;
          const bool in = y < y1 && x < W;
          return make_float2(in ? nmuL[(size_t)y * W + x] : 0.0f,
                             in ? invL[(size_t)y * W + x] : 1.0f);
        },
        [&](int r, int c, float2 v) {
          const int m = r * K3_TX + c;
          sNmu[m] = -v.x;
          sInvL[m] = v.y * 0.5f;
        });
#pragma unroll
    for (int r = 0; r < K3_TY + 2; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k)
        lw[r][k] = rtt_pack_px(L, y0 - 1 + r, x0 + xq - 1 + k, H, W, C, bad);
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
                          void* tbest, void* off_grid, int H, int W, int C,
                          int r, void* stream) {
  if (C < 1 || C > 4) return static_cast<int>(cudaErrorInvalidValue);
  if (H <= 0 || W <= 0) return 0;
  cudaError_t err;
  switch (r) {
    case 1:
      err = k1_launch<1>(L, R, nmuL, invL, muR, invR, validR, active, lo, hi,
                         score, tbest, off_grid, H, W, C, rtt_stream(stream));
      break;
    case 2:
      err = k1_launch<2>(L, R, nmuL, invL, muR, invR, validR, active, lo, hi,
                         score, tbest, off_grid, H, W, C, rtt_stream(stream));
      break;
    case 3:
      err = k1_launch<3>(L, R, nmuL, invL, muR, invR, validR, active, lo, hi,
                         score, tbest, off_grid, H, W, C, rtt_stream(stream));
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

namespace {

template <typename V>
int cost_volume_launch(const void* L, const void* R, const void* nmuL,
                       const void* invL, const void* muR, const void* invR,
                       const void* base_b, const void* lo_b, const void* hi_b,
                       void* cv, void* off_grid, int H, int W, int C, int S,
                       int band, void* stream) {
  if (C < 1 || C > 4 || S < 1 || S > K3_MAX_S)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int) * K3_SMEM_WORDS;
  cudaError_t err = cudaFuncSetAttribute(
      cost_volume_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  cost_volume_kernel<V><<<grid, 32 * nx, smem, rtt_stream(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const float*>(nmuL), static_cast<const float*>(invL),
      static_cast<const float*>(muR), static_cast<const float*>(invR),
      static_cast<const int*>(base_b), static_cast<const int*>(lo_b),
      static_cast<const int*>(hi_b), static_cast<V*>(cv),
      static_cast<int*>(off_grid), H, W, C, S, band, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

RTT_API int rtt_cost_volume(const void* L, const void* R, const void* nmuL,
                            const void* invL, const void* muR,
                            const void* invR, const void* base_b,
                            const void* lo_b, const void* hi_b, void* cv,
                            void* off_grid, int H, int W, int C, int S,
                            int band, void* stream) {
  return cost_volume_launch<float>(L, R, nmuL, invL, muR, invR, base_b, lo_b,
                                   hi_b, cv, off_grid, H, W, C, S, band, stream);
}

RTT_API int rtt_cost_volume_bf16(const void* L, const void* R, const void* nmuL,
                                 const void* invL, const void* muR,
                                 const void* invR, const void* base_b,
                                 const void* lo_b, const void* hi_b, void* cv,
                                 void* off_grid, int H, int W, int C, int S,
                                 int band, void* stream) {
  return cost_volume_launch<__nv_bfloat16>(L, R, nmuL, invL, muR, invR, base_b,
                                           lo_b, hi_b, cv, off_grid, H, W, C, S,
                                           band, stream);
}
