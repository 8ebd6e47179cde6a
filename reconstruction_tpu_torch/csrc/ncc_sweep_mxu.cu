// K5: the zero-mean NCC shift sweep with a running argmax, on the tensor
// cores.
//
// It replaces the TPU kernel `_mxu_kernel`
// (reconstruction_tpu/ops/ncc_sweep_mxu.py:68, launched by
// `ncc_sweep_match_mxu`), which computes K1's function with the window
// dot product as a matrix product:
//
//   cross[x, t] = sum_{dy, dx, c} L[y+dy, x+dx, c] R[y+dy, t+dx, c].
//
// Contract kept from the TPU kernel: one shift range for the image, from
// the active pixels' bounds, its start clipped to [-pad_shift, pad_shift-1]
// and its end to [-pad_shift, pad_shift], visited in chunks of 128 shifts
// from its start, the last chunk at its full width; each pixel gated by
// active, its own [lo, hi] and the target's validity; the first maximum
// wins.  Since every pixel is gated by its own bounds, that is: pixel x
// scores the targets of [x + s_min, x + s_end] (s_end the last chunk's
// end) within its bounds and the image, in ascending order.
//
// Exactness.  The images are centered uint8 values, integers in
// [-128, 127], exact in int8; products and window sums (< 2^22) are exact
// in int32 and again as float, whatever the order of the sums.  The score
// is K1's epilogue (`rtt_ncc_score`), so K5 is bit-equal to K1 wherever
// both visit the same shifts.  The prep pass checks every image value as
// it packs it (`rtt_int8`) and flags one off that grid; the wrapper raises.
//
// Two launches a call.
//  - prep (a thread a column, rows strided): packs L and R as int8x4
//    words, one 32-bit word a pixel (K1's packing, `rtt_pack_px`), writes
//    (muR, invR) of each target as a float2 with invR NaN where the target
//    is invalid (its score never wins) and each pixel's bounds clipped to
//    the image as one word, sets the off-grid flag, and reduces the active
//    pixels' lo - x and hi - x to the shift range (once a block) and their
//    bounds to each sweep block's targets (once a warp and row).  The range
//    never leaves the card.
//  - sweep: mma.sync m16n8k32 s8 -> s32.  The reduction dimension is one
//    window row a k-step: 8 words, the first 2r+1 of them the window's
//    columns.  In PTX's fragment layout a thread's B registers for target
//    t are then the words of R at t - r + tig and t - r + 4 + tig: read
//    straight from the R slab in shared memory, no im2col.  Past the
//    window the B words are R's neighbouring pixels, and A is zero there.
//    A block covers 256 pixels x 4 rows; it stages, with cp.async and in
//    one round trip, its rows +-r of L's and R's words, its pixels' bounds
//    and moments, and its rows' target moments over the targets its pixels
//    reach (576 at a time; a longer range takes chunks, the next
//    one's copy in flight).  Its 8 warps walk four groups of 64 pixels; a
//    warp holds its 2 rows x 16 pixels' A fragments in registers, walks the
//    8-target tiles its pixels' ranges reach, and scores, gates and keeps
//    the running first maximum on the accumulator registers: a thread owns
//    2 pixels x 2 adjacent targets of a tile.  The quad's four threads
//    merge by (greater score, then smaller target), which equals one
//    ascending scan.
//
// What bounds it on this card (1920x1280x3, r = 2, NVIDIA H100 80GB HBM3;
// tools/k5_phase_clocks.py, tools/k5_variants.py).  Not the products, nor
// the bytes: it evaluates 1.28x the useful pairs at 64 shifts and 1.08x at
// 256 (16x8 tiles over each pixel's band; ops/ncc_sweep_mxu.mma_plan
// mirrors the rule), the float images are read once, by the prep pass, and
// the sweep copies per pixel 1.7 (64 shifts) to 2.9 (256) of R's words,
// 1.6 of L's and as many target moments, mostly from L2.  Of the 64-shift
// sweep's ~0.16 ms, ~0.06 ms remains with the tile loop removed (the
// blocks' key loads, copies and writes, latency more than issue), ~0.05 is
// the slab loads and mma.sync and ~0.04 the scores; the prep pass adds
// ~0.06 ms, near its ~0.045 ms of bytes.  A tile of two rows is ~110
// instructions in SASS, ~0.45 a pair; the tiles inside every pixel's range
// of a warp skip the gate.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr unsigned K5_FULL = 0xffffffffu;
constexpr int K5_WR = 2;                    // image rows of a warp
constexpr int K5_NWX = 4;                   // warps side by side (16 pixels each)
constexpr int K5_NWY = 2;                   // warps stacked
constexpr int K5_GROUPS = 4;                // pixel groups a block's warps walk
constexpr int K5_THREADS = 32 * K5_NWX * K5_NWY;
constexpr int K5_GX = 16 * K5_NWX;          // pixels of a group row
constexpr int K5_BX = K5_GX * K5_GROUPS;    // pixels of a block row
constexpr int K5_BY = K5_WR * K5_NWY;       // rows of a block
constexpr int K5_TCH = K5_BX + 320;         // targets staged at a time (multiple of 8)
constexpr int K5_KW = 8;                    // int8x4 words of one k32 step
constexpr int K5_RP = K5_TCH + K5_KW;       // R slab row pitch (words)
constexpr int K5_LP = K5_BX + K5_KW;        // L slab row pitch (words, >= BX + 2R)
constexpr int K5_CHUNK = 128;               // the contract's shifts a chunk
constexpr int K5_INACTIVE = 1 << 30;

// A block's shared memory for radius R (byte offsets, multiples of 16): its
// pixels, staged once: L's words ((BY + 2R) x LP) and the bounds and L
// moments (BY x BX each); then two buffers of a chunk's targets, each the
// moments (BY x TCH float2) and R's words ((BY + 2R) x RP).
template <int R>
struct K5Smem {
  static constexpr int SR = K5_BY + 2 * R;   // staged image rows
  static constexpr size_t LW = 0;
  static constexpr size_t PX = LW + sizeof(int) * SR * K5_LP;
  static constexpr size_t NMU = PX + sizeof(unsigned) * K5_BY * K5_BX;
  static constexpr size_t INVL = NMU + sizeof(float) * K5_BY * K5_BX;
  static constexpr size_t BUF0 = INVL + sizeof(float) * K5_BY * K5_BX;
  static constexpr size_t RW = sizeof(float2) * K5_BY * K5_TCH;   // in a buffer
  static constexpr size_t BUF = RW + sizeof(int) * SR * K5_RP;
  static constexpr size_t BYTES = BUF0 + 2 * BUF;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// f(r, c) for (r, c) in [0, rows) x [0, n), row-major over the block's
// threads, stepping instead of dividing.
template <typename F>
__device__ __forceinline__ void k5_each(int rows, int n, F f) {
  const int dr = K5_THREADS / n, dc = K5_THREADS % n;
  for (int r = threadIdx.x / n, c = threadIdx.x % n; r < rows;) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
}

// acc += A (16 x 32 s8, row) . B (32 x 8 s8, col), s32.
__device__ __forceinline__ void mma_s8(int (&acc)[4], const int (&a)[4], int b0,
                                       int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Ranges are reduced as unsigned maxima so that a zeroed state is neutral:
// the minimum of v as the maximum of ~u(v), the maximum as that of u(v),
// u(v) = v ^ 0x80000000 (order-preserving).  state[0] is the off-grid
// flag, state[1..2] the image's shift range (the active pixels' least
// lo - x and greatest hi - x), state[3 + 2b .. 4 + 2b] sweep block b's
// targets (its active pixels' bounds clipped to the image).
__device__ __forceinline__ unsigned k5_key(int v) {
  return static_cast<unsigned>(v) ^ 0x80000000u;
}

__device__ __forceinline__ int k5_unkey(unsigned k) {
  return static_cast<int>(k ^ 0x80000000u);
}

// One thread a column, rows strided over the grid's y.  A pixel's bounds
// clipped to the image, [a, b] with a in [0, W] and b in [-1, W - 1] (a > b:
// none), are packed as a | (b + 1) << 16, 16 bits each: a zero word (the
// sweep's copy outside the image) is no bounds.
__global__ void __launch_bounds__(256)
ncc_sweep_mxu_prep_kernel(const float* __restrict__ L, const float* __restrict__ R,
                          const float* __restrict__ muR,
                          const float* __restrict__ invR,
                          const uint8_t* __restrict__ validR,
                          const uint8_t* __restrict__ active,
                          const int* __restrict__ lo, const int* __restrict__ hi,
                          int* __restrict__ PL, int* __restrict__ PR,
                          float2* __restrict__ MR, unsigned* __restrict__ PX,
                          unsigned* __restrict__ state, int H, int W, int C) {
  __shared__ int s_mn, s_mx;
  if (threadIdx.x == 0) {
    s_mn = INT_MAX;
    s_mx = INT_MIN;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int nbx = (W + K5_BX - 1) / K5_BX;
  bool bad = false, any = false;
  int smn = INT_MAX, smx = INT_MIN;
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    int a = W, b = -1;
    if (x < W) {
      const size_t p = (size_t)y * W + x;
      PL[p] = rtt_pack_px(L, y, x, H, W, C, bad);
      PR[p] = rtt_pack_px(R, y, x, H, W, C, bad);
      MR[p] = make_float2(muR[p], validR[p] ? invR[p] : __int_as_float(0x7fffffff));
      const int l = lo[p], h = hi[p];
      if (active[p]) {
        any = true;
        smn = min(smn, l - x);
        smx = max(smx, h - x);
        a = min(max(l, 0), W);
        b = max(min(h, W - 1), -1);
      }
      PX[p] = ((unsigned)(b + 1) << 16) | (unsigned)a;
    }
    // A warp's 32 columns lie in one sweep block: its targets on this row.
    int bmn = a <= b ? a : INT_MAX, bmx = a <= b ? b : INT_MIN;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      bmn = min(bmn, __shfl_xor_sync(K5_FULL, bmn, o));
      bmx = max(bmx, __shfl_xor_sync(K5_FULL, bmx, o));
    }
    if (lane == 0 && bmn <= bmx) {
      unsigned* bs = state + 3 + 2 * ((y / K5_BY) * nbx + x / K5_BX);
      atomicMax(bs, ~k5_key(bmn));
      atomicMax(bs + 1, k5_key(bmx));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    smn = min(smn, __shfl_xor_sync(K5_FULL, smn, o));
    smx = max(smx, __shfl_xor_sync(K5_FULL, smx, o));
  }
  if (__any_sync(K5_FULL, any) && lane == 0) {
    atomicMin(&s_mn, smn);
    atomicMax(&s_mx, smx);
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_mn != INT_MAX) {   // the block's, once
    atomicMax(&state[1], ~k5_key(s_mn));
    atomicMax(&state[2], k5_key(s_mx));
  }
  if (bad) state[0] = 1u;
}

// The accumulators start at the bits of 12582912.0f, so an s32 sum is the
// float 12582912 + cross, exactly (|cross| < 2^22): one subtraction makes
// it the float window sum.
constexpr int K5_ACC0 = 0x4B400000;

// Score one (pixel, target) of a tile and keep the first maximum; GATE:
// test the target against the pixel's [a, a + w] (a tile inside every
// pixel's range needs no test).
template <bool GATE>
__device__ __forceinline__ void k5_take(float& best, int& bt, int acc, float nmu,
                                        float invl, float mu, float inv, int t, int a,
                                        unsigned w) {
  const float cross = __fsub_rn(__int_as_float(acc), 12582912.0f);
  const float sc = rtt_ncc_score(cross, nmu, mu, invl, inv);
  if ((!GATE || (unsigned)(t - a) <= w) && sc > best) {  // strict: the first maximum wins
    best = sc;
    bt = t;
  }
}

template <int R>
__global__ void __launch_bounds__(K5_THREADS, 2)
ncc_sweep_mxu_kernel(const int* __restrict__ PL, const int* __restrict__ PR,
                     const float2* __restrict__ MR, const unsigned* __restrict__ PX,
                     const float* __restrict__ nmuL, const float* __restrict__ invL,
                     const unsigned* __restrict__ state, float* __restrict__ score,
                     int* __restrict__ tbest, int H, int W, int pad_shift, int fixed,
                     int fmin, int fmax) {
  using S = K5Smem<R>;
  constexpr int D = 2 * R + 1;           // window rows = k-steps
  constexpr int SR = S::SR;
  constexpr int NK = K5_WR + 2 * R;      // R rows a warp reads
  extern __shared__ __align__(16) unsigned char k5_smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wx = warp % K5_NWX, wy = warp / K5_NWX;
  const int bx0 = blockIdx.x * K5_BX, by0 = blockIdx.y * K5_BY;
  const int yw = by0 + K5_WR * wy;

  // The image's shift range [smin, send] (send the last chunk's end) and
  // the block's targets [Ta, Tb]: its pixels' bounds within the range, from
  // the prep pass's reductions, uniform over the block without a barrier.
  const unsigned* bkey = state + 3 + 2 * (blockIdx.y * gridDim.x + blockIdx.x);
  const unsigned key_lo = state[1], key_hi = state[2], bkey_lo = bkey[0],
                 bkey_hi = bkey[1];
  int smin, smax;
  if (fixed) {
    smin = fmin;
    smax = fmax;
  } else if (key_hi == 0u) {   // no active pixel
    smin = 0;
    smax = -1;
  } else {
    smin = k5_unkey(~key_lo);
    smax = k5_unkey(key_hi);
  }
  smin = min(max(smin, -pad_shift), pad_shift - 1);
  smax = min(max(smax, -pad_shift), pad_shift);
  const int cnt = max(smax - smin + 1, 0);
  const int send = smin + K5_CHUNK * ((cnt + K5_CHUNK - 1) / K5_CHUNK) - 1;
  int Ta = INT_MAX, Tb = INT_MIN;
  if (bkey_hi != 0u) {
    Ta = max(k5_unkey(~bkey_lo), bx0 + smin);
    Tb = min(k5_unkey(bkey_hi), bx0 + K5_BX - 1 + send);
  }

  // The thread's outputs in group grp: rows yw + i, columns
  // bx0 + 64 grp + 16 wx + g + 8 tig, for tig < 2.
  float best[K5_WR][2];
  int bt[K5_WR][2];
  auto write = [&](int grp) {
    const int x = bx0 + K5_GX * grp + 16 * wx + g + 8 * tig;
    if (tig < 2 && x < W) {
#pragma unroll
      for (int i = 0; i < K5_WR; ++i)
        if (yw + i < H) {
          score[(size_t)(yw + i) * W + x] = tig ? best[i][1] : best[i][0];
          tbest[(size_t)(yw + i) * W + x] = tig ? bt[i][1] : bt[i][0];
        }
    }
  };
  if (Ta > Tb) {   // no pixel of the block scores a target
#pragma unroll
    for (int i = 0; i < K5_WR; ++i) {
      best[i][0] = best[i][1] = -1.0f;
      bt[i][0] = bt[i][1] = -1;
    }
    for (int grp = 0; grp < K5_GROUPS; ++grp) write(grp);
    return;
  }

  const int* sL = reinterpret_cast<const int*>(k5_smem + S::LW);
  const unsigned* sP = reinterpret_cast<const unsigned*>(k5_smem + S::PX);
  const float* sN = reinterpret_cast<const float*>(k5_smem + S::NMU);
  const float* sI = reinterpret_cast<const float*>(k5_smem + S::INVL);
  auto sM_of = [&](int b) {
    return reinterpret_cast<float2*>(k5_smem + S::BUF0 + b * S::BUF);
  };
  auto sR_of = [&](int b) {
    return reinterpret_cast<int*>(k5_smem + S::BUF0 + b * S::BUF + S::RW);
  };
  // Chunk k of the block's targets into buffer b: R's words over rows
  // by0-R .. by0+BY+R-1 and columns T0-R .. T0-R+n+6 (zero outside the
  // image), moments over rows by0 .. by0+BY-1 and targets T0 .. T0+n-1;
  // first, the block's pixels: L's words over rows by0-R .. by0+BY+R-1
  // and columns bx0-R .. bx0+BX+R-1, bounds and L moments.
  auto stage = [&](int k, int b, bool pixels) {
    if (pixels) {
      int* dL = reinterpret_cast<int*>(k5_smem + S::LW);
      k5_each(SR, K5_BX + 2 * R, [&](int r, int c) {
        const int yy = by0 - R + r, xx = bx0 - R + c;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
        cp_async4(dL + r * K5_LP + c, PL + (in ? (size_t)yy * W + xx : 0), in);
      });
      k5_each(K5_BY, K5_BX, [&](int r, int c) {
        const int yy = by0 + r, xx = bx0 + c;
        const bool in = yy < H && xx < W;
        const size_t p = in ? (size_t)yy * W + xx : 0;
        const int e = r * K5_BX + c;
        cp_async4(k5_smem + S::PX + 4 * e, PX + p, in);
        cp_async4(k5_smem + S::NMU + 4 * e, nmuL + p, in);
        cp_async4(k5_smem + S::INVL + 4 * e, invL + p, in);
      });
    }
    const int T0 = Ta + k * K5_TCH, n = min(K5_TCH, Tb - T0 + 1);
    int* dR = sR_of(b);
    k5_each(SR, n + K5_KW - 1, [&](int r, int c) {
      const int yy = by0 - R + r, xx = T0 - R + c;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      cp_async4(dR + r * K5_RP + c, PR + (in ? (size_t)yy * W + xx : 0), in);
    });
    float2* dM = sM_of(b);
    k5_each(K5_BY, n, [&](int r, int c) {
      const int yy = by0 + r, tt = T0 + c;
      const bool in = yy < H && tt >= 0 && tt < W;
      cp_async8(dM + r * K5_TCH + c, MR + (in ? (size_t)yy * W + tt : 0), in);
    });
    cp_async_commit();
  };

  // Units: each group of pixels over each chunk of targets.  With one
  // chunk (the usual case) it is staged once and every group reads it;
  // with more, each group's chunks are staged in turn, the next one's copy
  // in flight while the current one is scored.
  const int nchunk = (Tb - Ta) / K5_TCH + 1;
  const int units = K5_GROUPS * nchunk;
  stage(0, 0, true);
  // The current group's state: its pixels' L moments, targets [a, a + w]
  // (within the image and the range) or none, running bests; A's
  // fragments (row i, window row dy; registers (pixel g, words tig),
  // (g + 8, tig), (g, 4 + tig), (g + 8, 4 + tig), zero past the window and
  // outside the image); the warp's targets [wa, wb].
  float nmu[K5_WR][2], invl[K5_WR][2];
  int pa[K5_WR][2];
  unsigned pw[K5_WR][2];
  int A[K5_WR][D][4];
  int wa = INT_MAX, wb = INT_MIN, ia = INT_MIN, ib = INT_MAX;
  for (int u = 0; u < units; ++u) {
    const int grp = u / nchunk, k = u - grp * nchunk;
    const int b = nchunk == 1 ? 0 : (u & 1);
    if (nchunk > 1 && u + 1 < units) {
      stage((u + 1) % nchunk, (u + 1) & 1, false);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (u == 0 || nchunk > 1) __syncthreads();
    const int gx = K5_GX * grp + 16 * wx;   // the warp's first column in the block
    if (k == 0) {
      // wa, wb: the warp's targets; ia, ib: those of all its pixels (none
      // unless every pixel has some).
      wa = INT_MAX;
      wb = INT_MIN;
      ia = INT_MIN;
      ib = INT_MAX;
#pragma unroll
      for (int i = 0; i < K5_WR; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = (K5_WR * wy + i) * K5_BX + gx + g + 8 * h;
          const unsigned pxw = sP[e];
          const int x = bx0 + gx + g + 8 * h;
          const int a = max(static_cast<int>(pxw & 0xffffu), x + smin);
          const int b = min(static_cast<int>(pxw >> 16) - 1, x + send);
          nmu[i][h] = sN[e];
          invl[i][h] = sI[e];
          best[i][h] = -1.0f;
          bt[i][h] = -1;
          pa[i][h] = a <= b ? a : K5_INACTIVE;
          pw[i][h] = a <= b ? (unsigned)(b - a) : 0u;
          wa = a <= b ? min(wa, a) : wa;
          wb = a <= b ? max(wb, b) : wb;
          ia = a <= b ? max(ia, a) : INT_MAX;
          ib = min(ib, b);
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        wa = min(wa, __shfl_xor_sync(K5_FULL, wa, o));
        wb = max(wb, __shfl_xor_sync(K5_FULL, wb, o));
        ia = max(ia, __shfl_xor_sync(K5_FULL, ia, o));
        ib = min(ib, __shfl_xor_sync(K5_FULL, ib, o));
      }
#pragma unroll
      for (int i = 0; i < K5_WR; ++i)
#pragma unroll
        for (int dy = 0; dy < D; ++dy)
#pragma unroll
          for (int kq = 0; kq < 4; ++kq) {
            const int q = tig + 4 * (kq >> 1);
            A[i][dy][kq] =
                q < D ? sL[(K5_WR * wy + i + dy) * K5_LP + gx + g + 8 * (kq & 1) + q] : 0;
          }
    }
    const int T0 = Ta + k * K5_TCH, T1 = min(T0 + K5_TCH - 1, Tb);
    const int ja = max(wa, T0), jb = min(wb, T1);   // warp-uniform
    if (ja <= jb) {
      const int* sR = sR_of(b) + (K5_WR * wy) * K5_RP + g;
      const float4* sM = reinterpret_cast<const float4*>(sM_of(b)) +
                         (K5_WR * wy) * (K5_TCH / 2) + tig;
      // Tiles j0 .. j1; gated: each pair tested against its pixel's range.
      auto tiles = [&](int j0, int j1, auto gated) {
        constexpr bool GATE = decltype(gated)::value;
#pragma unroll 2
        for (int j = j0; j <= j1; ++j) {
          int acc[K5_WR][4];
#pragma unroll
          for (int i = 0; i < K5_WR; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] = K5_ACC0;
          // Slab row kk serves warp row i as its window row kk - i.
#pragma unroll
          for (int kk = 0; kk < NK; ++kk) {
            const int* row = sR + kk * K5_RP + 8 * j;
            const int b0 = row[tig], b1 = row[4 + tig];
#pragma unroll
            for (int i = 0; i < K5_WR; ++i)
              if (kk - i >= 0 && kk - i < D) mma_s8(acc[i], A[i][kk - i], b0, b1);
          }
          const int t = T0 + 8 * j + 2 * tig;   // the thread's targets t, t + 1
#pragma unroll
          for (int i = 0; i < K5_WR; ++i) {
            const float4 m = sM[i * (K5_TCH / 2) + 4 * j];
            k5_take<GATE>(best[i][0], bt[i][0], acc[i][0], nmu[i][0], invl[i][0], m.x,
                          m.y, t, pa[i][0], pw[i][0]);
            k5_take<GATE>(best[i][0], bt[i][0], acc[i][1], nmu[i][0], invl[i][0], m.z,
                          m.w, t + 1, pa[i][0], pw[i][0]);
            k5_take<GATE>(best[i][1], bt[i][1], acc[i][2], nmu[i][1], invl[i][1], m.x,
                          m.y, t, pa[i][1], pw[i][1]);
            k5_take<GATE>(best[i][1], bt[i][1], acc[i][3], nmu[i][1], invl[i][1], m.z,
                          m.w, t + 1, pa[i][1], pw[i][1]);
          }
        }
      };
      // The tiles inside every pixel's range (warp-uniform) need no gate.
      const int j0 = (ja - T0) >> 3, j1 = (jb - T0) >> 3;
      const int i0 = max(j0, (ia - T0 + 7) >> 3), i1 = min(j1, (ib - 7 - T0) >> 3);
      if (ia <= ib && i0 <= i1) {
        tiles(j0, i0 - 1, std::true_type{});
        tiles(i0, i1, std::false_type{});
        tiles(i1 + 1, j1, std::true_type{});
      } else {
        tiles(j0, j1, std::true_type{});
      }
    }
    if (k + 1 == nchunk) {
      // The quad's threads hold interleaved targets of the same pixels:
      // merge by (greater score, then smaller target), one ascending
      // scan's result.
#pragma unroll
      for (int i = 0; i < K5_WR; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            const float ob = __shfl_xor_sync(K5_FULL, best[i][h], o);
            const int ot = __shfl_xor_sync(K5_FULL, bt[i][h], o);
            if (ob > best[i][h] || (ob == best[i][h] && ot >= 0 && ot < bt[i][h])) {
              best[i][h] = ob;
              bt[i][h] = ot;
            }
          }
      write(grp);
    }
    if (nchunk > 1) __syncthreads();   // buffer b is staged again two units on
  }
}

template <int R>
cudaError_t k5_launch(const int* PL, const int* PR, const float2* MR, const unsigned* PX,
                      const void* nmuL, const void* invL, const unsigned* state,
                      void* score, void* tbest, int H, int W, int pad_shift, int fixed,
                      int fmin, int fmax, cudaStream_t stream) {
  const size_t smem = K5Smem<R>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ncc_sweep_mxu_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((W + K5_BX - 1) / K5_BX, (H + K5_BY - 1) / K5_BY);
  ncc_sweep_mxu_kernel<R><<<grid, K5_THREADS, smem, stream>>>(
      PL, PR, MR, PX, static_cast<const float*>(nmuL), static_cast<const float*>(invL),
      state, static_cast<float*>(score),
      static_cast<int*>(tbest), H, W, pad_shift, fixed, fmin, fmax);
  return cudaGetLastError();
}

constexpr int K5_MAX_WIDTH = 32767;   // the prep pass packs a pixel's bounds as two int16

// The scratch of an H x W call (byte offsets, each part rounded up to 16
// bytes): the state, 3 + 2 x (sweep blocks) uint32 (see k5_key); PX, PL,
// PR: (H, W) uint32 each; MR: (H, W) float2.
struct K5Scratch {
  size_t state_bytes, px, pl, pr, mr, bytes;
  K5Scratch(int H, int W) {
    auto up16 = [](size_t n) { return (n + 15) & ~static_cast<size_t>(15); };
    const size_t n = (size_t)H * W;
    state_bytes = sizeof(unsigned) *
                  (3 + 2 * (size_t)((H + K5_BY - 1) / K5_BY) * ((W + K5_BX - 1) / K5_BX));
    px = up16(state_bytes);
    pl = px + up16(4 * n);
    pr = pl + up16(4 * n);
    mr = pr + up16(4 * n);
    bytes = mr + up16(8 * n);
  }
};

}  // namespace

// The sweep's geometry and the scratch of an H x W call, for the wrapper
// (what it allocates and refuses) and ops/ncc_sweep_mxu.mma_plan (the pairs
// and words the sweep's rule gives): out = [scratch bytes, rows a warp,
// pixels a warp, targets a tile, rows a block, pixels a block, pixel groups
// a block, targets staged at a time, widest image].
RTT_API int rtt_ncc_sweep_mxu_layout(int H, int W, long long* out) {
  if (H < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long v[] = {static_cast<long long>(K5Scratch(H, W).bytes),
                         K5_WR, 16, 8, K5_BY, K5_BX, K5_GROUPS, K5_TCH, K5_MAX_WIDTH};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// scratch: 16-byte aligned, at least K5Scratch(H, W).bytes; its state is
// zeroed here.
RTT_API int rtt_ncc_sweep_mxu(const void* L, const void* R, const void* nmuL,
                              const void* invL, const void* muR,
                              const void* invR, const void* validR,
                              const void* active, const void* lo,
                              const void* hi, void* scratch, void* score, void* tbest,
                              int H, int W, int C, int r, int pad_shift, int fixed,
                              int fmin, int fmax, long long scratch_bytes, void* stream) {
  if (C < 1 || C > 4 || r < 1 || r > 3 || W > K5_MAX_WIDTH || H < 0 || W < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const K5Scratch lay(H, W);
  if ((size_t)scratch_bytes < lay.bytes) return static_cast<int>(cudaErrorInvalidValue);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  unsigned* state = reinterpret_cast<unsigned*>(base);
  unsigned* PX = reinterpret_cast<unsigned*>(base + lay.px);
  int* PL = reinterpret_cast<int*>(base + lay.pl);
  int* PR = reinterpret_cast<int*>(base + lay.pr);
  float2* MR = reinterpret_cast<float2*>(base + lay.mr);
  const size_t state_bytes = lay.state_bytes;
  const cudaStream_t s = rtt_stream(stream);
  cudaError_t err = cudaMemsetAsync(state, 0, state_bytes, s);
  if (err != cudaSuccess || H == 0 || W == 0) return static_cast<int>(err);
  const dim3 pgrid((W + 255) / 256, min(H, 256));
  ncc_sweep_mxu_prep_kernel<<<pgrid, 256, 0, s>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const float*>(muR), static_cast<const float*>(invR),
      static_cast<const uint8_t*>(validR), static_cast<const uint8_t*>(active),
      static_cast<const int*>(lo), static_cast<const int*>(hi), PL, PR, MR, PX, state,
      H, W, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  switch (r) {
    case 1:
      err = k5_launch<1>(PL, PR, MR, PX, nmuL, invL, state, score, tbest, H, W, pad_shift,
                         fixed, fmin, fmax, s);
      break;
    case 2:
      err = k5_launch<2>(PL, PR, MR, PX, nmuL, invL, state, score, tbest, H, W, pad_shift,
                         fixed, fmin, fmax, s);
      break;
    default:
      err = k5_launch<3>(PL, PR, MR, PX, nmuL, invL, state, score, tbest, H, W, pad_shift,
                         fixed, fmin, fmax, s);
  }
  return static_cast<int>(err);
}
