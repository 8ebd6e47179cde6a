// K6 and K7: the stereo matcher's row-sequential constraint passes.
//
// K6, the ordering constraint (`CStereoMatching.cpp:310-368`): on each row,
// repeatedly delete the valid point that crosses the most others (the first
// such point on ties) until none cross; (x_i, t_i) and (x_j, t_j), t = d + x,
// cross when x_j < x_i and t_j > t_i, or x_j > x_i and t_j < t_i.  It
// replaces the JAX package's vmapped per-row `lax.while_loop`
// (reconstruction_tpu/stereo/constraints.py:78), which the port's plain
// version (`ops/constraints.ordering_plain`) runs for all rows together,
// stepping all rows at once and reading the loop's end back every 8 steps.
//
// K7, the bound propagation (`SetBoundary_smooth`, `:817-942`): down and up
// sweeps over each column, c <- max(c + s, m) and c <- min(c + s, m), then a
// forward and a backward sweep over each row with the conversion to
// absolute target columns.  It replaces the associative scans of the JAX
// package's `propagate_bounds` (reconstruction_tpu/stereo/constraints.py:334,
// scans at :310), which the port's plain version evaluates with
// `jax.lax.associative_scan`'s pairing tree, about log2(n) levels of
// several launches each.  The kernels keep the JAX package's semantics,
// the row-YL rule and the two C++ deviations it documents included.
//
// What bounds them on this card.  Bytes are few: K6 reads d and writes it
// (8 bytes a pixel, 20 MB at 1920x1280), K7 reads d and the mask and
// writes two maps (13 bytes a pixel): a few microseconds at 3.35 TB/s.
// Work is small too, once no thread walks a whole row or column and no
// row compares all its points pairwise; what is left is latency: the
// dependency chains and the barriers between phases.
//
// What the design does about it.  K6 gives a row to a thread block: the
// row's valid points, compacted in column order, sit in shared memory as
// t (float), the crossing count (int) and the column (16 bits), with two
// buffers of 16-bit indices for a merge sort, 14 bytes a column.  The
// initial counts are a merge sort of (t, index): a warp counts and ranks
// each chunk of 32 points by shuffles, then each bottom-up merge gives a
// point of the left run the right run's points below its t (a binary
// search, which also places it) and a point of the right run the left
// run's points above it: O(V log^2 V) over the V points in place of
// O(V^2).  Only points that cross something (count > 0) can be deleted or
// lose a crossing, so they are compacted, in order, and the greedy loop
// runs over them alone: a step is one pass of each thread over its own
// points, which decrements those that cross the deleted one and keeps the
// thread's best (count, index) key, then a warp reduction, one barrier and
// a read of the eight warps' keys (on one warp, whose lanes walk shared
// memory serially, a row of 141 steps took 2.4 times as long).  The loop
// ends on the card when the largest count is 0.
// K7 composes its step functions.  Two steps c -> op(c + s1, m1), then
// c -> op(c + s2, m2), are one: (s1 + s2, op(m1 + s2, m2)), the JAX
// package's `combine`.  The column pass gives a block 8 columns (W / 8
// blocks: 160 at the `myself` finest level, 480 at the dome's) and cuts
// each column into 128 segments of ceil(H / 128) rows, a thread a segment
// (a warp reads 4 segments' 8 neighbouring columns, 32-byte sectors): each
// thread folds its segment's down function (appending rows) and up
// function (prepending them) in one walk, and keeps the down fold at the
// start of each batch of 4 rows; a warp per column and chain scans the
// 128 segments' functions (each lane folds 4, then a Kogge-Stone scan over
// the lanes' shuffles); each thread replays its segment a batch at a time
// from the bottom: the batch's down carry from its kept fold, its rows
// down in registers, then up, and each output written once.
// The row pass gives a row to a warp, staged in shared memory; each lane
// owns a run of ceil(W / 32) columns (made odd: no bank conflicts), folds
// the run's forward function, the lanes scan by shuffles, and the replay
// writes the forward bounds while it folds the backward functions (their
// m needs the forward bound), which are scanned from the last lane and
// replayed.  The lower and upper bounds run side by side in each thread.
// The margins are read from device memory (0-d int32 tensors): the
// wrappers never read them back.
//
// Exactness.  K6 is comparisons and integer counts: bit-equal to its plain
// version.  K7 groups the same associative operator in another way than
// the scan tree; the sums that can win a max or a min at an output are
// sums of small integers, exact in any order (only terms carrying the
// +-1e9 reset sentinels round, and those never win), so the outputs equal
// the plain version's at every mask-valid source pixel
// (tests/test_torch_constraint_kernels.py models the kernels' bracketing).
#include "common.cuh"

#define RTT_CONSTRAINTS_MAX_W 16384   // ops/constraints.py MAX_WIDTH

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int K6_THREADS = 256;
constexpr int K6_WARPS = K6_THREADS / 32;
constexpr int K6_CHUNK = 32;        // points a warp counts and ranks by shuffles
// t, count, column, two sort buffers
constexpr int K6_BYTES_PER_COLUMN = 4 + 4 + 2 + 2 * 2;
constexpr int K7C_COLS = 8;         // columns a column-pass block
constexpr int K7C_SEGS = 128;       // segments a column (tests: K7_SEGMENTS)
constexpr int K7C_THREADS = K7C_COLS * K7C_SEGS;
constexpr int K7C_PER_LANE = K7C_SEGS / 32;   // segments a lane of the scan folds
constexpr int K7C_BATCH = 4;        // rows a thread holds at once (at least 2)
constexpr int K7R_ROWS = 8;         // rows (warps) a row-pass block, at most
constexpr int K7R_SMEM = 96 * 1024; // a row-pass block's staging, unless one row needs more
constexpr int SMEM_DEFAULT = 48 * 1024;

constexpr float K7_BIG = 1e9f;     // the reset sentinel (exact in float32)
constexpr float K7_LO = -10000.0f;
constexpr float K7_HI = 10000.0f;

struct Box {
  int YL, YR, XL, XR;
  __device__ bool row(int y) const { return y >= YL && y <= YR; }
  __device__ bool col(int x) const { return x >= XL && x <= XR; }
};

__device__ __forceinline__ Box load_box(const int* YL, const int* YR, const int* XL,
                                        const int* XR) {
  return Box{*YL, *YR, *XL, *XR};
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// A point's argmax key: larger count first, then smaller index (the first
// maximum, as argmax takes it); -1 once deleted.
__device__ __forceinline__ int k6_key(int count, int i) {
  return count >= 0 ? (count << 16) | (0xFFFF - i) : -1;
}

// Compacts the entries [0, n) for which keep(i) holds to the front, in
// order, K6_THREADS at a time: every thread of the block calls it, and
// calls move(i, p) for each of its entries i (p <= i its new position, -1
// where it is not kept or i >= n), after a barrier.  Returns the number
// kept.
template <typename Keep, typename Move>
__device__ __forceinline__ int k6_compact(int n, int* wsum, Keep keep, Move move) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int kept = 0;
  for (int i0 = 0; i0 < n; i0 += K6_THREADS) {
    const int i = i0 + tid;
    const bool k = i < n && keep(i);
    const unsigned ballot = __ballot_sync(FULL, k);
    if (lane == 0) wsum[warp] = __popc(ballot);
    __syncthreads();
    int off = kept, total = 0;
#pragma unroll
    for (int w = 0; w < K6_WARPS; ++w) {
      off += w < warp ? wsum[w] : 0;
      total += wsum[w];
    }
    move(i, k ? off + __popc(ballot & ((1u << lane) - 1u)) : -1);
    kept += total;
    __syncthreads();
  }
  return kept;
}

__global__ void __launch_bounds__(K6_THREADS)
ordering_constraint_kernel(const float* __restrict__ disp, float* __restrict__ out,
                           const int* __restrict__ pYL, const int* __restrict__ pYR,
                           const int* __restrict__ pXL, const int* __restrict__ pXR,
                           int W) {
  extern __shared__ __align__(16) unsigned char k6_smem[];
  float* t = reinterpret_cast<float*>(k6_smem);
  int* cnt = reinterpret_cast<int*>(t + W);
  unsigned short* col = reinterpret_cast<unsigned short*>(cnt + W);
  unsigned short* perm = col + W;               // two buffers of W indices
  __shared__ int wsum[K6_WARPS];
  __shared__ int wkey[2][K6_WARPS];

  const int y = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Box box = load_box(pYL, pYR, pXL, pXR);
  const float* drow = disp + (size_t)y * W;
  float* orow = out + (size_t)y * W;

  // The row is copied; its valid points (inside the box, not NOMATCH) are
  // compacted in column order.
  const int V = k6_compact(
      W, wsum,
      [&](int x) {
        const float d = drow[x];
        orow[x] = d;
        return box.row(y) && box.col(x) && d != RTT_NOMATCH;
      },
      [&](int x, int p) {
        if (p < 0) return;
        t[p] = __fadd_rn(drow[x], (float)x);
        col[p] = (unsigned short)x;
      });
  if (V == 0) return;

  // Crossings inside each chunk of K6_CHUNK points, and the chunk sorted by
  // (t, index): a warp a chunk, each lane a point, the chunk's t by shuffles.
  for (int c0 = warp * K6_CHUNK; c0 < V; c0 += K6_THREADS) {
    const int i = c0 + lane, n = min(K6_CHUNK, V - c0);
    const float ti = i < V ? t[i] : 0.0f;
    int c = 0, rank = 0;
    for (int j = 0; j < n; ++j) {
      const float tj = __shfl_sync(FULL, ti, j);
      c += j < lane ? (tj > ti) : (tj < ti);
      rank += tj < ti || (tj == ti && j < lane);
    }
    if (i < V) {
      cnt[i] = c;
      perm[c0 + rank] = (unsigned short)i;
    }
  }
  __syncthreads();

  // Bottom-up merges of sorted runs of w points: a point of the left run
  // gains the right run's points with t below its own, one of the right
  // run the left run's points with t above its own; the same binary
  // searches place each point in the merged run (left first on ties).
  unsigned short* src = perm;
  unsigned short* dst = perm + W;
  for (int w = K6_CHUNK; w < V; w <<= 1) {
    for (int e = tid; e < V; e += K6_THREADS) {
      const int base = e & ~(2 * w - 1), mid = base + w;
      const int p = src[e];
      if (mid >= V) {
        dst[e] = (unsigned short)p;
        continue;
      }
      const float tp = t[p];
      const bool left = e < mid;
      int lo = left ? mid : base, hi = left ? min(base + 2 * w, V) : mid;
      while (lo < hi) {
        const int m = (lo + hi) >> 1;
        const float tm = t[src[m]];
        if (left ? tm < tp : tm <= tp) lo = m + 1; else hi = m;
      }
      const int r = lo - (left ? mid : base);
      dst[left ? e + r : base + (e - mid) + r] = (unsigned short)p;
      cnt[p] += left ? r : w - r;
    }
    __syncthreads();
    unsigned short* tmp = src;
    src = dst;
    dst = tmp;
  }

  // The greedy loop: only points that cross something can be deleted or
  // lose a crossing, so they are compacted in order and the loop runs
  // over them alone.  Each thread updates only its own points and folds
  // the next step's (count, index) key as it goes, so the one barrier a
  // step is the one that publishes the warps' best keys (two buffers, by
  // the step's parity).
  const int NA = k6_compact(
      V, wsum, [&](int i) { return cnt[i] > 0; },
      [&](int i, int p) {
        const float ti = i < V ? t[i] : 0.0f;
        const int ci = i < V ? cnt[i] : 0;
        const unsigned short xi = i < V ? col[i] : 0;
        __syncthreads();                       // every read before any write
        if (p >= 0) {
          t[p] = ti;
          cnt[p] = ci;
          col[p] = xi;
        }
      });
  if (NA == 0) return;
  int best = -1;
  for (int j = tid; j < NA; j += K6_THREADS) best = max(best, k6_key(cnt[j], j));
  for (int step = 0;; ++step) {
    const int wbest = __reduce_max_sync(FULL, best);
    if (lane == 0) wkey[step & 1][warp] = wbest;
    __syncthreads();
    int key = wkey[step & 1][0];
#pragma unroll
    for (int w = 1; w < K6_WARPS; ++w) key = max(key, wkey[step & 1][w]);
    if (key < 0x10000) break;   // the most crossings left on the row is 0
    const int k = 0xFFFF - (key & 0xFFFF);
    const float tk = t[k];
    best = -1;
    for (int j = tid; j < NA; j += K6_THREADS) {
      int c = cnt[j];
      if (j == k) {
        c = -1;
        orow[col[k]] = RTT_NOMATCH;
      } else if (c >= 0 && (j < k ? t[j] > tk : t[j] < tk)) {
        --c;
      }
      cnt[j] = c;
      best = max(best, k6_key(c, j));
    }
  }
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

template <bool IS_MAX>
__device__ __forceinline__ float k7_op(float a, float b) {
  return IS_MAX ? fmaxf(a, b) : fminf(a, b);
}

// A step function c -> op(c + s, m).
struct Fn {
  float s, m;
};

template <bool IS_MAX>
__device__ __forceinline__ Fn k7_ident() {
  return Fn{0.0f, IS_MAX ? -INFINITY : INFINITY};
}

// a, then b, in closed form (the JAX package's `combine`).
template <bool IS_MAX>
__device__ __forceinline__ Fn k7_then(Fn a, Fn b) {
  return Fn{__fadd_rn(a.s, b.s), k7_op<IS_MAX>(__fadd_rn(a.m, b.s), b.m)};
}

template <bool IS_MAX>
__device__ __forceinline__ float k7_apply(Fn f, float c) {
  return k7_op<IS_MAX>(__fadd_rn(c, f.s), f.m);
}

// The carry into this lane: the composition of the lanes before it (after
// it with REVERSE) applied to the identity's carry, by a Kogge-Stone scan
// over the warp's shuffles.  Every lane of the warp calls it.
template <bool IS_MAX, bool REVERSE>
__device__ __forceinline__ float k7_lane_carry(Fn f, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float s = REVERSE ? __shfl_down_sync(FULL, f.s, off) : __shfl_up_sync(FULL, f.s, off);
    const float m = REVERSE ? __shfl_down_sync(FULL, f.m, off) : __shfl_up_sync(FULL, f.m, off);
    if (REVERSE ? lane + off < 32 : lane >= off) f = k7_then<IS_MAX>(Fn{s, m}, f);
  }
  const float m = REVERSE ? __shfl_down_sync(FULL, f.m, 1) : __shfl_up_sync(FULL, f.m, 1);
  return (REVERSE ? lane == 31 : lane == 0) ? k7_ident<IS_MAX>().m : m;
}

// One pixel's vertical step functions c -> max(c + s_lo, m_lo) and
// c -> min(c + s_hi, m_hi): a hole inside the mask decays the carry by
// max_step, a pixel with a disparity resets it to d -+ max_step, and a
// pixel outside the mask resets it to the initial bounds.
struct K7Vertical {
  Fn lo, hi;
};

__device__ __forceinline__ K7Vertical k7_vertical(float d, bool mask, float MD) {
  const bool has_d = mask && d != RTT_NOMATCH;
  const bool hole = mask && !has_d;
  K7Vertical v;
  v.lo.s = hole ? -MD : -K7_BIG;
  v.hi.s = hole ? MD : K7_BIG;
  v.lo.m = mask ? fmaxf(has_d ? __fsub_rn(d, MD) : K7_LO, K7_LO) : K7_LO;
  v.hi.m = mask ? fminf(has_d ? __fadd_rn(d, MD) : K7_HI, K7_HI) : K7_HI;
  return v;
}

// A lane's K7C_PER_LANE segments of one chain: fold them (in application
// order), scan the lanes, and leave each segment's carry-in in its m.
template <bool IS_MAX, bool REVERSE>
__device__ __forceinline__ void k7_segment_carries(Fn* f, int lane) {
  Fn g[K7C_PER_LANE];
  Fn acc = k7_ident<IS_MAX>();
#pragma unroll
  for (int u = 0; u < K7C_PER_LANE; ++u) {
    g[u] = f[u];
  }
#pragma unroll
  for (int u = 0; u < K7C_PER_LANE; ++u)
    acc = k7_then<IS_MAX>(acc, g[REVERSE ? K7C_PER_LANE - 1 - u : u]);
  float c = k7_lane_carry<IS_MAX, REVERSE>(acc, lane);
#pragma unroll
  for (int u = 0; u < K7C_PER_LANE; ++u) {
    const int j = REVERSE ? K7C_PER_LANE - 1 - u : u;
    f[j].m = c;
    c = k7_apply<IS_MAX>(g[j], c);
  }
}

__global__ void __launch_bounds__(K7C_THREADS)
propagate_bounds_columns_kernel(const float* __restrict__ disp,
                                const unsigned char* __restrict__ valid,
                                const int* __restrict__ pYL, const int* __restrict__ pYR,
                                const int* __restrict__ pXL, const int* __restrict__ pXR,
                                float* __restrict__ BL, float* __restrict__ BR,
                                float MD, int H, int W) {
  // The segments' functions by chain (down lo, down hi, up lo, up hi),
  // column and segment; after the scan, their carries in m.
  __shared__ Fn sfn[4][K7C_COLS][K7C_SEGS + 1];
  const int c = threadIdx.x % K7C_COLS, seg = threadIdx.x / K7C_COLS;
  const int x = blockIdx.x * K7C_COLS + c;
  const bool live = x < W;
  const int L = (H + K7C_SEGS - 1) / K7C_SEGS;
  const int y0 = min(seg * L, H), y1 = live ? min(y0 + L, H) : y0;
  const Box box = load_box(pYL, pYR, pXL, pXR);
  const bool in_col = box.col(x);
  auto pix = [&](int y) { return (size_t)y * W + x; };
  auto step = [&](float d, unsigned char v, int y) {
    return k7_vertical(d, v && in_col && box.row(y), MD);
  };

  // Fold: down appends each row, up prepends it.  The down fold so far at
  // each batch's start after the first (the function of the segment's rows
  // above it) is kept in the previous batch's last two rows of BL and BR,
  // scratch until the replay writes them.
  Fn dl = k7_ident<true>(), dh = k7_ident<false>(), ul = k7_ident<true>(),
     uh = k7_ident<false>();
  for (int yb = y0; yb < y1; yb += K7C_BATCH) {
    if (yb > y0) {
      BL[pix(yb - 2)] = dl.s;
      BL[pix(yb - 1)] = dl.m;
      BR[pix(yb - 2)] = dh.s;
      BR[pix(yb - 1)] = dh.m;
    }
    float d[K7C_BATCH];
    unsigned char v[K7C_BATCH];
#pragma unroll
    for (int u = 0; u < K7C_BATCH; ++u) {
      const size_t p = pix(min(yb + u, y1 - 1));
      d[u] = disp[p];
      v[u] = valid[p];
    }
#pragma unroll
    for (int u = 0; u < K7C_BATCH; ++u) {
      if (yb + u >= y1) break;
      const K7Vertical s = step(d[u], v[u], yb + u);
      dl = k7_then<true>(dl, s.lo);
      dh = k7_then<false>(dh, s.hi);
      ul = k7_then<true>(s.lo, ul);
      uh = k7_then<false>(s.hi, uh);
    }
  }
  sfn[0][c][seg] = dl;
  sfn[1][c][seg] = dh;
  sfn[2][c][seg] = ul;
  sfn[3][c][seg] = uh;
  __syncthreads();

  // Scan: a warp per chain and column, each lane K7C_PER_LANE segments.
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int chain = warp / K7C_COLS;
    Fn* f = sfn[chain][warp % K7C_COLS] + lane * K7C_PER_LANE;
    if (chain == 0) k7_segment_carries<true, false>(f, lane);
    else if (chain == 1) k7_segment_carries<false, false>(f, lane);
    else if (chain == 2) k7_segment_carries<true, true>(f, lane);
    else k7_segment_carries<false, true>(f, lane);
  }
  __syncthreads();

  // Replay, a batch at a time from the segment's last up: the down carry
  // into the batch (its kept fold applied to the segment's down carry),
  // each row's down carry-in (the initial bounds on row 0), then up,
  // combined with it; a pixel with a disparity keeps it, except on row YL,
  // where the up carry is max-/min-written into it after the down sweep
  // pinned it (`:872-881` runs after `:842-869`).
  const float in_lo = sfn[0][c][seg].m, in_hi = sfn[1][c][seg].m;
  float c_lo = sfn[2][c][seg].m, c_hi = sfn[3][c][seg].m;
  for (int yb = y0 + (y1 - y0 - 1) / K7C_BATCH * K7C_BATCH; yb >= y0 && y1 > y0;
       yb -= K7C_BATCH) {
    float dn_lo = in_lo, dn_hi = in_hi;
    if (yb > y0) {
      dn_lo = k7_apply<true>(Fn{BL[pix(yb - 2)], BL[pix(yb - 1)]}, in_lo);
      dn_hi = k7_apply<false>(Fn{BR[pix(yb - 2)], BR[pix(yb - 1)]}, in_hi);
    }
    float d[K7C_BATCH], dlo[K7C_BATCH], dhi[K7C_BATCH];
    bool mask[K7C_BATCH];
#pragma unroll
    for (int u = 0; u < K7C_BATCH; ++u) {
      const int y = min(yb + u, y1 - 1);
      d[u] = disp[pix(y)];
      mask[u] = valid[pix(y)] && in_col && box.row(y);
    }
#pragma unroll
    for (int u = 0; u < K7C_BATCH; ++u) {
      const int y = yb + u;
      dlo[u] = y > 0 ? dn_lo : K7_LO;
      dhi[u] = y > 0 ? dn_hi : K7_HI;
      const K7Vertical s = k7_vertical(d[u], mask[u], MD);
      dn_lo = k7_apply<true>(s.lo, dn_lo);
      dn_hi = k7_apply<false>(s.hi, dn_hi);
    }
#pragma unroll
    for (int u = K7C_BATCH - 1; u >= 0; --u) {
      const int y = yb + u;
      if (y >= y1) continue;
      const float up_lo = y < H - 1 ? c_lo : K7_LO;
      const float up_hi = y < H - 1 ? c_hi : K7_HI;
      if (mask[u] && d[u] != RTT_NOMATCH) {
        BL[pix(y)] = y == box.YL ? fmaxf(d[u], up_lo) : d[u];
        BR[pix(y)] = y == box.YL ? fminf(d[u], up_hi) : d[u];
      } else {
        BL[pix(y)] = fmaxf(dlo[u], up_lo);
        BR[pix(y)] = fminf(dhi[u], up_hi);
      }
      const K7Vertical s = k7_vertical(d[u], mask[u], MD);
      c_lo = k7_apply<true>(s.lo, c_lo);
      c_hi = k7_apply<false>(s.hi, c_hi);
    }
  }
}

// A row-pass warp's staging: its row's two maps and mask.
__host__ __device__ __forceinline__ size_t k7_row_bytes(int W) {
  return (size_t)W * 2 * sizeof(float) + (((size_t)W + 15) & ~(size_t)15);
}

// The row pass: a warp a row.  Forward: fold each lane's run of
// c <- op(c + s, b[x]) (s = fstep after a mask pixel, the sentinel after a
// gap), scan, replay; the replay also folds the backward functions, prepending
// each column: c <- op(c + bstep, op(b[x], T - x) + bstep) at mask pixels,
// the sentinel's reset elsewhere.  Backward: scan from the last lane, then
// replay, b[x] <- op(op(b[x], carry-in) + x, T).  The lower bound: op =
// max, fstep = -1, bstep = -max_step, T = the target's XL; the upper: min,
// max_step, 1, XR.
__global__ void __launch_bounds__(32 * K7R_ROWS)
propagate_bounds_rows_kernel(const unsigned char* __restrict__ valid,
                             const int* __restrict__ pYL, const int* __restrict__ pYR,
                             const int* __restrict__ pXL, const int* __restrict__ pXR,
                             const int* __restrict__ ptXL, const int* __restrict__ ptXR,
                             float* __restrict__ BL, float* __restrict__ BR, float MD,
                             int H, int W, int rows, int run) {
  extern __shared__ __align__(16) unsigned char k7_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y = blockIdx.x * rows + warp;
  if (y >= H) return;      // a whole warp; the pass has no block barrier
  float* bl = reinterpret_cast<float*>(k7_smem + warp * k7_row_bytes(W));
  float* br = bl + W;
  unsigned char* mk = reinterpret_cast<unsigned char*>(br + W);
  const Box box = load_box(pYL, pYR, pXL, pXR);
  const float TL = (float)*ptXL, TR = (float)*ptXR;
  const size_t row = (size_t)y * W;
#pragma unroll 8
  for (int x = lane; x < W; x += 32) {
    bl[x] = BL[row + x];
    br[x] = BR[row + x];
    mk[x] = valid[row + x] && box.row(y) && box.col(x);
  }
  __syncwarp();
  const int x0 = min(lane * run, W), x1 = min(x0 + run, W);

  Fn fl = k7_ident<true>(), fh = k7_ident<false>();
  for (int x = x0; x < x1; ++x) {
    const bool left = x > 0 && mk[x - 1];
    fl = k7_then<true>(fl, Fn{left ? -1.0f : -K7_BIG, bl[x]});
    fh = k7_then<false>(fh, Fn{left ? MD : K7_BIG, br[x]});
  }
  float cl = k7_lane_carry<true, false>(fl, lane);
  float ch = k7_lane_carry<false, false>(fh, lane);

  Fn gl = k7_ident<true>(), gh = k7_ident<false>();
  for (int x = x0; x < x1; ++x) {
    const bool left = x > 0 && mk[x - 1], m = mk[x] != 0;
    const float xf = (float)x;
    cl = k7_op<true>(__fadd_rn(cl, left ? -1.0f : -K7_BIG), bl[x]);
    ch = k7_op<false>(__fadd_rn(ch, left ? MD : K7_BIG), br[x]);
    bl[x] = cl;
    br[x] = ch;
    gl = k7_then<true>(Fn{m ? -MD : -K7_BIG,
                          m ? __fadd_rn(fmaxf(cl, __fsub_rn(TL, xf)), -MD) : -K7_BIG}, gl);
    gh = k7_then<false>(Fn{m ? 1.0f : K7_BIG,
                           m ? __fadd_rn(fminf(ch, __fsub_rn(TR, xf)), 1.0f) : K7_BIG}, gh);
  }
  cl = k7_lane_carry<true, true>(gl, lane);
  ch = k7_lane_carry<false, true>(gh, lane);

  for (int x = x1 - 1; x >= x0; --x) {
    const bool m = mk[x] != 0;
    const float xf = (float)x, bx_l = bl[x], bx_h = br[x];
    bl[x] = fmaxf(__fadd_rn(fmaxf(bx_l, x < W - 1 ? cl : -K7_BIG), xf), TL);
    br[x] = fminf(__fadd_rn(fminf(bx_h, x < W - 1 ? ch : K7_BIG), xf), TR);
    cl = fmaxf(__fadd_rn(cl, m ? -MD : -K7_BIG),
               m ? __fadd_rn(fmaxf(bx_l, __fsub_rn(TL, xf)), -MD) : -K7_BIG);
    ch = fminf(__fadd_rn(ch, m ? 1.0f : K7_BIG),
               m ? __fadd_rn(fminf(bx_h, __fsub_rn(TR, xf)), 1.0f) : K7_BIG);
  }
  __syncwarp();
#pragma unroll 8
  for (int x = lane; x < W; x += 32) {
    BL[row + x] = bl[x];
    BR[row + x] = br[x];
  }
}

// The geometry of K7 at H x W: columns a column-pass block, segments a
// column, rows a segment, columns a lane's run, rows a row-pass block, and
// the two passes' blocks.
struct K7Layout {
  int cols, segs, seg_rows, run, rows, col_blocks, row_blocks;
};

K7Layout k7_layout(int H, int W) {
  K7Layout g;
  g.cols = K7C_COLS;
  g.segs = K7C_SEGS;
  g.seg_rows = (H + K7C_SEGS - 1) / K7C_SEGS;
  g.run = (W + 31) / 32;
  g.run += 1 - g.run % 2;              // odd: lanes on distinct banks
  const int fit = (int)((size_t)K7R_SMEM / k7_row_bytes(W));
  g.rows = fit < 1 ? 1 : (fit > K7R_ROWS ? K7R_ROWS : fit);
  g.col_blocks = (W + K7C_COLS - 1) / K7C_COLS;
  g.row_blocks = (H + g.rows - 1) / g.rows;
  return g;
}

// Dynamic shared memory above the default 48 KB must be asked for.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

RTT_API int rtt_ordering(const void* disp, void* out, const void* YL, const void* YR,
                         const void* XL, const void* XR, int H, int W, void* stream) {
  if (W < 1 || W > RTT_CONSTRAINTS_MAX_W || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)W * K6_BYTES_PER_COLUMN;
  cudaError_t err = allow_smem(ordering_constraint_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ordering_constraint_kernel<<<H, K6_THREADS, smem, rtt_stream(stream)>>>(
      static_cast<const float*>(disp), static_cast<float*>(out),
      static_cast<const int*>(YL), static_cast<const int*>(YR),
      static_cast<const int*>(XL), static_cast<const int*>(XR), W);
  return static_cast<int>(cudaGetLastError());
}

RTT_API int rtt_propagate_bounds_layout(int H, int W, int* out) {
  if (W < 1 || W > RTT_CONSTRAINTS_MAX_W || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const K7Layout g = k7_layout(H, W);
  const int v[7] = {g.cols, g.segs, g.seg_rows, g.run, g.rows, g.col_blocks, g.row_blocks};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

RTT_API int rtt_propagate_bounds(const void* disp, const void* valid, const void* YL,
                                 const void* YR, const void* XL, const void* XR,
                                 const void* tXL, const void* tXR, void* BL, void* BR,
                                 float max_step, int H, int W, void* stream) {
  if (W < 1 || W > RTT_CONSTRAINTS_MAX_W || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const K7Layout g = k7_layout(H, W);
  const int* yl = static_cast<const int*>(YL);
  const int* yr = static_cast<const int*>(YR);
  const int* xl = static_cast<const int*>(XL);
  const int* xr = static_cast<const int*>(XR);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  float* bl = static_cast<float*>(BL);
  float* br = static_cast<float*>(BR);
  propagate_bounds_columns_kernel<<<g.col_blocks, K7C_THREADS, 0, rtt_stream(stream)>>>(
      static_cast<const float*>(disp), v, yl, yr, xl, xr, bl, br, max_step, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = g.rows * k7_row_bytes(W);
  err = allow_smem(propagate_bounds_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  propagate_bounds_rows_kernel<<<g.row_blocks, 32 * g.rows, smem, rtt_stream(stream)>>>(
      v, yl, yr, xl, xr, static_cast<const int*>(tXL), static_cast<const int*>(tXR), bl,
      br, max_step, H, W, g.rows, g.run);
  return static_cast<int>(cudaGetLastError());
}
