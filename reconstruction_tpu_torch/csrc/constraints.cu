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
// What bounds them is the length of their dependency chains: K6's greedy
// loop is one step per deleted point of a row, each a block-wide argmax;
// K7 is H dependent steps down and up each column and W forward and
// backward along each row.
//
// What the design does about it.  K6 gives a row to a thread block: the
// row's valid points, compacted in column order, sit in shared memory as
// t (float), the crossing count (int, -1 once deleted) and the column
// (16 bits), 10 bytes a column.  The initial counts are O(V^2) over the V
// valid points, each thread counting for its own points.  A greedy step is
// one pass of each thread over its own points, which decrements the counts
// that cross the deleted point and keeps the thread's best (count, column)
// key for the next step; a warp reduction, one barrier and a read of the
// eight warps' keys find the next point.  The loop ends on the card when
// the largest count is 0: nothing is read back.
// K7 is two launches.  The column pass gives a column to a thread
// (neighbouring threads on neighbouring addresses) and loads eight rows
// ahead of its chain; it writes the vertical bounds into the outputs.  The
// row pass gives a row to a thread block, which stages the row's two maps
// and mask in shared memory with all its threads; thread 0 runs the lower
// bound's chains and thread 32 (another warp) the upper bound's, side by
// side, and the block writes the row back.
// The margins are read from device memory (0-d int32 tensors): the
// wrappers never read them back.
//
// Exactness.  K6 is comparisons and integer counts: bit-equal to its plain
// version.  K7's chains sum in another order than the scan tree; the sums
// that can win a max or a min at an output are sums of small integers,
// exact in any order, so the outputs equal the plain version's at every
// mask-valid source pixel (tests/test_torch_constraint_kernels.py).
#include "common.cuh"

#define RTT_CONSTRAINTS_MAX_W 16384   // ops/constraints.py MAX_WIDTH

namespace {

constexpr int K6_THREADS = 256;
constexpr int K6_WARPS = K6_THREADS / 32;
constexpr int K7_COL_THREADS = 32;
constexpr int K7_COL_BATCH = 8;    // rows a column thread loads ahead
constexpr int K7_ROW_THREADS = 128;
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

// A point's argmax key: larger count first, then smaller compacted index
// (the first maximum, as argmax takes it); -1 once deleted.
__device__ __forceinline__ int k6_key(int count, int i) {
  return count >= 0 ? (count << 16) | (0xFFFF - i) : -1;
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
  __shared__ int wsum[K6_WARPS];
  __shared__ int wkey[2][K6_WARPS];

  const int y = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Box box = load_box(pYL, pYR, pXL, pXR);
  const float* drow = disp + (size_t)y * W;
  float* orow = out + (size_t)y * W;

  // The row is copied; its valid points (inside the box, not NOMATCH) are
  // compacted in column order, a tile of K6_THREADS columns at a time.
  int V = 0;
  for (int x0 = 0; x0 < W; x0 += K6_THREADS) {
    const int x = x0 + tid;
    const float d = x < W ? drow[x] : RTT_NOMATCH;
    if (x < W) orow[x] = d;
    const bool valid = x < W && box.row(y) && box.col(x) && d != RTT_NOMATCH;
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) wsum[warp] = __popc(ballot);
    __syncthreads();
    int off = V, total = 0;
#pragma unroll
    for (int w = 0; w < K6_WARPS; ++w) {
      off += w < warp ? wsum[w] : 0;
      total += wsum[w];
    }
    if (valid) {
      const int p = off + __popc(ballot & ((1u << lane) - 1u));
      t[p] = __fadd_rn(d, (float)x);
      col[p] = (unsigned short)x;
    }
    V += total;
    __syncthreads();
  }
  if (V == 0) return;

  // Initial crossing counts, each thread for its own points.
  int best = -1;
  for (int i = tid; i < V; i += K6_THREADS) {
    const float ti = t[i];
    int c = 0;
#pragma unroll 8
    for (int j = 0; j < V; ++j) {
      const float tj = t[j];
      c += j < i ? (tj > ti) : (tj < ti);
    }
    cnt[i] = c;
    best = max(best, k6_key(c, i));
  }

  // The greedy loop: each thread updates only its own points, so the one
  // barrier a step is the one that publishes the warps' best keys (two
  // buffers, by the step's parity).
  for (int step = 0;; ++step) {
    const int wbest = __reduce_max_sync(0xffffffffu, best);
    if (lane == 0) wkey[step & 1][warp] = wbest;
    __syncthreads();
    int key = wkey[step & 1][0];
#pragma unroll
    for (int w = 1; w < K6_WARPS; ++w) key = max(key, wkey[step & 1][w]);
    if (key < 0x10000) break;   // the most crossings left on the row is 0
    const int k = 0xFFFF - (key & 0xFFFF);
    const float tk = t[k];
    best = -1;
    for (int i = tid; i < V; i += K6_THREADS) {
      int c = cnt[i];
      if (i == k) {
        c = -1;
        orow[col[k]] = RTT_NOMATCH;
      } else if (c >= 0 && (i < k ? t[i] > tk : t[i] < tk)) {
        --c;
      }
      cnt[i] = c;
      best = max(best, k6_key(c, i));
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

// One pixel's vertical step functions c -> max(c + s_lo, m_lo) and
// c -> min(c + s_hi, m_hi): a hole inside the mask decays the carry by
// max_step, a pixel with a disparity resets it to d -+ max_step, and a
// pixel outside the mask resets it to the initial bounds.
struct K7Vertical {
  float s_lo, m_lo, s_hi, m_hi;
};

__device__ __forceinline__ K7Vertical k7_vertical(float d, bool mask, float MD) {
  const bool has_d = mask && d != RTT_NOMATCH;
  const bool hole = mask && !has_d;
  K7Vertical v;
  v.s_lo = hole ? -MD : -K7_BIG;
  v.s_hi = hole ? MD : K7_BIG;
  v.m_lo = mask ? fmaxf(has_d ? __fsub_rn(d, MD) : K7_LO, K7_LO) : K7_LO;
  v.m_hi = mask ? fminf(has_d ? __fadd_rn(d, MD) : K7_HI, K7_HI) : K7_HI;
  return v;
}

__global__ void __launch_bounds__(K7_COL_THREADS)
propagate_bounds_columns_kernel(const float* __restrict__ disp,
                                const unsigned char* __restrict__ valid,
                                const int* __restrict__ pYL, const int* __restrict__ pYR,
                                const int* __restrict__ pXL, const int* __restrict__ pXR,
                                float* __restrict__ BL, float* __restrict__ BR,
                                float MD, int H, int W) {
  const int x = blockIdx.x * K7_COL_THREADS + threadIdx.x;
  if (x >= W) return;
  const Box box = load_box(pYL, pYR, pXL, pXR);
  const bool in_col = box.col(x);

  // Down: each row's carry-in (the initial bounds on row 0) is stored.
  float c_lo = -INFINITY, c_hi = INFINITY;
  for (int y0 = 0; y0 < H; y0 += K7_COL_BATCH) {
    float d[K7_COL_BATCH];
    bool v[K7_COL_BATCH];
#pragma unroll
    for (int u = 0; u < K7_COL_BATCH; ++u) {
      const size_t p = (size_t)min(y0 + u, H - 1) * W + x;
      d[u] = disp[p];
      v[u] = valid[p] != 0;
    }
#pragma unroll
    for (int u = 0; u < K7_COL_BATCH; ++u) {
      const int y = y0 + u;
      if (y >= H) break;
      const size_t p = (size_t)y * W + x;
      BL[p] = y > 0 ? c_lo : K7_LO;
      BR[p] = y > 0 ? c_hi : K7_HI;
      const K7Vertical s = k7_vertical(d[u], v[u] && in_col && box.row(y), MD);
      c_lo = fmaxf(__fadd_rn(c_lo, s.s_lo), s.m_lo);
      c_hi = fminf(__fadd_rn(c_hi, s.s_hi), s.m_hi);
    }
  }

  // Up: combined with the down carry; a pixel with a disparity keeps it,
  // except on row YL, where the up carry is max-/min-written into it
  // after the down sweep pinned it (`:872-881` runs after `:842-869`).
  c_lo = -INFINITY;
  c_hi = INFINITY;
  for (int y1 = H - 1; y1 >= 0; y1 -= K7_COL_BATCH) {
    float d[K7_COL_BATCH], dn_lo[K7_COL_BATCH], dn_hi[K7_COL_BATCH];
    bool v[K7_COL_BATCH];
#pragma unroll
    for (int u = 0; u < K7_COL_BATCH; ++u) {
      const size_t p = (size_t)max(y1 - u, 0) * W + x;
      d[u] = disp[p];
      v[u] = valid[p] != 0;
      dn_lo[u] = BL[p];
      dn_hi[u] = BR[p];
    }
#pragma unroll
    for (int u = 0; u < K7_COL_BATCH; ++u) {
      const int y = y1 - u;
      if (y < 0) break;
      const size_t p = (size_t)y * W + x;
      const float up_lo = y < H - 1 ? c_lo : K7_LO;
      const float up_hi = y < H - 1 ? c_hi : K7_HI;
      const bool mask = v[u] && in_col && box.row(y);
      if (mask && d[u] != RTT_NOMATCH) {
        BL[p] = y == box.YL ? fmaxf(d[u], up_lo) : d[u];
        BR[p] = y == box.YL ? fminf(d[u], up_hi) : d[u];
      } else {
        BL[p] = fmaxf(dn_lo[u], up_lo);
        BR[p] = fminf(dn_hi[u], up_hi);
      }
      const K7Vertical s = k7_vertical(d[u], mask, MD);
      c_lo = fmaxf(__fadd_rn(c_lo, s.s_lo), s.m_lo);
      c_hi = fminf(__fadd_rn(c_hi, s.s_hi), s.m_hi);
    }
  }
}

// One bound's row chains in shared memory: forward, c <- op(c + s, b[x])
// with s = fstep after a mask pixel and the sentinel after a gap; then
// backward, with b[x] <- op(op(b[x], carry-in) + x, T) and the carry
// c <- op(c + bstep, op(b[x], T - x) + bstep) at mask pixels, reset by the
// sentinel elsewhere.  The lower bound: op = max, fstep = -1, bstep =
// -max_step, T = the target's XL; the upper: min, max_step, 1, XR.
template <bool IS_MAX>
__device__ void k7_row_chains(float* b, const unsigned char* mk, float fstep, float bstep,
                              float T, int W) {
  const float sentinel = IS_MAX ? -K7_BIG : K7_BIG;
  float c = IS_MAX ? -INFINITY : INFINITY;
#pragma unroll 4
  for (int x = 0; x < W; ++x) {
    const float s = x > 0 && mk[x - 1] ? fstep : sentinel;
    c = k7_op<IS_MAX>(__fadd_rn(c, s), b[x]);
    b[x] = c;
  }
  c = IS_MAX ? -INFINITY : INFINITY;
#pragma unroll 4
  for (int x = W - 1; x >= 0; --x) {
    const float xf = (float)x, bx = b[x];
    const bool m = mk[x] != 0;
    const float inc = x < W - 1 ? c : sentinel;
    b[x] = k7_op<IS_MAX>(__fadd_rn(k7_op<IS_MAX>(bx, inc), xf), T);
    const float mv = m ? __fadd_rn(k7_op<IS_MAX>(bx, __fsub_rn(T, xf)), bstep) : sentinel;
    c = k7_op<IS_MAX>(__fadd_rn(c, m ? bstep : sentinel), mv);
  }
}

__global__ void __launch_bounds__(K7_ROW_THREADS)
propagate_bounds_rows_kernel(const unsigned char* __restrict__ valid,
                             const int* __restrict__ pYL, const int* __restrict__ pYR,
                             const int* __restrict__ pXL, const int* __restrict__ pXR,
                             const int* __restrict__ ptXL, const int* __restrict__ ptXR,
                             float* __restrict__ BL, float* __restrict__ BR, float MD,
                             int W) {
  extern __shared__ __align__(16) unsigned char k7_smem[];
  float* bl = reinterpret_cast<float*>(k7_smem);
  float* br = bl + W;
  unsigned char* mk = reinterpret_cast<unsigned char*>(br + W);
  const int y = blockIdx.x;
  const Box box = load_box(pYL, pYR, pXL, pXR);
  const size_t row = (size_t)y * W;
  for (int x = threadIdx.x; x < W; x += K7_ROW_THREADS) {
    bl[x] = BL[row + x];
    br[x] = BR[row + x];
    mk[x] = valid[row + x] && box.row(y) && box.col(x);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    k7_row_chains<true>(bl, mk, -1.0f, -MD, (float)*ptXL, W);
  else if (threadIdx.x == 32)
    k7_row_chains<false>(br, mk, MD, 1.0f, (float)*ptXR, W);
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += K7_ROW_THREADS) {
    BL[row + x] = bl[x];
    BR[row + x] = br[x];
  }
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
  const size_t smem = (size_t)W * (sizeof(float) + sizeof(int) + sizeof(unsigned short));
  cudaError_t err = allow_smem(ordering_constraint_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ordering_constraint_kernel<<<H, K6_THREADS, smem, rtt_stream(stream)>>>(
      static_cast<const float*>(disp), static_cast<float*>(out),
      static_cast<const int*>(YL), static_cast<const int*>(YR),
      static_cast<const int*>(XL), static_cast<const int*>(XR), W);
  return static_cast<int>(cudaGetLastError());
}

RTT_API int rtt_propagate_bounds(const void* disp, const void* valid, const void* YL,
                                 const void* YR, const void* XL, const void* XR,
                                 const void* tXL, const void* tXR, void* BL, void* BR,
                                 float max_step, int H, int W, void* stream) {
  if (W < 1 || W > RTT_CONSTRAINTS_MAX_W || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* yl = static_cast<const int*>(YL);
  const int* yr = static_cast<const int*>(YR);
  const int* xl = static_cast<const int*>(XL);
  const int* xr = static_cast<const int*>(XR);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  float* bl = static_cast<float*>(BL);
  float* br = static_cast<float*>(BR);
  propagate_bounds_columns_kernel<<<(W + K7_COL_THREADS - 1) / K7_COL_THREADS,
                                    K7_COL_THREADS, 0, rtt_stream(stream)>>>(
      static_cast<const float*>(disp), v, yl, yr, xl, xr, bl, br, max_step, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)W * (2 * sizeof(float) + 1);
  err = allow_smem(propagate_bounds_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  propagate_bounds_rows_kernel<<<H, K7_ROW_THREADS, smem, rtt_stream(stream)>>>(
      v, yl, yr, xl, xr, static_cast<const int*>(tXL), static_cast<const int*>(tXR), bl,
      br, max_step, W);
  return static_cast<int>(cudaGetLastError());
}
