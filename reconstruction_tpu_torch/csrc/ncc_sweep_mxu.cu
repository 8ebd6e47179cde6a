// K5: the zero-mean NCC shift sweep with a running argmax, on the tensor
// cores.
//
// It replaces the TPU kernel `_mxu_kernel`
// (reconstruction_tpu/ops/ncc_sweep_mxu.py:68, launched by
// `ncc_sweep_match_mxu`), which computes K1's function with the window
// dot product as a matrix product:
//
//   cross[x, s] = sum_{c, dy, dx} L[y+dy, x+dx, c] R[y+dy, x+s+dx, c]
//               = WL[:, x] . WR[:, x+s]
//
// where WL, WR are the (2r+1)^2 C-tap im2col stacks of a row.  Contract
// kept from the TPU kernel: one shift range for the image, [s_min,
// s_min + cnt) clipped to +-pad_shift (computed by the wrapper on the
// card), visited in chunks of 128 shifts ascending from s_min, the last
// chunk at its full width; each pixel gated by active, its bounds and the
// target's validity; the first maximum wins.
//
// Exactness.  The images are centered uint8 values, integers in
// [-128, 127], exact in int8; products and their sums (< 2^24) are exact
// in int32 and again after conversion to float, whatever the order of the
// sums.  The score is K1's epilogue (`rtt_ncc_score`), so K5 is bit-equal
// to K1 wherever both visit the same shifts.  K5 checks every image value
// it converts (`rtt_int8`) and sets a flag for one off that grid, on which
// its wrapper raises: no pass of its own over the images.
//
// What bounds it on this card.  At the bench shape (1920x1280x3, r=2, one
// chunk) the products are 1920*1280*128*80*2 = 50 GOP, a few tens of
// microseconds of int8 tensor-core time.  What costs is what surrounds
// them: building the int8 im2col stacks in shared memory (80 taps for each
// of 272 target columns per row and chunk, from L1/L2), and the epilogue,
// which scores, gates and compares every (x, s) in the band one by one in
// the CUDA cores, ~2.3x the useful pairs because the band is cut into
// 16x16 fragments.
//
// What the design does about it.  One block per row and 128 pixels; eight
// warps, one 16-pixel fragment row each.  The TPU kernel computed a full
// (256 t x 128 x) f32 tile per chunk (128 KB a row) and extracted the
// shift band by a shear; here each warp multiplies only the 16x16 (pixel,
// target) fragments that meet its band (nvcuda::wmma, s8 -> s32,
// 16x16x16), and of those only the ones its pixels' bounds reach; it
// stores one fragment at a time to shared memory and runs the score, gate
// and argmax on it.  Each thread owns one pixel and one half of the
// fragment's columns, which it visits in ascending shift; the two halves
// are merged at the end by (max score, then smallest shift), the same as
// one first-maximum scan.  The rows a stack needs are staged once as an
// int8 slab (coalesced reads, zero padding), and the stack is gathered
// from it through a table of tap offsets, for the columns of the block's
// own shift range only.  A block skips the chunks that none of its active
// pixels' bounds reach.  None of the skips changes a result.
#include <mma.h>

#include <climits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int K5_XB = 128;                    // pixels per block (one row)
constexpr int K5_CHUNK = 128;                 // shifts per chunk
constexpr int K5_TB = K5_XB + K5_CHUNK + 16;  // target columns per chunk
constexpr int K5_WARPS = K5_XB / 16;          // one fragment row per warp
constexpr int K5_THREADS = 32 * K5_WARPS;
constexpr int K5_LDC = 20;                    // fragment store stride (ints)

// Rows y-r..y+r, columns x0-r .. x0+ncols+r-1 of an (H, W, C) image as
// int8 in shared memory, [row][col][c], zero outside the image (the
// reference's zero padding).  Consecutive threads read consecutive floats.
// Each value is checked as it converts: ``bad`` is set for one off the
// integer grid (rtt_int8).
__device__ void load_slab(signed char* __restrict__ slab,
                          const float* __restrict__ img, int y, int x0,
                          int ncols, int H, int W, int C, int r, bool& bad) {
  const int pitch = (ncols + 2 * r) * C;
  for (int q = threadIdx.x; q < (2 * r + 1) * pitch; q += K5_THREADS) {
    const int yy = y + q / pitch - r, xx = x0 - r + (q % pitch) / C;
    signed char v = 0;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = static_cast<signed char>(
          rtt_int8(img[((size_t)yy * W + xx) * C + q % C], bad));
    slab[q] = v;
  }
}

// Offset of tap k = (dy, dx, c), channel fastest, into a slab of ncols
// columns, relative to the slab entry of its column; -1 for the padding
// taps past (2r+1)^2 C.
__device__ void tap_offsets(int* __restrict__ tab, int ncols, int C, int r,
                            int taps, int kpad) {
  const int w = 2 * r + 1;
  for (int k = threadIdx.x; k < kpad; k += K5_THREADS) {
    const int q = k / C;
    tab[k] = k < taps ? ((q / w) * (ncols + 2 * r) + q % w) * C + k % C : -1;
  }
}

// The im2col stack of columns c_lo..c_hi, laid out [k-step][column][16
// taps] (each 16-column fragment is 256 contiguous bytes), four taps per
// store.
__device__ void im2col(signed char* __restrict__ dst,
                       const signed char* __restrict__ slab,
                       const int* __restrict__ tab, int ncols, int ksteps,
                       int C, int c_lo, int c_hi) {
  const int n = c_hi - c_lo + 1;
  for (int q = threadIdx.x; q < ksteps * n * 4; q += K5_THREADS) {
    const int part = q % 4, col = c_lo + (q / 4) % n, ks = q / (4 * n);
    const int* t = tab + ks * 16 + part * 4;
    const signed char* src = slab + col * C;
    char4 v;
    v.x = t[0] < 0 ? 0 : src[t[0]];
    v.y = t[1] < 0 ? 0 : src[t[1]];
    v.z = t[2] < 0 ? 0 : src[t[2]];
    v.w = t[3] < 0 ? 0 : src[t[3]];
    *reinterpret_cast<char4*>(dst + ((size_t)ks * ncols + col) * 16 + part * 4) = v;
  }
}

// Dynamic shared memory of one block, in bytes (before base alignment).
size_t k5_smem_bytes(int ksteps, int C, int r) {
  return (size_t)ksteps * (K5_XB + K5_TB) * 16 +        // im2col stacks
         sizeof(int) * K5_WARPS * 16 * K5_LDC +          // fragment stores
         sizeof(float) * 2 * K5_TB +                     // target moments
         sizeof(int) * 2 * ksteps * 16 +                 // tap offsets
         K5_TB +                                         // target validity
         (size_t)(2 * r + 1) * (K5_XB + K5_TB + 4 * r) * C;  // int8 slabs
}

__global__ void __launch_bounds__(K5_THREADS)
ncc_sweep_mxu_kernel(const float* __restrict__ L, const float* __restrict__ R,
                     const float* __restrict__ nmuL,
                     const float* __restrict__ invL,
                     const float* __restrict__ muR,
                     const float* __restrict__ invR,
                     const uint8_t* __restrict__ validR,
                     const uint8_t* __restrict__ active,
                     const int* __restrict__ lo, const int* __restrict__ hi,
                     const int* __restrict__ srange,
                     float* __restrict__ score, int* __restrict__ tbest,
                     int* __restrict__ off_grid, int H, int W, int C, int r) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // wmma tiles need 32-byte aligned pointers: align the base by hand.
  unsigned char* smem =
      smem_raw + ((128 - (reinterpret_cast<size_t>(smem_raw) & 127)) & 127);
  const int taps = (2 * r + 1) * (2 * r + 1) * C;
  const int ksteps = (taps + 15) / 16;
  signed char* sWL = reinterpret_cast<signed char*>(smem);   // ksteps*XB*16
  signed char* sWR = sWL + ksteps * K5_XB * 16;              // ksteps*TB*16
  int* sC = reinterpret_cast<int*>(sWR + ksteps * K5_TB * 16);
  float* sMu = reinterpret_cast<float*>(sC + K5_WARPS * 16 * K5_LDC);
  float* sInv = sMu + K5_TB;
  int* sTabL = reinterpret_cast<int*>(sInv + K5_TB);
  int* sTabR = sTabL + ksteps * 16;
  unsigned char* sV = reinterpret_cast<unsigned char*>(sTabR + ksteps * 16);
  signed char* sSlabL = reinterpret_cast<signed char*>(sV + K5_TB);
  signed char* sSlabR = sSlabL + (2 * r + 1) * (K5_XB + 2 * r) * C;
  __shared__ int s_lo, s_hi;
  __shared__ float s_best[2][K5_XB];
  __shared__ int s_t[2][K5_XB];

  const int y = blockIdx.y, xb0 = blockIdx.x * K5_XB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = lane % 16, half = lane / 16;
  const int f = warp;                        // this warp's pixel fragment
  const int x = xb0 + 16 * f + i;
  const size_t pix = (size_t)y * W + x;
  bool bad = false;   // a value read off the integer grid

  bool act = false;
  int plo = 0, phi = -1;
  float nmu = 0.0f, invl = 1.0f;
  if (x < W) {
    act = active[pix] != 0;
    plo = lo[pix];
    phi = hi[pix];
    nmu = nmuL[pix];
    invl = invL[pix];
  }
  // The warp's shift range, for skipping fragments no pixel of it reaches.
  int w_lo = act ? plo - x : INT_MAX, w_hi = act ? phi - x : INT_MIN;
  for (int o = 16; o > 0; o /= 2) {
    w_lo = min(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, o));
    w_hi = max(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, o));
  }
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = INT_MIN;
  }
  tap_offsets(sTabL, K5_XB, C, r, taps, ksteps * 16);
  tap_offsets(sTabR, K5_TB, C, r, taps, ksteps * 16);
  load_slab(sSlabL, L, y, xb0, K5_XB, H, W, C, r, bad);
  __syncthreads();
  if (act) {
    atomicMin(&s_lo, plo - x);
    atomicMax(&s_hi, phi - x);
  }
  im2col(sWL, sSlabL, sTabL, K5_XB, ksteps, C, 0, K5_XB - 1);
  __syncthreads();

  const int s_min = srange[0], n_chunks = (srange[1] + K5_CHUNK - 1) / K5_CHUNK;
  int* cw = sC + warp * 16 * K5_LDC;
  float best = -1.0f;
  int bt = -1;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int S0 = s_min + ci * K5_CHUNK;
    if (S0 + K5_CHUNK - 1 < s_lo || S0 > s_hi) continue;   // block-uniform
    const int t0 = xb0 + S0;                 // target column of local col 0
    load_slab(sSlabR, R, y, t0, K5_TB, H, W, C, r, bad);
    for (int j = threadIdx.x; j < K5_TB; j += K5_THREADS) {
      const int t = t0 + j;
      const bool in = t >= 0 && t < W;
      sMu[j] = in ? muR[(size_t)y * W + t] : 0.0f;
      sInv[j] = in ? invR[(size_t)y * W + t] : 1.0f;
      sV[j] = in ? validR[(size_t)y * W + t] : 0;
    }
    __syncthreads();
    // Local col = s - S0 + 16 f + i: only the columns of the block's own
    // shift range are ever scored; the stack elsewhere is left stale.
    im2col(sWR, sSlabR, sTabR, K5_TB, ksteps, C, max(s_lo, S0) - S0,
           min(min(s_hi, S0 + K5_CHUNK - 1) - S0 + K5_XB - 1, K5_TB - 1));
    __syncthreads();
    // Fragments g = f .. f+8 hold every (pixel of fragment f, shift of
    // the chunk); fragment g holds shifts S0 + 16 (g - f) - 15 .. + 15.
    for (int g = f; g <= f + 8; ++g) {
      const int g_s = S0 + 16 * (g - f);
      if (g_s + 15 < w_lo || g_s - 15 > w_hi) continue;      // warp-uniform
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
      wmma::fill_fragment(acc, 0);
      for (int ks = 0; ks < ksteps; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
        wmma::load_matrix_sync(a, sWL + ((size_t)ks * K5_XB + 16 * f) * 16, 16);
        wmma::load_matrix_sync(b, sWR + ((size_t)ks * K5_TB + 16 * g) * 16, 16);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(cw, acc, K5_LDC, wmma::mem_row_major);
      __syncwarp();
      if (act) {
        for (int jj = 0; jj < 8; ++jj) {
          const int j = half * 8 + jj;
          const int col = 16 * g + j;
          const int s = S0 + col - 16 * f - i;
          const int t = x + s;
          if (s >= S0 && s < S0 + K5_CHUNK && t >= plo && t <= phi &&
              sV[col] != 0) {
            const float sc = rtt_ncc_score(static_cast<float>(cw[i * K5_LDC + j]),
                                           nmu, sMu[col], invl, sInv[col]);
            if (sc > best) {  // strict: the first maximum wins
              best = sc;
              bt = t;
            }
          }
        }
      }
      __syncwarp();   // cw is rewritten by the next fragment
    }
    __syncthreads();  // the slab, stack and moments are rewritten next chunk
  }
  s_best[half][16 * f + i] = best;
  s_t[half][16 * f + i] = bt;
  __syncthreads();
  if (threadIdx.x < K5_XB && xb0 + (int)threadIdx.x < W) {
    const int p = threadIdx.x;
    float b = s_best[0][p];
    int t = s_t[0][p];
    const float b1 = s_best[1][p];
    const int t1 = s_t[1][p];
    if (b1 > b || (b1 == b && t1 >= 0 && t1 < t)) {
      b = b1;
      t = t1;
    }
    score[(size_t)y * W + xb0 + p] = b;
    tbest[(size_t)y * W + xb0 + p] = t;
  }
  if (bad) *off_grid = 1;
}

}  // namespace

RTT_API int rtt_ncc_sweep_mxu(const void* L, const void* R, const void* nmuL,
                              const void* invL, const void* muR,
                              const void* invR, const void* validR,
                              const void* active, const void* lo,
                              const void* hi, const void* srange, void* score,
                              void* tbest, void* off_grid, int H, int W, int C,
                              int r, void* stream) {
  const int ksteps = ((2 * r + 1) * (2 * r + 1) * C + 15) / 16;
  const size_t smem = k5_smem_bytes(ksteps, C, r) + 128;
  cudaError_t err = cudaFuncSetAttribute(
      ncc_sweep_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + K5_XB - 1) / K5_XB, H);
  ncc_sweep_mxu_kernel<<<grid, K5_THREADS, smem, rtt_stream(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<const float*>(nmuL), static_cast<const float*>(invL),
      static_cast<const float*>(muR), static_cast<const float*>(invR),
      static_cast<const uint8_t*>(validR), static_cast<const uint8_t*>(active),
      static_cast<const int*>(lo), static_cast<const int*>(hi),
      static_cast<const int*>(srange), static_cast<float*>(score),
      static_cast<int*>(tbest), static_cast<int*>(off_grid), H, W, C, r);
  return static_cast<int>(cudaGetLastError());
}
