// Per-request LoRA delta for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel lora_delta_fused of
// thunder_tpu/executors/pallasex.py (:1740; body _lora_delta_kernel :1731,
// pallas_call :1756): for each request b of the batch,
//
//   out[b] = scaling * (x[b] . A[b]^T) . B[b]^T
//
// with x (B, T, fin) at the compute dtype, A (B, r, fin) and B (B, fout, r)
// at the registry's dtype, out (B, T, fout) at x's dtype.  The dtype flow is
// the reference's (_lora_delta_kernel, models/generate.py _lora_delta):
// A and B are rounded to x's dtype first; d = x . A^T accumulates in float32
// and rounds to x's dtype; d . B^T accumulates in float32 and rounds; the
// product times scaling (itself rounded to x's dtype, as a weakly typed
// Python scalar is in JAX) is taken in float32 and rounded once more.  A
// request on the all-zero base slot gets an exact 0.0 delta.
//
// What bounds it on an H100: bytes.  At the Llama-3-8B decode shape (B = 8,
// T = 1, fin = fout = 4096, r = 16, float32 factors) the factors are 4 MB
// and the work 2 MFLOP; at the chunk shape (T = 512) the operations grow to
// ~0.13 GFLOP, still far under the byte time.
//
// Design (simple and right first):
//   * Grid (request x row tile of kRows rows, fout split).  The TPU kernel
//     holds one request's whole (T, fin) slab in VMEM; a Hopper block holds
//     its rows' d = x . A^T in shared memory one rank chunk at a time
//     (kRows x kRankChunk floats, rounded to x's dtype): one warp per
//     (row, rank) pair, lanes striding over fin (coalesced x and A rows), a
//     butterfly sum.  Any rank runs: each thread keeps one f32 accumulator
//     per output element of its column across the chunks, adding the ranks
//     in order (the sum a single chunk took before), and rounds and scales
//     once at the end, as the reference does.
//   * The block walks fout tiles of kCols columns (tile = blockIdx.y,
//     + gridDim.y, ...): each chunk of the tile's B rows loads into shared
//     memory (rounded, rows padded to kRankChunk + 1 floats against bank
//     conflicts), and each thread computes one output column for every row
//     of the tile.  With one chunk (r <= kRankChunk) d is computed once per
//     block; with several, once per chunk and tile.  The wrapper sets the
//     fout split so that the grid has about two blocks per SM: at the
//     decode shape each block takes one tile, at the chunk shape a few.
//   * A and B may be per-layer views of a (B, L, ...) stack: the wrapper
//     passes each factor's stride between requests; rows within a request
//     are contiguous.

#include "common.cuh"

namespace {

using tt::from_f;
using tt::round_to;
using tt::to_f;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = kThreads;  // one output column per thread
constexpr int kRows = 16;        // rows of x per block
constexpr int kRankChunk = 64;  // ranks per chunk: shared memory stays under 48 KB

template <typename TX, typename TF>
__global__ void __launch_bounds__(kThreads)
lora_delta_kernel(const TX* __restrict__ x, const TF* __restrict__ a,
                  const TF* __restrict__ b, TX* __restrict__ out, int T, int fin, int fout,
                  int r, long long a_bstride, long long b_bstride, int row_tiles,
                  float scaling) {
  extern __shared__ float smem[];
  float* sd = smem;                       // (kRows, kRankChunk): d, rounded to TX
  float* sb = smem + kRows * kRankChunk;  // (kCols, kRankChunk + 1): B, rounded to TX
  const int req = blockIdx.x / row_tiles;
  const int t0 = (blockIdx.x % row_tiles) * kRows;
  const int nt = min(kRows, T - t0);
  const size_t row0 = static_cast<size_t>(req) * T + t0;
  const TX* xr = x + row0 * fin;
  const TF* ar = a + static_cast<size_t>(req) * a_bstride;
  const TF* br = b + static_cast<size_t>(req) * b_bstride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_chunks = (r + kRankChunk - 1) / kRankChunk;

  // d[t][j] = round(sum_k x[t][k] * round(A[j0 + j][k])), f32 accumulation
  auto rank_chunk = [&](int j0, int rc) {
    for (int p = warp; p < nt * rc; p += kWarps) {
      const int t = p / rc, j = p % rc;
      const TX* xt = xr + static_cast<size_t>(t) * fin;
      const TF* aj = ar + static_cast<size_t>(j0 + j) * fin;
      float acc = 0.f;
      for (int k = lane; k < fin; k += 32) {
        acc = fmaf(to_f<TX>(xt[k]), round_to<TX>(to_f<TF>(aj[k])), acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) sd[t * kRankChunk + j] = round_to<TX>(acc);
    }
  };
  if (n_chunks == 1) rank_chunk(0, r);

  const float sc = round_to<TX>(scaling);
  const int n_tiles = (fout + kCols - 1) / kCols;
  const int c = threadIdx.x;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int c0 = tile * kCols;
    const int nc = min(kCols, fout - c0);
    const TF* bt = br + static_cast<size_t>(c0) * r;
    float acc[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) acc[t] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int j0 = ch * kRankChunk, rc = min(kRankChunk, r - j0);
      __syncthreads();  // the last chunk's d and B are no longer read
      if (n_chunks > 1) rank_chunk(j0, rc);
      for (int i = threadIdx.x; i < nc * rc; i += kThreads) {
        const int col = i / rc, j = i % rc;
        sb[col * (kRankChunk + 1) + j] =
            round_to<TX>(to_f<TF>(bt[static_cast<size_t>(col) * r + j0 + j]));
      }
      __syncthreads();
      if (c < nc) {
        const float* bc = sb + c * (kRankChunk + 1);
        for (int j = 0; j < rc; ++j) {
          const float bj = bc[j];
#pragma unroll
          for (int t = 0; t < kRows; ++t) {
            if (t < nt) acc[t] = fmaf(sd[t * kRankChunk + j], bj, acc[t]);
          }
        }
      }
    }
    if (c < nc) {
      TX* oc = out + row0 * fout + c0 + c;
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        if (t < nt) {
          oc[static_cast<size_t>(t) * fout] = from_f<TX>(__fmul_rn(round_to<TX>(acc[t]), sc));
        }
      }
    }
  }
}

template <typename TX, typename TF>
cudaError_t launch_lora(const void* x, const void* a, const void* b, void* out, int B, int T,
                        int fin, int fout, int r, long long a_bstride, long long b_bstride,
                        int n_split, float scaling, cudaStream_t stream) {
  const int row_tiles = (T + kRows - 1) / kRows;
  const size_t smem = sizeof(float) * (kRows * kRankChunk + kCols * (kRankChunk + 1));
  lora_delta_kernel<TX, TF><<<dim3(B * row_tiles, n_split), kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TF*>(a), static_cast<const TF*>(b),
      static_cast<TX*>(out), T, fin, fout, r, a_bstride, b_bstride, row_tiles, scaling);
  return cudaGetLastError();
}

}  // namespace

// x (B, T, fin) contiguous; a: B rows of (r, fin), request b's at
// a + b * a_bstride elements; b: B rows of (fout, r) at b_bstride; out
// (B, T, fout) contiguous at x's dtype.  Dtype codes 0 = float32,
// 1 = float16, 2 = bfloat16 (x_dtype for x and out, f_dtype for a and b).
// r >= 1; n_split: blocks along fout (1 .. ceil(fout / 128)).
extern "C" int tt_lora_delta(const void* x, const void* a, const void* b, void* out, int B,
                             int T, int fin, int fout, int r, long long a_bstride,
                             long long b_bstride, int n_split, float scaling, int x_dtype,
                             int f_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || T == 0 || fout == 0) return cudaSuccess;
  if (r < 1 || fin < 1 || n_split < 1) return cudaErrorInvalidValue;
  return tt::by_float(x_dtype, [&](auto tx) {
    return tt::by_float(f_dtype, [&](auto tf) -> cudaError_t {
      using TX = decltype(tx);
      using TF = decltype(tf);
      return launch_lora<TX, TF>(x, a, b, out, B, T, fin, fout, r, a_bstride, b_bstride,
                                 n_split, scaling, s);
    });
  });
}
