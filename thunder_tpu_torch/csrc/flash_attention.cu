// Flash attention, forward and backward, for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces the three Pallas TPU kernels of thunder_tpu/executors/pallasex.py
// that one training step runs (the SDPA prim and its backward rule):
//
//   tt_flash_fwd      _flash_fwd (pallasex.py:293, pallas_call :322, body
//                     _fwd_kernel :211): out = softmax(q k^T * scale + mask)
//                     v and lse = m + log l, one online-softmax walk over key
//                     tiles.
//   tt_flash_bwd_dq   _flash_bwd's dq kernel (pallasex.py:460, pallas_call
//                     :495, body _bwd_dq_kernel :349): p = exp(s - lse),
//                     dp = g v^T, ds = p (dp - delta), dq = scale * ds k.
//   tt_flash_bwd_dkv  _flash_bwd's dk/dv kernel (pallas_call :526, body
//                     _bwd_dkv_kernel :401): dv = p^T g, dk = scale * ds^T q,
//                     summed over the rep q heads of each KV group.
//
// q (BH, Tq, hs), k/v (BG, Tk, hs): q head b*H + h reads KV group
// b*G + h / (H/G) (_kv_index, :266).  The additive mask is (M, mq, Tk) f32 in
// the four _canon_mask layouts (shared, batch = flat / H, head = flat % H,
// full), mq 1 or Tq.  Causal is top-left (row >= col in global indices, also
// when Tq != Tk); a sliding window keeps col > row - window.  Masked scores
// take the finite mask value -0.7*FLT_MAX, as in the Pallas kernels, so a row
// masked whole by an additive mask averages V uniformly.
//
// What bounds them on an H100: at the training shape (Llama-3-8B, B=1,
// T=2048, 32 heads over 8 groups, hs 128, causal) the forward does
// 4*nh*hs*T^2/2 = 34.4 GFLOP against ~50 MB of q/k/v/out: operations
// (34.7 us at 989 TFLOP/s).  The dq kernel recomputes S and dP and forms dS.K
// (three products, 51.5 GFLOP), the dk/dv kernel S, dP, P^T.G and dS^T.Q
// (four, 68.7 GFLOP): operations too.
//
// Three bodies; the wrapper picks one (cudaex.flash_body):
//
// The warpgroup body (bf16 at hs 64 or 128: the training path).  Hopper's
// wgmma with every accumulator in registers (wgmma.cuh):
//   * A block is two warpgroups of 128 threads.  Forward and dq: each owns
//     64 query rows of one q head (the block 128 consecutive rows) and walks
//     64-key K/V tiles; dk/dv: each owns 64 keys of one KV group (the block
//     128) and walks 64-row Q/dO tiles of the group's q heads, heads in
//     order, tiles in order.  Each warpgroup keeps its own two-stage ring
//     in shared memory, filled by cp.async (16 bytes a thread, written in
//     the 128-byte swizzle the wgmma descriptors read) one tile ahead of the
//     tile it computes, and synchronises only its own 128 threads (named
//     barriers), so the two warpgroups drift apart and one's softmax
//     overlaps the other's products.
//   * S = Q.K^T (dk/dv: S^T = K.Q^T, dP^T = V.dO^T) is an m64n64k16 wgmma
//     with both operands K-major in shared memory; S stays in registers.
//     The online softmax runs there: row max and sum over the four lanes
//     that hold a row (quad shuffles), exp2 of (x - m) * log2(e); a lane
//     keeps its share of the row sum and the quad adds them at the end.
//   * The probabilities (dq: dS; dk/dv: P^T and dS^T), rounded to bf16 in
//     registers, are the register A operand of the next product, with V (K,
//     dO, Q) read MN-major from shared memory: an accumulator's layout is the
//     A operand's, two values to a register, no shuffle.  O (dq, dK and dV)
//     accumulate in f32 registers; the output is written once.
//   * Masks: tiles above the causal diagonal (or past the window) are
//     skipped per warpgroup, exactly the plain version's 64 x 64 skips; only
//     tiles that an edge or an additive mask crosses do per-element mask
//     work.  The mask value stays -0.7*FLT_MAX in the natural-log domain
//     (scaled by log2(e) it would overflow to -inf).
//   * Balance: a causal grid walks its longest tiles first (the forward and
//     dq the last query tiles, dk/dv the first key tiles), and dk/dv splits
//     each KV group's q heads between two blocks when rep is even: twice the
//     blocks, so the first key tiles (which see every query tile) do not
//     pace one lopsided wave.  The two f32 partials are added in split order
//     by flash_dkv_sum_kernel: no atomics, bitwise the same run to run.
//   * Not done: TMA (cp.async needs no tensor map), producer warps and
//     setmaxnreg, overlapping a warpgroup's softmax with its own products.
//
// The WMMA body (other bf16 head sizes that are multiples of 16) and the
// scalar body (float32), simple and right first:
//   * The Pallas kernels carry (BQ, hs) f32 accumulators across a sequential
//     grid axis with BQ up to 512: 256 KB at hs 128, past the 227 KB a Hopper
//     block may use, and Hopper blocks run in no order.  So each block owns
//     one (q head, R query rows) -- one (KV group, KT keys) for dk/dv -- and
//     walks the other axis in a loop inside the block.  R and KT (16, 32 or
//     64) are picked by the wrapper so the block's shared memory fits; hs up
//     to 512 runs unpadded.
//   * Tiles live in shared memory: the operands in the input type, the
//     accumulators and scores in f32.  Every product is one block-wide tile
//     product: on WMMA 16x16x16 tensor-core tiles with f32 accumulation (the
//     Pallas dot_general with preferred_element_type=f32) in the WMMA body
//     (rows padded by 16 bytes against bank conflicts), on scalar FMAs in
//     the scalar body.
//   * dk/dv: the Pallas kernel writes per-q-head dk/dv and lets XLA sum the
//     rep heads (:547-550).  Here one block sums them in a fixed order in its
//     f32 accumulators: no (BH, Tk, hs) buffer, no atomics, and the result is
//     bitwise the same from run to run.
//
// Every body keeps the Pallas kernels' rounding points: p cast to the value
// type before P.V (:257), ds to the key type before dS.K (:393), p to the
// gradient type for dv (:443), ds to the query type for dk (:450); lse and
// delta (= sum g*out, computed by the wrapper) are f32.  Causal tiles above
// the diagonal, and with a window the tiles wholly below the band, are
// skipped (:229-231).

#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using tt::from_f;
using tt::kMaskValue;
using tt::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // shared memory a Hopper block may use

// Everything a block needs besides the tensors.
struct Geometry {
  int H, G, Tq, Tk, hs;
  int mask_mode, mq;  // mask_mode: -1 no mask, 0 shared, 1 batch, 2 head, 3 full
  int causal, window;  // window 0: none
  int R, KT;           // query rows and keys per tile
  float scale;
};

// Row padding of the shared buffers, in elements: 16 bytes for 16-bit
// operands and 4 floats for f32 on the tensor-core path (keeps every WMMA
// fragment 32-byte aligned); one element on the scalar path (odd strides,
// no bank conflicts).
template <typename T, bool MMA> __host__ __device__ constexpr int tpad() {
  return MMA ? 16 / static_cast<int>(sizeof(T)) : 1;
}
template <bool MMA> __host__ __device__ constexpr int fpad() { return MMA ? 4 : 1; }

size_t align128(size_t n) { return (n + 127) & ~static_cast<size_t>(127); }

// Bytes of shared memory of each kernel.  The kernels carve their buffers
// in the same order, each rounded up to 128 bytes.
template <typename T, bool MMA> size_t fwd_smem(int R, int KT, int hs) {
  const size_t t = sizeof(T), tp = tpad<T, MMA>(), fp = fpad<MMA>();
  return align128(t * R * (hs + tp)) + 2 * align128(t * KT * (hs + tp)) +
         align128(4 * R * (hs + fp)) + align128(4 * R * (KT + fp)) + align128(t * R * (KT + tp)) +
         2 * align128(4 * R);
}
template <typename T, bool MMA> size_t dq_smem(int R, int KT, int hs) {
  const size_t t = sizeof(T), tp = tpad<T, MMA>(), fp = fpad<MMA>();
  return 2 * align128(t * R * (hs + tp)) + 2 * align128(t * KT * (hs + tp)) +
         align128(4 * R * (hs + fp)) + 2 * align128(4 * R * (KT + fp)) +
         align128(t * R * (KT + tp)) + 2 * align128(4 * R);
}
template <typename T, bool MMA> size_t dkv_smem(int R, int KT, int hs) {
  const size_t t = sizeof(T), tp = tpad<T, MMA>(), fp = fpad<MMA>();
  return 2 * align128(t * KT * (hs + tp)) + 2 * align128(t * R * (hs + tp)) +
         2 * align128(4 * KT * (hs + fp)) + 2 * align128(4 * KT * (R + fp)) +
         2 * align128(t * KT * (R + tp)) + 2 * align128(4 * R);
}

// Hands out consecutive 128-byte-aligned pieces of dynamic shared memory.
struct Carve {
  unsigned char* base;
  size_t off;
  template <typename U> __device__ U* take(int n) {
    U* p = reinterpret_cast<U*>(base + off);
    off += (static_cast<size_t>(n) * sizeof(U) + 127) & ~static_cast<size_t>(127);
    return p;
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The additive mask's (mq, Tk) slice for flat q head bh, or nullptr.
__device__ __forceinline__ const float* mask_base(const float* mask, const Geometry& g, int bh) {
  if (mask == nullptr || g.mask_mode < 0) return nullptr;
  const int m = g.mask_mode == 0 ? 0 : g.mask_mode == 1 ? bh / g.H : g.mask_mode == 2 ? bh % g.H : bh;
  return mask + static_cast<int64_t>(m) * g.mq * g.Tk;
}

__device__ __forceinline__ float mask_at(const float* mb, const Geometry& g, int row, int col) {
  return mb[(g.mq == 1 ? 0 : static_cast<int64_t>(row) * g.Tk) + col];
}

__device__ __forceinline__ bool keep(const Geometry& g, int row, int col) {
  return !g.causal || (row >= col && (g.window <= 0 || col > row - g.window));
}

// Key tiles [j0, j1) that the query rows [row0, row0 + R) attend.
__device__ __forceinline__ void key_tiles(const Geometry& g, int row0, int& j0, int& j1) {
  j0 = 0;
  j1 = g.Tk / g.KT;
  if (g.causal) j1 = min(j1, (row0 + g.R - 1) / g.KT + 1);
  if (g.window > 0) {
    const int lo = row0 - g.window - g.KT + 2;  // first tile: j * KT >= lo
    if (lo > 0) j0 = (lo + g.KT - 1) / g.KT;
  }
}

// Query tiles [i0, i1) that attend the keys [kt0, kt0 + KT).
__device__ __forceinline__ void query_tiles(const Geometry& g, int kt0, int& i0, int& i1) {
  i0 = g.causal ? kt0 / g.R : 0;
  i1 = g.Tq / g.R;
  if (g.window > 0) i1 = min(i1, (kt0 + g.KT + g.window - 2) / g.R + 1);
}

// rows x hs elements from global memory (rows contiguous) into shared rows
// of stride ld.
template <typename T, bool MMA>
__device__ void load_rows(T* dst, int ld, const T* __restrict__ src, int rows, int hs) {
  if constexpr (MMA) {
    constexpr int vec = 16 / sizeof(T);
    for (int i = threadIdx.x * vec; i < rows * hs; i += kThreads * vec) {
      const int r = i / hs, d = i - r * hs;
      *reinterpret_cast<uint4*>(dst + r * ld + d) = *reinterpret_cast<const uint4*>(src + i);
    }
  } else {
    for (int i = threadIdx.x; i < rows * hs; i += kThreads) {
      const int r = i / hs;
      dst[r * ld + i - r * hs] = src[i];
    }
  }
}

// C (M x N, f32, stride ldc) = [C +] A . B over the whole block.  A is M x K
// row-major (stride lda); B is K x N row-major (stride ldb), or with BT the
// transpose of an N x K row-major array (stride ldb).  On the tensor-core
// path M, N and K are multiples of 16 and each warp owns whole 16x16 tiles.
template <typename T, bool MMA, bool BT, bool ACC>
__device__ void block_gemm(float* C, int ldc, const T* A, int lda, const T* B, int ldb, int M,
                           int N, int K) {
  if constexpr (MMA) {
    namespace wmma = nvcuda::wmma;
    using BLayout = std::conditional_t<BT, wmma::col_major, wmma::row_major>;
    const int warp = threadIdx.x >> 5, tn = N / 16, tiles = (M / 16) * tn;
    for (int t = warp; t < tiles; t += kWarps) {
      const int i0 = (t / tn) * 16, j0 = (t % tn) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if constexpr (ACC) {
        wmma::load_matrix_sync(c, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(c, 0.f);
      }
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, BLayout> b;
        wmma::load_matrix_sync(a, A + i0 * lda + k0, lda);
        if constexpr (BT) {
          wmma::load_matrix_sync(b, B + j0 * ldb + k0, ldb);
        } else {
          wmma::load_matrix_sync(b, B + k0 * ldb + j0, ldb);
        }
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + i0 * ldc + j0, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < M * N; i += kThreads) {
      const int r = i / N, c = i - r * N;
      const T* a = A + r * lda;
      float s = 0.f;
      if constexpr (BT) {
        const T* b = B + c * ldb;
        for (int k = 0; k < K; ++k) s += to_f<T>(a[k]) * to_f<T>(b[k]);
      } else {
        for (int k = 0; k < K; ++k) s += to_f<T>(a[k]) * to_f<T>(B[k * ldb + c]);
      }
      C[r * ldc + c] = ACC ? C[r * ldc + c] + s : s;
    }
  }
}

// grid (Tq / R, BH), block kThreads.
template <typename T, bool MMA>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ mask, T* __restrict__ out,
                     float* __restrict__ lse, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = g.R, KT = g.KT, hs = g.hs;
  const int ldt = hs + tpad<T, MMA>(), lda = hs + fpad<MMA>();
  const int lds = KT + fpad<MMA>(), ldp = KT + tpad<T, MMA>();
  Carve cv{smem, 0};
  T* qs = cv.take<T>(R * ldt);
  T* ks = cv.take<T>(KT * ldt);
  T* vs = cv.take<T>(KT * ldt);
  float* acc = cv.take<float>(R * lda);
  float* sc = cv.take<float>(R * lds);
  T* pb = cv.take<T>(R * ldp);
  float* m = cv.take<float>(R);
  float* l = cv.take<float>(R);

  const int bh = blockIdx.y, row0 = blockIdx.x * R;
  const int bg = (bh / g.H) * g.G + (bh % g.H) / (g.H / g.G);
  const int64_t qoff = (static_cast<int64_t>(bh) * g.Tq + row0) * hs;
  const T* kg = k + static_cast<int64_t>(bg) * g.Tk * hs;
  const T* vg = v + static_cast<int64_t>(bg) * g.Tk * hs;
  const float* mb = mask_base(mask, g, bh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_rows<T, MMA>(qs, ldt, q + qoff, R, hs);
  for (int i = threadIdx.x; i < R * lda; i += kThreads) acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m[r] = kMaskValue;
    l[r] = 0.f;
  }
  int j0, j1;
  key_tiles(g, row0, j0, j1);
  for (int j = j0; j < j1; ++j) {
    const int c0 = j * KT;
    __syncthreads();  // the last tile's readers are done
    load_rows<T, MMA>(ks, ldt, kg + static_cast<int64_t>(c0) * hs, KT, hs);
    load_rows<T, MMA>(vs, ldt, vg + static_cast<int64_t>(c0) * hs, KT, hs);
    __syncthreads();
    block_gemm<T, MMA, true, false>(sc, lds, qs, ldt, ks, ldt, R, KT, hs);  // S = Q K^T
    __syncthreads();
    // one online-softmax step per row, a warp per row
    for (int r = warp; r < R; r += kWarps) {
      float* s = sc + r * lds;
      const int row = row0 + r;
      const float m_old = m[r];
      float mx = m_old;
      for (int c = lane; c < KT; c += 32) {
        const int col = c0 + c;
        float x = s[c] * g.scale;
        if (mb != nullptr) x += mask_at(mb, g, row, col);
        if (!keep(g, row, col)) x = kMaskValue;
        s[c] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int c = lane; c < KT; c += 32) {
        const float e = expf(s[c] - mx);
        pb[r * ldp + c] = from_f<T>(e);
        sum += e;
      }
      sum = warp_sum(sum);
      const float corr = expf(m_old - mx);
      for (int d = lane; d < hs; d += 32) acc[r * lda + d] *= corr;
      if (lane == 0) {
        l[r] = l[r] * corr + sum;
        m[r] = mx;
      }
    }
    __syncthreads();
    block_gemm<T, MMA, false, true>(acc, lda, pb, ldp, vs, ldt, R, hs, KT);  // acc += P V
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * hs; i += kThreads) {
    const int r = i / hs;
    out[qoff + i] = from_f<T>(acc[r * lda + i - r * hs] / l[r]);
  }
  for (int r = threadIdx.x; r < R; r += kThreads)
    lse[static_cast<int64_t>(bh) * g.Tq + row0 + r] = m[r] + logf(l[r]);
}

// grid (Tq / R, BH), block kThreads.
template <typename T, bool MMA>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ go, const T* __restrict__ q,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ mask, T* __restrict__ dq, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = g.R, KT = g.KT, hs = g.hs;
  const int ldt = hs + tpad<T, MMA>(), lda = hs + fpad<MMA>();
  const int lds = KT + fpad<MMA>(), ldp = KT + tpad<T, MMA>();
  Carve cv{smem, 0};
  T* qs = cv.take<T>(R * ldt);
  T* gs = cv.take<T>(R * ldt);
  T* ks = cv.take<T>(KT * ldt);
  T* vs = cv.take<T>(KT * ldt);
  float* acc = cv.take<float>(R * lda);
  float* sc = cv.take<float>(R * lds);
  float* dp = cv.take<float>(R * lds);
  T* dsb = cv.take<T>(R * ldp);
  float* ls = cv.take<float>(R);
  float* dl = cv.take<float>(R);

  const int bh = blockIdx.y, row0 = blockIdx.x * R;
  const int bg = (bh / g.H) * g.G + (bh % g.H) / (g.H / g.G);
  const int64_t qoff = (static_cast<int64_t>(bh) * g.Tq + row0) * hs;
  const T* kg = k + static_cast<int64_t>(bg) * g.Tk * hs;
  const T* vg = v + static_cast<int64_t>(bg) * g.Tk * hs;
  const float* mb = mask_base(mask, g, bh);

  load_rows<T, MMA>(qs, ldt, q + qoff, R, hs);
  load_rows<T, MMA>(gs, ldt, go + qoff, R, hs);
  for (int i = threadIdx.x; i < R * lda; i += kThreads) acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    ls[r] = lse[static_cast<int64_t>(bh) * g.Tq + row0 + r];
    dl[r] = delta[static_cast<int64_t>(bh) * g.Tq + row0 + r];
  }
  int j0, j1;
  key_tiles(g, row0, j0, j1);
  for (int j = j0; j < j1; ++j) {
    const int c0 = j * KT;
    __syncthreads();
    load_rows<T, MMA>(ks, ldt, kg + static_cast<int64_t>(c0) * hs, KT, hs);
    load_rows<T, MMA>(vs, ldt, vg + static_cast<int64_t>(c0) * hs, KT, hs);
    __syncthreads();
    block_gemm<T, MMA, true, false>(sc, lds, qs, ldt, ks, ldt, R, KT, hs);  // S = Q K^T
    block_gemm<T, MMA, true, false>(dp, lds, gs, ldt, vs, ldt, R, KT, hs);  // dP = G V^T
    __syncthreads();
    for (int i = threadIdx.x; i < R * KT; i += kThreads) {
      const int r = i / KT, c = i - r * KT;
      const int row = row0 + r, col = c0 + c;
      float p = 0.f;
      if (keep(g, row, col)) {
        float x = sc[r * lds + c] * g.scale;
        if (mb != nullptr) x += mask_at(mb, g, row, col);
        p = expf(x - ls[r]);
      }
      dsb[r * ldp + c] = from_f<T>(p * (dp[r * lds + c] - dl[r]));
    }
    __syncthreads();
    block_gemm<T, MMA, false, true>(acc, lda, dsb, ldp, ks, ldt, R, hs, KT);  // acc += dS K
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * hs; i += kThreads) {
    const int r = i / hs;
    dq[qoff + i] = from_f<T>(g.scale * acc[r * lda + i - r * hs]);
  }
}

// grid (Tk / KT, BG), block kThreads.  The block's keys see the query tiles
// of every q head of its group, heads in order, tiles in order.
template <typename T, bool MMA>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ go, const T* __restrict__ q,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ mask, T* __restrict__ dk,
                         T* __restrict__ dv, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = g.R, KT = g.KT, hs = g.hs;
  const int ldt = hs + tpad<T, MMA>(), lda = hs + fpad<MMA>();
  const int lds = R + fpad<MMA>(), ldp = R + tpad<T, MMA>();
  Carve cv{smem, 0};
  T* ks = cv.take<T>(KT * ldt);
  T* vs = cv.take<T>(KT * ldt);
  T* qs = cv.take<T>(R * ldt);
  T* gs = cv.take<T>(R * ldt);
  float* dka = cv.take<float>(KT * lda);
  float* dva = cv.take<float>(KT * lda);
  float* st = cv.take<float>(KT * lds);   // S^T
  float* dpt = cv.take<float>(KT * lds);  // dP^T
  T* pb = cv.take<T>(KT * ldp);           // P^T in the gradient type
  T* dsb = cv.take<T>(KT * ldp);          // dS^T in the query type
  float* ls = cv.take<float>(R);
  float* dl = cv.take<float>(R);

  const int bg = blockIdx.y, kt0 = blockIdx.x * KT;
  const int rep = g.H / g.G;
  const int b = bg / g.G, grp = bg % g.G;
  const int64_t koff = (static_cast<int64_t>(bg) * g.Tk + kt0) * hs;

  load_rows<T, MMA>(ks, ldt, k + koff, KT, hs);
  load_rows<T, MMA>(vs, ldt, v + koff, KT, hs);
  for (int i = threadIdx.x; i < KT * lda; i += kThreads) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  int i0, i1;
  query_tiles(g, kt0, i0, i1);
  for (int hr = 0; hr < rep; ++hr) {
    const int bh = b * g.H + grp * rep + hr;
    const float* mb = mask_base(mask, g, bh);
    for (int it = i0; it < i1; ++it) {
      const int q0 = it * R;
      const int64_t qoff = (static_cast<int64_t>(bh) * g.Tq + q0) * hs;
      __syncthreads();  // the last tile's readers are done
      load_rows<T, MMA>(qs, ldt, q + qoff, R, hs);
      load_rows<T, MMA>(gs, ldt, go + qoff, R, hs);
      for (int r = threadIdx.x; r < R; r += kThreads) {
        ls[r] = lse[static_cast<int64_t>(bh) * g.Tq + q0 + r];
        dl[r] = delta[static_cast<int64_t>(bh) * g.Tq + q0 + r];
      }
      __syncthreads();
      block_gemm<T, MMA, true, false>(st, lds, ks, ldt, qs, ldt, KT, R, hs);   // S^T = K Q^T
      block_gemm<T, MMA, true, false>(dpt, lds, vs, ldt, gs, ldt, KT, R, hs);  // dP^T = V G^T
      __syncthreads();
      for (int i = threadIdx.x; i < KT * R; i += kThreads) {
        const int c = i / R, r = i - c * R;
        const int row = q0 + r, col = kt0 + c;
        float p = 0.f;
        if (keep(g, row, col)) {
          float x = st[c * lds + r] * g.scale;
          if (mb != nullptr) x += mask_at(mb, g, row, col);
          p = expf(x - ls[r]);
        }
        pb[c * ldp + r] = from_f<T>(p);
        dsb[c * ldp + r] = from_f<T>(p * (dpt[c * lds + r] - dl[r]));
      }
      __syncthreads();
      block_gemm<T, MMA, false, true>(dva, lda, pb, ldp, gs, ldt, KT, hs, R);   // dV += P^T G
      block_gemm<T, MMA, false, true>(dka, lda, dsb, ldp, qs, ldt, KT, hs, R);  // dK += dS^T Q
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < KT * hs; i += kThreads) {
    const int c = i / hs, at = c * lda + i - c * hs;
    dk[koff + i] = from_f<T>(g.scale * dka[at]);
    dv[koff + i] = from_f<T>(dva[at]);
  }
}

//
// The warpgroup body (bf16, hs 64 or 128): wgmma products with register
// accumulators; each warpgroup streams K/V (dk/dv: Q/dO) tiles through its
// own two-stage cp.async ring.
//

namespace wgb {

using bf16 = __nv_bfloat16;
namespace wg = tt::wg;
using wg::mma_rs;
using wg::mma_ss;
using wg::quad_max;
using wg::quad_sum;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kRows = 64;      // query rows (dk/dv: keys) per warpgroup
constexpr int kTile = 64;      // keys per K/V tile (dk/dv: query rows per Q/dO tile)
constexpr float kLog2e = 1.4426950408889634f;

template <int HS> __host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return rows * HS * 2;
}

// Shared memory of each kernel, 1024 bytes of alignment slack included
// (cudaex._flash_smem mirrors these).  Forward: each warpgroup its own Q
// rows and its own two-stage K/V ring.
template <int HS> __host__ __device__ constexpr size_t fwd_smem() {
  return 1024 + 2 * (tile_bytes<HS>(kRows) + 2 * 2 * tile_bytes<HS>(kTile));
}
// dq: each warpgroup its own Q and dO rows and its own K/V ring.
template <int HS> __host__ __device__ constexpr size_t dq_smem() {
  return 1024 + 2 * (2 * tile_bytes<HS>(kRows) + 2 * 2 * tile_bytes<HS>(kTile));
}
// A Q/dO stage: the two tiles, then lse and delta of its rows (1024 bytes).
template <int HS> __host__ __device__ constexpr uint32_t dkv_stage() {
  return 2 * tile_bytes<HS>(kTile) + 1024;
}
// dk/dv: each warpgroup its own K and V rows and its own Q/dO ring.
template <int HS> __host__ __device__ constexpr size_t dkv_smem() {
  return 1024 + 2 * (2 * tile_bytes<HS>(kRows) + 2 * dkv_stage<HS>());
}

// Barrier of the 128 threads of warpgroup w alone (ids 1 and 2; 0 is
// __syncthreads').  (Immediate ids behind a branch per warpgroup measured
// 5% slower in the forward on an H100.)
__device__ __forceinline__ void wg_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(w + 1) : "memory");
}

// Column of accumulator element i of lane l in a tile starting at column c0;
// its row is the lane's row, plus 8 for (i & 2).
__device__ __forceinline__ int acc_col(int c0, int i, int l) {
  return c0 + 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
}

// A 64 x 64 tile of the score plane at rows [r0, r0 + 64), columns
// [c0, c0 + 64) needs per-element mask work: an additive mask, or a causal
// or window edge crossing it.
__device__ __forceinline__ bool edge_tile(const Geometry& g, bool has_mask, int r0, int c0) {
  return has_mask || (g.causal && (c0 + kTile - 1 > r0 ||
                                   (g.window > 0 && c0 <= r0 + kRows - 1 - g.window)));
}

// The rows of one warpgroup as a Geometry with R = KT = 64, for key_tiles and
// query_tiles (the skips of the plain version's 64 x 64 tiles).
__device__ __forceinline__ Geometry tiles64(const Geometry& g) {
  Geometry t = g;
  t.R = kRows;
  t.KT = kTile;
  return t;
}

// grid (BH, Tq / 128), block 256: warpgroup w owns query rows
// row0 + 64 w .. + 63 of q head blockIdx.x and walks its key tiles through
// its own K/V ring, synchronising with nothing but itself, so one
// warpgroup's softmax overlaps the other's products; causal grids walk the
// longest query tiles first.
template <int HS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ mask,
                        bf16* __restrict__ out, float* __restrict__ lse, Geometry g) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr uint32_t kQ = tile_bytes<HS>(kRows), kKV = tile_bytes<HS>(kTile);
  const int tid = threadIdx.x, wgi = tid >> 7, t = tid & 127, w = (tid >> 5) & 3, l = tid & 31;
  const uint32_t sq = ((wg::smem_u32(smem) + 1023) & ~1023u) + wgi * (kQ + 4 * kKV);
  const uint32_t skv = sq + kQ;  // stage s: K, then V
  const int bh = blockIdx.x;
  const int qt = g.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int wrow0 = qt * 2 * kRows + wgi * kRows;
  const int r_lo = wrow0 + 16 * w + (l >> 2);  // rows r_lo and r_lo + 8
  const int bg = (bh / g.H) * g.G + (bh % g.H) / (g.H / g.G);
  const bf16* kg = k + static_cast<int64_t>(bg) * g.Tk * HS;
  const bf16* vg = v + static_cast<int64_t>(bg) * g.Tk * HS;
  const float* mb = mask_base(mask, g, bh);
  int j0, j1;
  key_tiles(tiles64(g), wrow0, j0, j1);

  wg::load_tile<HS, 128>(sq, q + (static_cast<int64_t>(bh) * g.Tq + wrow0) * HS, kRows, HS, t);
  if (j0 < j1) {
    wg::load_tile<HS, 128>(skv, kg + static_cast<int64_t>(j0) * kTile * HS, kTile, HS, t);
    wg::load_tile<HS, 128>(skv + kKV, vg + static_cast<int64_t>(j0) * kTile * HS, kTile, HS, t);
  }
  wg::cp_async_commit();

  float o[HS / 2], s[32];
#pragma unroll
  for (int i = 0; i < HS / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m0 = kMaskValue, m1 = kMaskValue, l0 = 0.f, l1 = 0.f;  // rows r_lo, r_lo + 8
  for (int j = j0; j < j1; ++j) {
    const uint32_t sk = skv + ((j - j0) & 1) * 2 * kKV, sv = sk + kKV;
    if (j + 1 < j1) {  // the next tile loads while this one computes
      const uint32_t nk = skv + ((j + 1 - j0) & 1) * 2 * kKV;
      const int64_t at = static_cast<int64_t>(j + 1) * kTile * HS;
      wg::load_tile<HS, 128>(nk, kg + at, kTile, HS, t);
      wg::load_tile<HS, 128>(nk + kKV, vg + at, kTile, HS, t);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<1>();
    wg::fence_async_smem();
    wg_sync(wgi);
    wg::fence();
    mma_ss<HS>(s, sq, kRows, 0, sk);
    wg::commit();
    wg::wait<0>();
    wg::pin(s);
    const int c0 = j * kTile;
    const bool edge = edge_tile(g, mb != nullptr, wrow0, c0);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * g.scale;
      if (edge) {
        const int row = r_lo + ((i & 2) << 2), col = acc_col(c0, i, l);
        if (mb != nullptr) x += mask_at(mb, g, row, col);
        if (!keep(g, row, col)) x = kMaskValue;
      }
      s[i] = x;
      if (i & 2) {
        mx1 = fmaxf(mx1, x);
      } else {
        mx0 = fmaxf(mx0, x);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c_0 = exp2f((m0 - mx0) * kLog2e), c_1 = exp2f((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f((s[i] - ((i & 2) ? mx1 : mx0)) * kLog2e);
      s[i] = p;
      if (i & 2) {
        sum1 += p;
      } else {
        sum0 += p;
      }
    }
    l0 = l0 * c_0 + sum0;  // this lane's share of the row sum
    l1 = l1 * c_1 + sum1;
#pragma unroll
    for (int i = 0; i < HS / 2; ++i) o[i] *= (i & 2) ? c_1 : c_0;
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pack_a(s, kk, a[kk]);  // P in bf16 (:257)
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<HS>(o, a[kk], wg::desc_mn(sv, kTile, kk));
    wg::commit();
    wg::wait<0>();
    wg::pin(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pin(a[kk]);
    wg_sync(wgi);  // this stage is free for the load two tiles on
  }
  wg::cp_async_wait<0>();
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  bf16* o0 = out + (static_cast<int64_t>(bh) * g.Tq + r_lo) * HS;
  bf16* o1 = o0 + 8 * HS;
#pragma unroll
  for (int jj = 0; jj < HS / 8; ++jj) {
    const int c = 8 * jj + 2 * (l & 3);
    *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
        __floats2bfloat162_rn(o[4 * jj] / l0, o[4 * jj + 1] / l0);
    *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
        __floats2bfloat162_rn(o[4 * jj + 2] / l1, o[4 * jj + 3] / l1);
  }
  if ((l & 3) == 0) {
    lse[static_cast<int64_t>(bh) * g.Tq + r_lo] = m0 + logf(l0);
    lse[static_cast<int64_t>(bh) * g.Tq + r_lo + 8] = m1 + logf(l1);
  }
}

// grid (BH, Tq / 128), block 256, as the forward, each warpgroup on its
// own K/V ring.
template <int HS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wg_kernel(const bf16* __restrict__ go, const bf16* __restrict__ q,
                           const bf16* __restrict__ k, const bf16* __restrict__ v,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const float* __restrict__ mask, bf16* __restrict__ dq, Geometry g) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr uint32_t kQ = tile_bytes<HS>(kRows), kKV = tile_bytes<HS>(kTile);
  const int tid = threadIdx.x, wgi = tid >> 7, t = tid & 127, w = (tid >> 5) & 3, l = tid & 31;
  const uint32_t sq = ((wg::smem_u32(smem) + 1023) & ~1023u) + wgi * (2 * kQ + 4 * kKV);
  const uint32_t sg = sq + kQ, skv = sg + kQ;
  const int bh = blockIdx.x;
  const int qt = g.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int wrow0 = qt * 2 * kRows + wgi * kRows;
  const int r_lo = wrow0 + 16 * w + (l >> 2);
  const int bg = (bh / g.H) * g.G + (bh % g.H) / (g.H / g.G);
  const bf16* kg = k + static_cast<int64_t>(bg) * g.Tk * HS;
  const bf16* vg = v + static_cast<int64_t>(bg) * g.Tk * HS;
  const float* mb = mask_base(mask, g, bh);
  int j0, j1;
  key_tiles(tiles64(g), wrow0, j0, j1);
  const int64_t qoff = (static_cast<int64_t>(bh) * g.Tq + wrow0) * HS;
  const int64_t at0 = static_cast<int64_t>(bh) * g.Tq + r_lo;
  const float ls0 = lse[at0], ls1 = lse[at0 + 8], dl0 = delta[at0], dl1 = delta[at0 + 8];

  wg::load_tile<HS, 128>(sq, q + qoff, kRows, HS, t);
  wg::load_tile<HS, 128>(sg, go + qoff, kRows, HS, t);
  if (j0 < j1) {
    wg::load_tile<HS, 128>(skv, kg + static_cast<int64_t>(j0) * kTile * HS, kTile, HS, t);
    wg::load_tile<HS, 128>(skv + kKV, vg + static_cast<int64_t>(j0) * kTile * HS, kTile, HS, t);
  }
  wg::cp_async_commit();

  float acc[HS / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < HS / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  for (int j = j0; j < j1; ++j) {
    const uint32_t sk = skv + ((j - j0) & 1) * 2 * kKV, sv = sk + kKV;
    if (j + 1 < j1) {
      const uint32_t nk = skv + ((j + 1 - j0) & 1) * 2 * kKV;
      const int64_t at = static_cast<int64_t>(j + 1) * kTile * HS;
      wg::load_tile<HS, 128>(nk, kg + at, kTile, HS, t);
      wg::load_tile<HS, 128>(nk + kKV, vg + at, kTile, HS, t);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<1>();
    wg::fence_async_smem();
    wg_sync(wgi);
    wg::fence();
    mma_ss<HS>(s, sq, kRows, 0, sk);   // S = Q K^T
    mma_ss<HS>(dp, sg, kRows, 0, sv);  // dP = dO V^T
    wg::commit();
    wg::wait<0>();
    wg::pin(s);
    wg::pin(dp);
    const int c0 = j * kTile;
    const bool edge = edge_tile(g, mb != nullptr, wrow0, c0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = i & 2;
      float x = s[i] * g.scale, p = 0.f;
      bool kept = true;
      if (edge) {
        const int row = r_lo + (hi ? 8 : 0), col = acc_col(c0, i, l);
        if (mb != nullptr) x += mask_at(mb, g, row, col);
        kept = keep(g, row, col);
      }
      if (kept) p = exp2f((x - (hi ? ls1 : ls0)) * kLog2e);
      s[i] = p * (dp[i] - (hi ? dl1 : dl0));  // dS
    }
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pack_a(s, kk, a[kk]);  // dS in the key type (:393)
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<HS>(acc, a[kk], wg::desc_mn(sk, kTile, kk));
    wg::commit();
    wg::wait<0>();
    wg::pin(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pin(a[kk]);
    wg_sync(wgi);
  }
  wg::cp_async_wait<0>();
  bf16* d0 = dq + (static_cast<int64_t>(bh) * g.Tq + r_lo) * HS;
  bf16* d1 = d0 + 8 * HS;
#pragma unroll
  for (int jj = 0; jj < HS / 8; ++jj) {
    const int c = 8 * jj + 2 * (l & 3);
    *reinterpret_cast<__nv_bfloat162*>(d0 + c) =
        __floats2bfloat162_rn(g.scale * acc[4 * jj], g.scale * acc[4 * jj + 1]);
    *reinterpret_cast<__nv_bfloat162*>(d1 + c) =
        __floats2bfloat162_rn(g.scale * acc[4 * jj + 2], g.scale * acc[4 * jj + 3]);
  }
}

// Loads Q/dO stage item n of a dk/dv warpgroup's walk: query tile it of q
// head bh, lse and delta of its rows; thread t of 128.
template <int HS>
__device__ __forceinline__ void dkv_load(uint32_t st, const bf16* q, const bf16* go,
                                         const float* lse, const float* delta, const Geometry& g,
                                         int bh, int it, int t) {
  const int64_t r0 = static_cast<int64_t>(bh) * g.Tq + it * kTile;
  wg::load_tile<HS, 128>(st, q + r0 * HS, kTile, HS, t);
  wg::load_tile<HS, 128>(st + tile_bytes<HS>(kTile), go + r0 * HS, kTile, HS, t);
  if (t < 32) {  // 64 lse then 64 delta floats, 16 bytes per thread
    const float* src = (t < 16 ? lse + r0 : delta + r0) + 4 * (t & 15);
    const uint32_t dst = st + 2 * tile_bytes<HS>(kTile) + 16 * t;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  }
}

// grid (BG * nsplit, Tk / 128), block 256: warpgroup w owns keys
// kt0 + 64 w .. + 63 of KV group blockIdx.x / nsplit and walks, through its
// own Q/dO ring, the query tiles of its share of the group's rep q heads
// (split blockIdx.x % nsplit of nsplit), heads in order, tiles in order.
// Causal grids put the key tiles with the longest walks first
// (blockIdx.y = 0).  nsplit == 1 writes dk and dv; otherwise each split
// writes f32 partials pk/pv (nsplit, BG, Tk, HS) that flash_dkv_sum_kernel
// adds in split order.
template <int HS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wg_kernel(const bf16* __restrict__ go, const bf16* __restrict__ q,
                            const bf16* __restrict__ k, const bf16* __restrict__ v,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const float* __restrict__ mask, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, float* __restrict__ pk,
                            float* __restrict__ pv, int nsplit, Geometry g) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr uint32_t kK = tile_bytes<HS>(kRows), kT = tile_bytes<HS>(kTile);
  constexpr uint32_t kStage = dkv_stage<HS>();
  const int tid = threadIdx.x, wgi = tid >> 7, t = tid & 127, w = (tid >> 5) & 3, l = tid & 31;
  const uint32_t s_k = ((wg::smem_u32(smem) + 1023) & ~1023u) + wgi * (2 * kK + 2 * kStage);
  const uint32_t s_v = s_k + kK, sst = s_v + kK;  // then the two Q/dO stages
  const unsigned char* gbase = smem + (sst - wg::smem_u32(smem));  // generic address of sst
  const int bg = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int rep = g.H / g.G, b = bg / g.G, grp = bg % g.G;
  const int h0 = split * rep / nsplit, h1 = (split + 1) * rep / nsplit;
  const int kw0 = blockIdx.y * 2 * kRows + wgi * kRows;
  const int k_lo = kw0 + 16 * w + (l >> 2);  // keys k_lo and k_lo + 8
  int i0, i1;
  query_tiles(tiles64(g), kw0, i0, i1);
  const int nit = max(0, i1 - i0), n_items = (h1 - h0) * nit;
  const int bh0 = b * g.H + grp * rep + h0;
  const int64_t koff = (static_cast<int64_t>(bg) * g.Tk + kw0) * HS;

  wg::load_tile<HS, 128>(s_k, k + koff, kRows, HS, t);
  wg::load_tile<HS, 128>(s_v, v + koff, kRows, HS, t);
  if (n_items > 0) dkv_load<HS>(sst, q, go, lse, delta, g, bh0, i0, t);
  wg::cp_async_commit();

  float dka[HS / 2], dva[HS / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < HS / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  for (int n = 0; n < n_items; ++n) {
    const uint32_t st = sst + (n & 1) * kStage;
    if (n + 1 < n_items) {
      dkv_load<HS>(sst + ((n + 1) & 1) * kStage, q, go, lse, delta, g, bh0 + (n + 1) / nit,
                   i0 + (n + 1) % nit, t);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<1>();
    wg::fence_async_smem();
    wg_sync(wgi);
    const int bh = bh0 + n / nit, q0 = (i0 + n % nit) * kTile;
    const float* mb = mask_base(mask, g, bh);
    const float* ls = reinterpret_cast<const float*>(gbase + (n & 1) * kStage + 2 * kT);
    const float* dl = ls + kTile;
    wg::fence();
    mma_ss<HS>(s, s_k, kRows, 0, st);        // S^T = K Q^T
    mma_ss<HS>(dp, s_v, kRows, 0, st + kT);  // dP^T = V dO^T
    wg::commit();
    wg::wait<0>();
    wg::pin(s);
    wg::pin(dp);
    // the tile's keys are its rows and its queries its columns here
    const bool edge = mb != nullptr ||
                      (g.causal && (q0 < kw0 + kRows - 1 ||
                                    (g.window > 0 && q0 + kTile - 1 >= kw0 + g.window)));
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
      float x = s[i] * g.scale, p = 0.f;
      bool kept = true;
      if (edge) {
        const int key = k_lo + ((i & 2) << 2), row = q0 + qc;
        if (mb != nullptr) x += mask_at(mb, g, row, key);
        kept = keep(g, row, key);
      }
      if (kept) p = exp2f((x - ls[qc]) * kLog2e);
      s[i] = p;
      dp[i] = p * (dp[i] - dl[qc]);
    }
    // dV's products run while dS^T packs: S^T's registers are free by then
    uint32_t ap[4][4], ad[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pack_a(s, kk, ap[kk]);  // P^T in the gradient type (:443)
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<HS>(dva, ap[kk], wg::desc_mn(st + kT, kTile, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pack_a(dp, kk, ad[kk]);  // dS^T in the query type (:450)
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<HS>(dka, ad[kk], wg::desc_mn(st, kTile, kk));
    wg::commit();
    wg::wait<0>();
    wg::pin(dva);
    wg::pin(dka);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg::pin(ap[kk]);
      wg::pin(ad[kk]);
    }
    wg_sync(wgi);
  }
  wg::cp_async_wait<0>();
  const int64_t e0 = (static_cast<int64_t>(bg) * g.Tk + k_lo) * HS;
  if (nsplit == 1) {
#pragma unroll
    for (int jj = 0; jj < HS / 8; ++jj) {
      const int64_t c = e0 + 8 * jj + 2 * (l & 3);
      *reinterpret_cast<__nv_bfloat162*>(dk + c) =
          __floats2bfloat162_rn(g.scale * dka[4 * jj], g.scale * dka[4 * jj + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dk + c + 8 * HS) =
          __floats2bfloat162_rn(g.scale * dka[4 * jj + 2], g.scale * dka[4 * jj + 3]);
      *reinterpret_cast<__nv_bfloat162*>(dv + c) =
          __floats2bfloat162_rn(dva[4 * jj], dva[4 * jj + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + c + 8 * HS) =
          __floats2bfloat162_rn(dva[4 * jj + 2], dva[4 * jj + 3]);
    }
  } else {
    const int64_t part = static_cast<int64_t>(split) * (g.Tk * static_cast<int64_t>(HS)) *
                         (gridDim.x / nsplit);
#pragma unroll
    for (int jj = 0; jj < HS / 8; ++jj) {
      const int64_t c = part + e0 + 8 * jj + 2 * (l & 3);
      *reinterpret_cast<float2*>(pk + c) = make_float2(dka[4 * jj], dka[4 * jj + 1]);
      *reinterpret_cast<float2*>(pk + c + 8 * HS) = make_float2(dka[4 * jj + 2], dka[4 * jj + 3]);
      *reinterpret_cast<float2*>(pv + c) = make_float2(dva[4 * jj], dva[4 * jj + 1]);
      *reinterpret_cast<float2*>(pv + c + 8 * HS) = make_float2(dva[4 * jj + 2], dva[4 * jj + 3]);
    }
  }
}

// dk = scale * sum_s pk[s], dv = sum_s pv[s], the splits added in order.
__global__ void flash_dkv_sum_kernel(const float* __restrict__ pk, const float* __restrict__ pv,
                                     bf16* __restrict__ dk, bf16* __restrict__ dv, int64_t n,
                                     int nsplit, float scale) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      a += pk[sp * n + e];
      c += pv[sp * n + e];
    }
    dk[e] = __float2bfloat16_rn(scale * a);
    dv[e] = __float2bfloat16_rn(c);
  }
}

}  // namespace wgb

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, bool MMA>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* mask, void* out,
                       float* lse, int BH, const Geometry& g, cudaStream_t s) {
  const size_t smem = fwd_smem<T, MMA>(g.R, g.KT, g.hs);
  auto kern = flash_fwd_kernel<T, MMA>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(g.Tq / g.R, BH), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), lse, g);
  return cudaGetLastError();
}

template <typename T, bool MMA>
cudaError_t launch_dq(const void* go, const void* q, const void* k, const void* v,
                      const float* lse, const float* delta, const float* mask, void* dq, int BH,
                      const Geometry& g, cudaStream_t s) {
  const size_t smem = dq_smem<T, MMA>(g.R, g.KT, g.hs);
  auto kern = flash_bwd_dq_kernel<T, MMA>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(g.Tq / g.R, BH), kThreads, smem, s>>>(
      static_cast<const T*>(go), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lse, delta, mask, static_cast<T*>(dq), g);
  return cudaGetLastError();
}

template <typename T, bool MMA>
cudaError_t launch_dkv(const void* go, const void* q, const void* k, const void* v,
                       const float* lse, const float* delta, const float* mask, void* dk,
                       void* dv, int BG, const Geometry& g, cudaStream_t s) {
  const size_t smem = dkv_smem<T, MMA>(g.R, g.KT, g.hs);
  auto kern = flash_bwd_dkv_kernel<T, MMA>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(g.Tk / g.KT, BG), kThreads, smem, s>>>(
      static_cast<const T*>(go), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lse, delta, mask, static_cast<T*>(dk), static_cast<T*>(dv), g);
  return cudaGetLastError();
}

template <int HS>
cudaError_t launch_fwd_wg(const void* q, const void* k, const void* v, const float* mask,
                          void* out, float* lse, int BH, const Geometry& g, cudaStream_t s) {
  constexpr size_t smem = wgb::fwd_smem<HS>();
  auto kern = wgb::flash_fwd_wg_kernel<HS>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(BH, g.Tq / (2 * wgb::kRows)), wgb::kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out), lse, g);
  return cudaGetLastError();
}

template <int HS>
cudaError_t launch_dq_wg(const void* go, const void* q, const void* k, const void* v,
                         const float* lse, const float* delta, const float* mask, void* dq,
                         int BH, const Geometry& g, cudaStream_t s) {
  constexpr size_t smem = wgb::dq_smem<HS>();
  auto kern = wgb::flash_bwd_dq_wg_kernel<HS>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(BH, g.Tq / (2 * wgb::kRows)), wgb::kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(go), static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), lse, delta,
      mask, static_cast<__nv_bfloat16*>(dq), g);
  return cudaGetLastError();
}

// partial: (2, nsplit, BG, Tk, HS) f32 scratch when nsplit > 1.
template <int HS>
cudaError_t launch_dkv_wg(const void* go, const void* q, const void* k, const void* v,
                          const float* lse, const float* delta, const float* mask, void* dk,
                          void* dv, float* partial, int nsplit, int BG, const Geometry& g,
                          cudaStream_t s) {
  constexpr size_t smem = wgb::dkv_smem<HS>();
  auto kern = wgb::flash_bwd_dkv_wg_kernel<HS>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  const int64_t n = static_cast<int64_t>(BG) * g.Tk * HS;
  float* pk = nsplit > 1 ? partial : nullptr;
  float* pv = nsplit > 1 ? partial + nsplit * n : nullptr;
  kern<<<dim3(BG * nsplit, g.Tk / (2 * wgb::kRows)), wgb::kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(go), static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), lse, delta,
      mask, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), pk, pv, nsplit,
      g);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  const int64_t blocks = (n + 255) / 256;
  wgb::flash_dkv_sum_kernel<<<static_cast<int>(blocks < 2048 ? blocks : 2048), 256, 0, s>>>(
      pk, pv, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n, nsplit,
      g.scale);
  return cudaGetLastError();
}

bool tile_ok(int n) { return n == 16 || n == 32 || n == 64; }

// Kernel bodies, the wrappers' codes: the scalar body (float32), the WMMA
// body (bf16, hs % 16 == 0) and the warpgroup body (bf16, hs 64 or 128,
// Tq and Tk multiples of 128, every tensor 16-byte aligned).
enum Body { kScalar = 0, kWmma = 1, kWarpgroup = 2 };

// Validates the arguments every entry point shares; fills g.
bool make_geometry(Geometry& g, int BH, int H, int G, int Tq, int Tk, int hs, int mask_mode,
                   int mq, int causal, int window, int R, int KT, int body, float scale,
                   int dtype) {
  g = Geometry{H, G, Tq, Tk, hs, mask_mode, mq, causal, window, R, KT, scale};
  if (BH <= 0 || H <= 0 || G <= 0 || H % G != 0 || BH % H != 0 || hs <= 0) return false;
  if (!tile_ok(R) || !tile_ok(KT) || Tq <= 0 || Tk <= 0 || Tq % R != 0 || Tk % KT != 0)
    return false;
  if (BH > 65535 || (BH / H) * G > 65535) return false;  // grid y
  if (mask_mode < -1 || mask_mode > 3 || (mask_mode >= 0 && mq != 1 && mq != Tq)) return false;
  if (window < 0 || (window > 0 && !causal)) return false;
  if (dtype != 0 && dtype != 2) return false;                        // float32, bfloat16
  if (body == kWmma) return dtype == 2 && hs % 16 == 0;
  if (body == kWarpgroup)
    return dtype == 2 && (hs == 64 || hs == 128) && Tq % 128 == 0 && Tk % 128 == 0 &&
           R == wgb::kRows && KT == wgb::kTile;
  return body == kScalar;
}

}  // namespace

// dtype codes: 0 = float32, 2 = bfloat16 (the Pallas kernels take these
// two).  body: the kernel body (Body above; the wrapper decides).  R, KT:
// query rows and keys per tile, 16, 32 or 64, picked by the wrapper so
// shared memory fits (the warpgroup body takes 64 and 64: rows per
// warpgroup, keys per tile).  mask may be null (mask_mode -1).  Each
// returns the cudaError_t of its launch.
extern "C" int tt_flash_fwd(const void* q, const void* k, const void* v, const float* mask,
                            void* out, float* lse, int BH, int H, int G, int Tq, int Tk, int hs,
                            int mask_mode, int mq, int causal, int window, int R, int KT, int body,
                            float scale, int dtype, void* stream) {
  Geometry g;
  if (!make_geometry(g, BH, H, G, Tq, Tk, hs, mask_mode, mq, causal, window, R, KT, body, scale,
                     dtype))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == kWarpgroup)
    return hs == 128 ? launch_fwd_wg<128>(q, k, v, mask, out, lse, BH, g, s)
                     : launch_fwd_wg<64>(q, k, v, mask, out, lse, BH, g, s);
  if (dtype == 0) return launch_fwd<float, false>(q, k, v, mask, out, lse, BH, g, s);
  if (body == kWmma) return launch_fwd<__nv_bfloat16, true>(q, k, v, mask, out, lse, BH, g, s);
  return launch_fwd<__nv_bfloat16, false>(q, k, v, mask, out, lse, BH, g, s);
}

extern "C" int tt_flash_bwd_dq(const void* go, const void* q, const void* k, const void* v,
                               const float* lse, const float* delta, const float* mask, void* dq,
                               int BH, int H, int G, int Tq, int Tk, int hs, int mask_mode, int mq,
                               int causal, int window, int R, int KT, int body, float scale,
                               int dtype, void* stream) {
  Geometry g;
  if (!make_geometry(g, BH, H, G, Tq, Tk, hs, mask_mode, mq, causal, window, R, KT, body, scale,
                     dtype))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == kWarpgroup)
    return hs == 128 ? launch_dq_wg<128>(go, q, k, v, lse, delta, mask, dq, BH, g, s)
                     : launch_dq_wg<64>(go, q, k, v, lse, delta, mask, dq, BH, g, s);
  if (dtype == 0) return launch_dq<float, false>(go, q, k, v, lse, delta, mask, dq, BH, g, s);
  if (body == kWmma)
    return launch_dq<__nv_bfloat16, true>(go, q, k, v, lse, delta, mask, dq, BH, g, s);
  return launch_dq<__nv_bfloat16, false>(go, q, k, v, lse, delta, mask, dq, BH, g, s);
}

// R, KT: query rows per query tile and keys per block.  nsplit (warpgroup
// body): the blocks each KV group's rep q heads are shared among, 1 or a
// divisor of rep; above 1, partial holds (2, nsplit, BG, Tk, hs) floats of
// scratch and a second launch adds the splits in order.
extern "C" int tt_flash_bwd_dkv(const void* go, const void* q, const void* k, const void* v,
                                const float* lse, const float* delta, const float* mask, void* dk,
                                void* dv, float* partial, int BH, int H, int G, int Tq, int Tk,
                                int hs, int mask_mode, int mq, int causal, int window, int R,
                                int KT, int body, int nsplit, float scale, int dtype,
                                void* stream) {
  Geometry g;
  if (!make_geometry(g, BH, H, G, Tq, Tk, hs, mask_mode, mq, causal, window, R, KT, body, scale,
                     dtype))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BG = (BH / H) * G;
  if (body == kWarpgroup) {
    if (nsplit < 1 || (H / G) % nsplit != 0 || (nsplit > 1 && partial == nullptr))
      return cudaErrorInvalidValue;
    return hs == 128 ? launch_dkv_wg<128>(go, q, k, v, lse, delta, mask, dk, dv, partial, nsplit,
                                          BG, g, s)
                     : launch_dkv_wg<64>(go, q, k, v, lse, delta, mask, dk, dv, partial, nsplit,
                                         BG, g, s);
  }
  if (dtype == 0)
    return launch_dkv<float, false>(go, q, k, v, lse, delta, mask, dk, dv, BG, g, s);
  if (body == kWmma)
    return launch_dkv<__nv_bfloat16, true>(go, q, k, v, lse, delta, mask, dk, dv, BG, g, s);
  return launch_dkv<__nv_bfloat16, false>(go, q, k, v, lse, delta, mask, dk, dv, BG, g, s);
}
