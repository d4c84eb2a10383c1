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
// Design (simple and right first):
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
//     Pallas dot_general with preferred_element_type=f32) when the inputs are
//     bf16 and hs is a multiple of 16 (rows padded by 16 bytes against bank
//     conflicts), on scalar FMAs otherwise (float32).  wgmma with
//     register-resident accumulators is the next step.
//   * Rounding points copied from the Pallas kernels: p cast to the value
//     type before P.V (:257), ds to the key type before dS.K (:393), p to
//     the gradient type for dv (:443), ds to the query type for dk (:450).
//     lse and delta (= sum g*out, computed by the wrapper) are f32.
//   * Causal tiles above the diagonal, and with a window the tiles wholly
//     below the band, are skipped (:229-231).
//   * dk/dv: the Pallas kernel writes per-q-head dk/dv and lets XLA sum the
//     rep heads (:547-550).  Here one block sums them in a fixed order in its
//     f32 accumulators: no (BH, Tk, hs) buffer, no atomics, and the result is
//     bitwise the same from run to run.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

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

bool tile_ok(int n) { return n == 16 || n == 32 || n == 64; }

// Validates the arguments every entry point shares; fills g.
bool make_geometry(Geometry& g, int BH, int H, int G, int Tq, int Tk, int hs, int mask_mode,
                   int mq, int causal, int window, int R, int KT, int mma, float scale,
                   int dtype) {
  g = Geometry{H, G, Tq, Tk, hs, mask_mode, mq, causal, window, R, KT, scale};
  if (BH <= 0 || H <= 0 || G <= 0 || H % G != 0 || BH % H != 0 || hs <= 0) return false;
  if (!tile_ok(R) || !tile_ok(KT) || Tq <= 0 || Tk <= 0 || Tq % R != 0 || Tk % KT != 0)
    return false;
  if (BH > 65535 || (BH / H) * G > 65535) return false;  // grid y
  if (mask_mode < -1 || mask_mode > 3 || (mask_mode >= 0 && mq != 1 && mq != Tq)) return false;
  if (window < 0 || (window > 0 && !causal)) return false;
  if (dtype != 0 && dtype != 2) return false;                        // float32, bfloat16
  if (mma && (dtype != 2 || hs % 16 != 0)) return false;
  return true;
}

}  // namespace

// dtype codes: 0 = float32, 2 = bfloat16 (the Pallas kernels take these
// two).  mma: 1 selects the tensor-core body (bf16, hs % 16 == 0, 16-byte
// aligned tensors; the wrapper decides).  R, KT: query rows and keys per
// tile, 16, 32 or 64, picked by the wrapper so shared memory fits.  mask
// may be null (mask_mode -1).  Each returns the cudaError_t of its launch.
extern "C" int tt_flash_fwd(const void* q, const void* k, const void* v, const float* mask,
                            void* out, float* lse, int BH, int H, int G, int Tq, int Tk, int hs,
                            int mask_mode, int mq, int causal, int window, int R, int KT, int mma,
                            float scale, int dtype, void* stream) {
  Geometry g;
  if (!make_geometry(g, BH, H, G, Tq, Tk, hs, mask_mode, mq, causal, window, R, KT, mma, scale,
                     dtype))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float, false>(q, k, v, mask, out, lse, BH, g, s);
  if (mma) return launch_fwd<__nv_bfloat16, true>(q, k, v, mask, out, lse, BH, g, s);
  return launch_fwd<__nv_bfloat16, false>(q, k, v, mask, out, lse, BH, g, s);
}

extern "C" int tt_flash_bwd_dq(const void* go, const void* q, const void* k, const void* v,
                               const float* lse, const float* delta, const float* mask, void* dq,
                               int BH, int H, int G, int Tq, int Tk, int hs, int mask_mode, int mq,
                               int causal, int window, int R, int KT, int mma, float scale,
                               int dtype, void* stream) {
  Geometry g;
  if (!make_geometry(g, BH, H, G, Tq, Tk, hs, mask_mode, mq, causal, window, R, KT, mma, scale,
                     dtype))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dq<float, false>(go, q, k, v, lse, delta, mask, dq, BH, g, s);
  if (mma)
    return launch_dq<__nv_bfloat16, true>(go, q, k, v, lse, delta, mask, dq, BH, g, s);
  return launch_dq<__nv_bfloat16, false>(go, q, k, v, lse, delta, mask, dq, BH, g, s);
}

// R, KT: query rows per query tile and keys per block.
extern "C" int tt_flash_bwd_dkv(const void* go, const void* q, const void* k, const void* v,
                                const float* lse, const float* delta, const float* mask, void* dk,
                                void* dv, int BH, int H, int G, int Tq, int Tk, int hs,
                                int mask_mode, int mq, int causal, int window, int R, int KT,
                                int mma, float scale, int dtype, void* stream) {
  Geometry g;
  if (!make_geometry(g, BH, H, G, Tq, Tk, hs, mask_mode, mq, causal, window, R, KT, mma, scale,
                     dtype))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BG = (BH / H) * G;
  if (dtype == 0)
    return launch_dkv<float, false>(go, q, k, v, lse, delta, mask, dk, dv, BG, g, s);
  if (mma)
    return launch_dkv<__nv_bfloat16, true>(go, q, k, v, lse, delta, mask, dk, dv, BG, g, s);
  return launch_dkv<__nv_bfloat16, false>(go, q, k, v, lse, delta, mask, dk, dv, BG, g, s);
}
