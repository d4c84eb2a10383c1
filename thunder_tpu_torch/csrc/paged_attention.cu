// Paged-attention decode and single-token write kernels for NVIDIA Hopper
// (sm_90a), plain C ABI.
//
// Replaces three Pallas TPU kernels of thunder_tpu/executors/pallasex.py:
//
//   paged_attn_decode (pallasex.py:1165, body _paged_kernel :1076, walk
//     _ragged_step :1148): single-token attention read straight off the
//     rank-5 KV block arena (num_blocks, L, ng, bs, hs).
//   paged_token_write (pallasex.py:1249, body _paged_write_kernel :1241):
//     in-place write of each request's fresh K/V (or scale) into its slot.
//   paged_token_write_masked (pallasex.py:1462): the same write of chunk
//     offset k at pos + k iff k < n_emit[b], else into sink block 0, slot 0
//     (the speculative commit).  One kernel serves both writes: the plain
//     write passes no n_emit and offset 0.
//   paged_token_write_fused (pallasex.py:1672, body :1661, the quantize
//     _absmax_quant :1579): the token write (plain or masked) into an int8
//     or fp8-e4m3 arena, quantizing on the way: per (row, layer, group) the
//     f32 absmax over hs, scale = amax == 0 ? 1 : amax * f32(1/qmax), the
//     values x / scale rounded into storage, value and scale stored.
//
// The decode kernel also reads quantized arenas: each K/V element is
// dequantized as its tile loads (f32(x) * scale, rounded to the compute
// dtype, then to the query dtype, as the Pallas kernel rounds).
//
// What bounds them on an H100: all are memory-bound.  Decode attention
// reads each live K/V byte once and does ~2 flops per byte (at Llama-3-8B,
// B=8, pos~1024: 33.5 MB per layer, ~10 us at 3.35 TB/s; half of it, plus
// 3% of scales, from a 1-byte arena).  A token write moves ~0.5 MB per call
// (~0.8 MB fused: compute-dtype values in, bytes and scales out) and is
// dominated by launch cost; its grid spans (request, row tile) so the copy
// spreads over the SMs.  The fused write gives one warp to each (row,
// layer, group): the absmax is a warp-shuffle max (order-free, so the
// scale is bit-exact), the quotient an IEEE division (never a reciprocal
// multiply), so the stored bytes equal serving.quant.quantize_kv's.
//
// Design (simple and right first; speed is later work):
//   * One thread block per (request, KV group).  A loop inside the block
//     replaces the TPU's sequential grid axis over table entries.  It visits
//     only the request's live blocks [lo, ceil(pos/bs)) — lo from the
//     sliding window — which replaces both the Pallas skip predicate and the
//     fetch clamp of _ragged_step.  Each iteration reads tables[b, j] itself
//     (there is no scalar prefetch on a GPU).
//   * The (bs, hs) K and V tiles of `layer` are staged in shared memory,
//     addressed inside the whole arena by strides: the kernel never takes a
//     per-layer slice (arena[:, l] would be a full-arena copy).
//   * The online-softmax state m, l and the f32 accumulator of the `rep`
//     query rows of the group live in shared memory, so any GQA ratio (1 for
//     MHA up to 71 for Falcon's MQA) fits the same kernel; head h belongs to
//     group h / rep.
//   * After the walk the fresh token is folded as the final, never-masked
//     term and acc / l is written.  A row with pos = 0 (batch padding) reads
//     no arena block and returns the fresh V.
//   * Only B * ng blocks are in flight (64 at the Llama-3-8B serving shape,
//     on 132 SMs), so this design under-fills the card; splitting the KV
//     walk across blocks (flash-decoding split-K) is the next step.
//
// Numerics follow the Pallas kernel: masked scores take -0.7 * FLT_MAX (not
// -inf), scores are divided by sqrt(hs), arena and fresh K/V are cast to the
// query dtype before use, and the probabilities are cast to the query dtype
// before the P.V product, which accumulates in f32.

#include "common.cuh"

namespace {

using tt::fp8_e4m3;
using tt::from_f;
using tt::kMaskValue;
using tt::load_kv;
using tt::quantized;
using tt::round_to;
using tt::to_f;

constexpr int kThreads = 128;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (ng, B), block kThreads.  TS: arena storage type; TC: the compute
// type of the fresh K/V (TS itself unless TS is quantized).  Dynamic shared
// memory, in floats:
//   qs[rep*hs] acc[rep*hs] kt[bs*hs] vt[bs*hs] sc[rep*bs] m[rep] l[rep] corr[rep]
template <typename TQ, typename TS, typename TC>
__global__ void __launch_bounds__(kThreads) paged_attn_decode_kernel(
    const TQ* __restrict__ q,           // (B, nh, hs)
    const TS* __restrict__ k_arena,     // (num_blocks, L, ng, bs, hs)
    const TS* __restrict__ v_arena,
    const float* __restrict__ k_scale,  // (num_blocks, L, ng, bs); quantized TS only
    const float* __restrict__ v_scale,
    const TC* __restrict__ fresh_k,     // (B, ng, hs)
    const TC* __restrict__ fresh_v,
    const int* __restrict__ tables,     // (B, nbb)
    const int* __restrict__ pos,        // (B,)
    TQ* __restrict__ out,               // (B, nh, hs)
    int ng, int rep, int hs, int bs, int nbb, int L, int layer, int window, float sm) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* acc = qs + rep * hs;
  float* kt = acc + rep * hs;
  float* vt = kt + bs * hs;
  float* sc = vt + bs * hs;
  float* m = sc + rep * bs;
  float* l = m + rep;
  float* corr = l + rep;

  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int p = pos[b];
  const int64_t row0 = (static_cast<int64_t>(b) * ng + g) * rep * hs;  // first q/out element

  for (int i = tid; i < rep * hs; i += kThreads) {
    qs[i] = to_f<TQ>(q[row0 + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m[r] = kMaskValue;
    l[r] = 0.f;
  }
  __syncthreads();

  // live blocks: slots [0, p) clipped to the window (p - window, p); the
  // table bounds the walk (a padding row's position may run past it)
  const int hi = min((p + bs - 1) / bs, nbb);
  int lo = 0;
  if (window > 0) {
    const int first = p - (window - 1);
    lo = (first > 0 ? first : 0) / bs;
  }
  const int64_t tile = static_cast<int64_t>(bs) * hs;
  const int64_t layer_stride = static_cast<int64_t>(ng) * tile;
  const int64_t block_stride = static_cast<int64_t>(L) * layer_stride;
  const int64_t head_off = static_cast<int64_t>(layer) * layer_stride + g * tile;

  for (int j = lo; j < hi; ++j) {
    const int64_t base = tables[static_cast<int64_t>(b) * nbb + j] * block_stride + head_off;
    const int64_t sbase = base / hs;     // the scale of element base + i is sbase + i / hs
    for (int i = tid; i < tile; i += kThreads) {
      float ks = 0.f, vs = 0.f;
      if constexpr (quantized<TS>::value) {
        ks = k_scale[sbase + i / hs];
        vs = v_scale[sbase + i / hs];
      }
      kt[i] = round_to<TQ>(load_kv<TS, TC>(k_arena[base + i], ks));
      vt[i] = round_to<TQ>(load_kv<TS, TC>(v_arena[base + i], vs));
    }
    __syncthreads();
    // scores, one warp per (query row, slot) pair
    for (int pr = warp; pr < rep * bs; pr += nwarps) {
      const int r = pr / bs, t = pr - (pr / bs) * bs;
      float dot = 0.f;
      for (int d = lane; d < hs; d += 32) dot += qs[r * hs + d] * kt[t * hs + d];
      dot = warp_sum(dot);
      if (lane == 0) {
        const int slot = j * bs + t;
        const bool keep = slot < p && (window <= 0 || slot > p - window);
        sc[pr] = keep ? dot / sm : kMaskValue;
      }
    }
    __syncthreads();
    // one online-softmax step per query row
    for (int r = tid; r < rep; r += kThreads) {
      float mx = m[r];
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, sc[r * bs + t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float e = expf(sc[r * bs + t] - mx);
        sc[r * bs + t] = e;
        sum += e;
      }
      const float c = expf(m[r] - mx);
      l[r] = l[r] * c + sum;
      m[r] = mx;
      corr[r] = c;
    }
    __syncthreads();
    // acc = acc * corr + cast(p) . V
    for (int i = tid; i < rep * hs; i += kThreads) {
      const int r = i / hs, d = i - (i / hs) * hs;
      float pv = 0.f;
      for (int t = 0; t < bs; ++t) pv += round_to<TQ>(sc[r * bs + t]) * vt[t * hs + d];
      acc[i] = acc[i] * corr[r] + pv;
    }
    __syncthreads();
  }

  // the fresh token: the final, never-masked term
  const int64_t fresh0 = (static_cast<int64_t>(b) * ng + g) * hs;
  for (int i = tid; i < hs; i += kThreads) {
    kt[i] = round_to<TQ>(to_f<TC>(fresh_k[fresh0 + i]));
    vt[i] = round_to<TQ>(to_f<TC>(fresh_v[fresh0 + i]));
  }
  __syncthreads();
  for (int r = warp; r < rep; r += nwarps) {
    float dot = 0.f;
    for (int d = lane; d < hs; d += 32) dot += qs[r * hs + d] * kt[d];
    dot = warp_sum(dot);
    if (lane == 0) sc[r] = dot / sm;
  }
  __syncthreads();
  for (int r = tid; r < rep; r += kThreads) {
    const float mx = fmaxf(m[r], sc[r]);
    const float e = expf(sc[r] - mx);
    const float c = expf(m[r] - mx);
    l[r] = l[r] * c + e;
    corr[r] = c;
    sc[r] = e;
  }
  __syncthreads();
  for (int i = tid; i < rep * hs; i += kThreads) {
    const int r = i / hs, d = i - (i / hs) * hs;
    const float a = acc[i] * corr[r] + round_to<TQ>(sc[r]) * vt[d];
    out[row0 + i] = from_f<TQ>(a / l[r]);
  }
}

// grid (B, row tiles), block 256.  arena: (num_blocks, rows, bs, hs) with
// rows = L * ng (hs = 1 for a rank-4 scale arena); vals: (B, rows, hs).  Row
// b lands at block tables[b, (pos[b] + offset) / bs] (the column clamped to
// the table), slot (pos[b] + offset) % bs, when n_emit is null or offset <
// n_emit[b]; else at block 0, slot 0, the sink.  Batch-padding rows carry
// all-sink tables and write the sink too; several rows may write it at
// once, and nothing reads it.
template <typename E>
__global__ void paged_token_write_kernel(E* __restrict__ arena, const E* __restrict__ vals,
                                         const int* __restrict__ tables,
                                         const int* __restrict__ pos,
                                         const int* __restrict__ n_emit, int offset, int rows,
                                         int bs, int hs, int nbb, int rows_per_tile) {
  const int b = blockIdx.x;
  const int r0 = blockIdx.y * rows_per_tile;
  const int nr = min(rows_per_tile, rows - r0);
  int64_t blk = 0;
  int slot = 0;
  if (n_emit == nullptr || offset < n_emit[b]) {
    const int p = pos[b] + offset;
    blk = tables[static_cast<int64_t>(b) * nbb + min(p / bs, nbb - 1)];
    slot = p % bs;
  }
  E* dst = arena + ((blk * rows + r0) * bs + slot) * hs;
  const E* src = vals + (static_cast<int64_t>(b) * rows + r0) * hs;
  const int bs_hs = bs * hs;
  for (int i = threadIdx.x; i < nr * hs; i += blockDim.x) {
    const int r = i / hs, d = i - r * hs;
    dst[static_cast<int64_t>(r) * bs_hs + d] = src[i];
  }
}

template <typename E>
cudaError_t launch_token_write(void* arena, const void* vals, const int* tables, const int* pos,
                               const int* n_emit, int offset, int B, int rows, int bs, int hs,
                               int nbb, cudaStream_t s) {
  const int threads = 256;
  // about four elements per thread: 8 rows of hs = 128, or 1024 scale rows
  const int rows_per_tile = hs >= 4 * threads ? 1 : (4 * threads) / hs;
  const int tiles = (rows + rows_per_tile - 1) / rows_per_tile;
  paged_token_write_kernel<E><<<dim3(B, tiles), threads, 0, s>>>(
      static_cast<E*>(arena), static_cast<const E*>(vals), tables, pos, n_emit, offset, rows,
      bs, hs, nbb, rows_per_tile);
  return cudaGetLastError();
}

cudaError_t token_write(void* arena, const void* vals, const int* tables, const int* pos,
                        const int* n_emit, int offset, int B, int rows, int bs, int hs, int nbb,
                        int elem_bytes, cudaStream_t s) {
  if (B == 0) return cudaSuccess;
  switch (elem_bytes) {
    case 1:
      return launch_token_write<uint8_t>(arena, vals, tables, pos, n_emit, offset, B, rows, bs,
                                         hs, nbb, s);
    case 2:
      return launch_token_write<uint16_t>(arena, vals, tables, pos, n_emit, offset, B, rows, bs,
                                          hs, nbb, s);
    case 4:
      return launch_token_write<uint32_t>(arena, vals, tables, pos, n_emit, offset, B, rows, bs,
                                          hs, nbb, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// grid (B, ceil(rows / 8)), block 256: one warp per (request b, arena row r)
// with rows = L * ng.  vals: (B, rows, hs) at the compute type TV; arena:
// (num_blocks, rows, bs, hs) quantized storage TS; scale_arena: (num_blocks,
// rows, bs).  Routing as paged_token_write_kernel (sink block 0, slot 0 for
// a row whose offset is not below n_emit[b]).
template <typename TS, typename TV>
__global__ void __launch_bounds__(256) paged_token_write_fused_kernel(
    TS* __restrict__ arena, float* __restrict__ scale_arena, const TV* __restrict__ vals,
    const int* __restrict__ tables, const int* __restrict__ pos, const int* __restrict__ n_emit,
    int offset, int rows, int bs, int hs, int nbb, float inv_qmax) {
  const int b = blockIdx.x;
  const int r = blockIdx.y * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;               // the whole warp leaves together
  int64_t blk = 0;
  int slot = 0;
  if (n_emit == nullptr || offset < n_emit[b]) {
    const int p = pos[b] + offset;
    blk = tables[static_cast<int64_t>(b) * nbb + min(p / bs, nbb - 1)];
    slot = p % bs;
  }
  const TV* src = vals + (static_cast<int64_t>(b) * rows + r) * hs;
  float amax = 0.f;
  for (int d = lane; d < hs; d += 32) amax = fmaxf(amax, fabsf(to_f<TV>(src[d])));
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = tt::absmax_scale(amax, inv_qmax);
  const int64_t row = (blk * rows + r) * bs + slot;
  TS* dst = arena + row * hs;
  for (int d = lane; d < hs; d += 32)
    dst[d] = tt::quantize<TS>(__fdiv_rn(to_f<TV>(src[d]), scale));
  if (lane == 0) scale_arena[row] = scale;
}

template <typename TS, typename TV>
cudaError_t launch_token_write_fused(void* arena, float* scale_arena, const void* vals,
                                     const int* tables, const int* pos, const int* n_emit,
                                     int offset, int B, int rows, int bs, int hs, int nbb,
                                     float inv_qmax, cudaStream_t s) {
  paged_token_write_fused_kernel<TS, TV><<<dim3(B, (rows + 7) / 8), 256, 0, s>>>(
      static_cast<TS*>(arena), scale_arena, static_cast<const TV*>(vals), tables, pos, n_emit,
      offset, rows, bs, hs, nbb, inv_qmax);
  return cudaGetLastError();
}

template <typename TQ, typename TS, typename TC>
cudaError_t launch_decode(const void* q, const void* ka, const void* va, const float* ks,
                          const float* vs, const void* fk, const void* fv, const int* tables,
                          const int* pos, void* out, int B, int ng, int rep, int hs, int bs,
                          int nbb, int L, int layer, int window, float sm, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(rep) * hs + 2 * static_cast<size_t>(bs) * hs +
                       static_cast<size_t>(rep) * bs + 3 * static_cast<size_t>(rep));
  auto kern = paged_attn_decode_kernel<TQ, TS, TC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(ng, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TS*>(ka), static_cast<const TS*>(va), ks,
      vs, static_cast<const TC*>(fk), static_cast<const TC*>(fv), tables, pos,
      static_cast<TQ*>(out), ng, rep, hs, bs, nbb, L, layer, window, sm);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: q_dtype and c_dtype (the fresh K/V) 0 = float32,
// 1 = float16, 2 = bfloat16; kv_dtype (the arena) those or 3 = int8,
// 4 = float8_e4m3fn, whose k_scale/v_scale (num_blocks, L, ng, bs) float32
// must then be given (null otherwise).  An unquantized arena has the fresh
// K/V's dtype.  window <= 0 means no sliding window.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int tt_paged_attn_decode(const void* q, const void* k_arena, const void* v_arena,
                                    const float* k_scale, const float* v_scale,
                                    const void* fresh_k, const void* fresh_v,
                                    const int* tables, const int* pos, void* out, int B,
                                    int ng, int rep, int hs, int bs, int nbb, int L, int layer,
                                    int window, float sm, int q_dtype, int kv_dtype,
                                    int c_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tt::by_float(q_dtype, [&](auto tq) {
    return tt::by_float(c_dtype, [&](auto tc) {
      return tt::by_storage(kv_dtype, [&](auto ts) -> cudaError_t {
        using TQ = decltype(tq);
        using TC = decltype(tc);
        using TS = decltype(ts);
        if constexpr (!tt::kv_pair_ok<TS, TC>()) {
          return cudaErrorInvalidValue;
        } else {
          return launch_decode<TQ, TS, TC>(q, k_arena, v_arena, k_scale, v_scale, fresh_k,
                                           fresh_v, tables, pos, out, B, ng, rep, hs, bs, nbb,
                                           L, layer, window, sm, s);
        }
      });
    });
  });
}

// elem_bytes: 1, 2 or 4 (the writes move bits, whatever the dtype).
extern "C" int tt_paged_token_write(void* arena, const void* vals, const int* tables,
                                    const int* pos, int B, int rows, int bs, int hs, int nbb,
                                    int elem_bytes, void* stream) {
  return token_write(arena, vals, tables, pos, nullptr, 0, B, rows, bs, hs, nbb, elem_bytes,
                     static_cast<cudaStream_t>(stream));
}

// The keep-masked write: chunk offset `offset` of each row, live iff
// offset < n_emit[b].
extern "C" int tt_paged_token_write_masked(void* arena, const void* vals, const int* tables,
                                           const int* pos, const int* n_emit, int offset, int B,
                                           int rows, int bs, int hs, int nbb, int elem_bytes,
                                           void* stream) {
  return token_write(arena, vals, tables, pos, n_emit, offset, B, rows, bs, hs, nbb, elem_bytes,
                     static_cast<cudaStream_t>(stream));
}

// The token write into a quantized arena (kv_dtype 3 = int8, 4 = fp8
// e4m3), quantizing vals (v_dtype 0/1/2, the compute dtype) on the way;
// n_emit null is the plain write (offset 0), else the keep-masked one.
// inv_qmax is f32(1/qmax) (1/127 or 1/448).
extern "C" int tt_paged_token_write_fused(void* arena, float* scale_arena, const void* vals,
                                          const int* tables, const int* pos, const int* n_emit,
                                          int offset, int B, int rows, int bs, int hs, int nbb,
                                          float inv_qmax, int kv_dtype, int v_dtype,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  return tt::by_float(v_dtype, [&](auto tv) {
    return tt::by_storage(kv_dtype, [&](auto ts) -> cudaError_t {
      using TV = decltype(tv);
      using TS = decltype(ts);
      if constexpr (!quantized<TS>::value) {
        return cudaErrorInvalidValue;
      } else {
        return launch_token_write_fused<TS, TV>(arena, scale_arena, vals, tables, pos, n_emit,
                                                offset, B, rows, bs, hs, nbb, inv_qmax, s);
      }
    });
  });
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
