// Multi-query paged attention and the chunk arena write for NVIDIA Hopper
// (sm_90a), plain C ABI.
//
// Replaces two Pallas TPU kernels of thunder_tpu/executors/pallasex.py that
// the chunked-prefill and speculative serving paths run (their third, the
// masked token write, shares paged_attention.cu's token-write kernel):
//
//   paged_attn_verify (pallasex.py:1376, body _paged_verify_kernel :1296):
//     T queries per request against the committed arena (every query sees
//     the slots < pos), then the chunk's own K/V folded last under the
//     causal mask col <= t.  T = K+1 in a speculative verify, the chunk
//     width (e.g. 512) in a chunked prefill.
//   paged_chunk_write (pallasex.py:1535, routing _chunk_dest :1520): chunk
//     block c lands as one (L, ng, bs, hs) slab at dest[pos / bs + c].
//   paged_chunk_write_fused (pallasex.py:1616, body :1595, the quantize
//     _absmax_quant :1579): the chunk write into an int8 or fp8-e4m3 arena,
//     quantizing each slot-head on the way (as paged_attention.cu's fused
//     token write), plus the masked error sums sum|dq - x| and sum|x| of
//     each chunk block behind the serving.kv_quant.rel_err gauge.
//
// Both verify bodies also read quantized arenas: each K/V element is
// dequantized as its tile loads (f32(x) * scale, rounded to the compute
// dtype, then to the query dtype, as the Pallas kernel rounds), so no
// dequantized arena ever exists and the tensor-core body runs on int8 and
// fp8 arenas too.
//
// What bounds them on an H100:
//   * verify at the spec shape (B=8, T=5) reads the live K/V once, like
//     decode: bytes.  At the chunk shape (B=1, T=512, pos up to ~3000) it
//     does 4*nh*hs*(pos*T + T*T/2) flops per layer, tens of GFLOP against
//     ~0.1 GB of K/V: operations.  The bf16 body runs WMMA tiles with the
//     running accumulators in shared memory (one load and store of them per
//     key tile), far from the 989 TFLOP/s peak still; wgmma with
//     register-resident accumulators is the next step.
//   * the chunk write moves bytes only (a 1 MiB slab per chunk block at
//     Llama-3-8B in bf16): bytes-bound.  So does the fused one: it reads
//     the compute-dtype slab and writes half as many bytes plus 3% of
//     scales.  One block per (chunk block, layer-group) slab, one warp per
//     slot; each block leaves its two partial sums in a scratch buffer and
//     a second small kernel adds them per chunk block in a fixed order, so
//     the sums repeat bit for bit (the TPU kernel adds them on one core in
//     grid order; here blocks finish in any order).
//
// Design of paged_attn_verify (simple and right first):
//   * The Pallas kernel keeps a (rep*T, hs) f32 accumulator of one (request,
//     group) in VMEM: 1 MiB at T=512, rep=4, past a Hopper block's 227 KB.
//     So the rep*T query rows (row r = rep_idx*T + t, the layout of q viewed
//     (B, ng, rep*T, hs)) are tiled over grid x: one block owns R <= 64 rows
//     of one (request, group) and keeps their queries, accumulators and
//     m/l in shared memory.
//   * The block walks key tiles: first the live arena blocks
//     [0, ceil(pos/bs)) of the table (keep-mask slot < pos, the same for
//     every query), then the fresh keys (keep col <= t, t = r % T; the
//     diagonal is always kept, so no row is ever fully masked).  One
//     online-softmax step per tile.
//   * Numerics copied from the Pallas kernel: mask value -0.7*FLT_MAX,
//     scores / sqrt(hs), arena and fresh K/V cast to the query dtype, p cast
//     to the query dtype before P.V, f32 m, l and accumulators, the fresh
//     term folded last.  Arena offsets are 64-bit.
//   * Two bodies share that walk.  When q and the arena are both bf16 (or
//     both f16) and bs and hs are multiples of 16, the products run on the
//     tensor cores (WMMA 16x16x16, f32 accumulation: the Pallas kernel's
//     dot_general with preferred_element_type=f32).  Each warp owns 16 query
//     rows, so the block's warps meet only at the two barriers around each
//     K/V tile load; a key tile spans up to four arena blocks (64 keys), so
//     the accumulators in shared memory are rescaled once per 64 keys.
//     Quantized arenas take it too, with the fresh K/V at the query dtype:
//     the tile load reads 8 storage bytes per thread, dequantizes them
//     with their slot's scale and stores the bf16/f16 values the products
//     read.  Otherwise (float32 queries, mixed dtypes, other block sizes) a
//     scalar-FMA body computes the same function over tiles of bs keys.

#include <mma.h>

#include "common.cuh"

namespace {

using tt::fp8_e4m3;
using tt::from_f;
using tt::kMaskValue;
using tt::load_kv;
using tt::quantized;
using tt::round_to;
using tt::to_f;

constexpr int kThreads = 256;

// floats of dynamic shared memory one verify block uses
size_t verify_smem_floats(int R, int hs, int bs) {
  const size_t hsp = static_cast<size_t>(hs) + 1;  // padded rows: no bank conflicts
  return R * hsp + static_cast<size_t>(R) * hs + bs * hsp + static_cast<size_t>(bs) * hs +
         static_cast<size_t>(R) * bs + 3 * static_cast<size_t>(R);
}

// grid (ceil(rows / R), ng, B), block kThreads.  TS: arena storage type;
// TC: the fresh K/V's compute type (TS itself unless TS is quantized).
// Dynamic shared memory, in floats:
//   qs[R*hsp] acc[R*hs] kt[bs*hsp] vt[bs*hs] sc[R*bs] m[R] l[R] corr[R]
template <typename TQ, typename TS, typename TC>
__global__ void __launch_bounds__(kThreads) paged_attn_verify_kernel(
    const TQ* __restrict__ q,           // (B, ng, rows, hs), rows = rep * T
    const TS* __restrict__ k_arena,     // (num_blocks, L, ng, bs, hs)
    const TS* __restrict__ v_arena,
    const float* __restrict__ k_scale,  // (num_blocks, L, ng, bs); quantized TS only
    const float* __restrict__ v_scale,
    const TC* __restrict__ fresh_k,     // (B, ng, T, hs)
    const TC* __restrict__ fresh_v,
    const int* __restrict__ tables,     // (B, nbb)
    const int* __restrict__ pos,        // (B,)
    TQ* __restrict__ out,               // (B, ng, rows, hs)
    int ng, int rows, int T, int hs, int bs, int nbb, int L, int layer, int R, float sm) {
  extern __shared__ float smem[];
  const int hsp = hs + 1;
  float* qs = smem;
  float* acc = qs + R * hsp;
  float* kt = acc + R * hs;
  float* vt = kt + bs * hsp;
  float* sc = vt + bs * hs;
  float* m = sc + R * bs;
  float* l = m + R;
  float* corr = l + R;

  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nr = min(R, rows - row0);
  const int p = pos[b];
  const int64_t q0 = ((static_cast<int64_t>(b) * ng + g) * rows + row0) * hs;

  for (int i = tid; i < R * hs; i += kThreads) {
    const int r = i / hs, d = i - r * hs;
    qs[r * hsp + d] = r < nr ? to_f<TQ>(q[q0 + i]) : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m[r] = kMaskValue;
    l[r] = 0.f;
  }

  // the table bounds the arena walk (a padding row's position may run past it)
  const int n_arena = min((p + bs - 1) / bs, nbb);
  const int n_fresh = (T + bs - 1) / bs;
  const int64_t tsz = static_cast<int64_t>(bs) * hs;
  const int64_t layer_stride = static_cast<int64_t>(ng) * tsz;
  const int64_t block_stride = static_cast<int64_t>(L) * layer_stride;
  const int64_t head_off = static_cast<int64_t>(layer) * layer_stride + g * tsz;
  const int64_t fresh0 = (static_cast<int64_t>(b) * ng + g) * T * hs;

  for (int it = 0; it < n_arena + n_fresh; ++it) {
    const bool arena = it < n_arena;
    const int c0 = arena ? it * bs : (it - n_arena) * bs;  // first slot / fresh column
    __syncthreads();                     // the previous tile's readers are done
    if (arena) {
      const int64_t base = tables[static_cast<int64_t>(b) * nbb + it] * block_stride + head_off;
      const int64_t sbase = base / hs;   // the scale of slot c is sbase + c
      for (int i = tid; i < bs * hs; i += kThreads) {
        const int c = i / hs, d = i - c * hs;
        float ks = 0.f, vs = 0.f;
        if constexpr (quantized<TS>::value) {
          ks = k_scale[sbase + c];
          vs = v_scale[sbase + c];
        }
        kt[c * hsp + d] = round_to<TQ>(load_kv<TS, TC>(k_arena[base + i], ks));
        vt[i] = round_to<TQ>(load_kv<TS, TC>(v_arena[base + i], vs));
      }
    } else {
      for (int i = tid; i < bs * hs; i += kThreads) {
        const int c = i / hs, d = i - c * hs;
        const bool ok = c0 + c < T;      // the last fresh tile may be partial
        const int64_t at = fresh0 + static_cast<int64_t>(c0 + c) * hs + d;
        kt[c * hsp + d] = ok ? round_to<TQ>(to_f<TC>(fresh_k[at])) : 0.f;
        vt[i] = ok ? round_to<TQ>(to_f<TC>(fresh_v[at])) : 0.f;
      }
    }
    __syncthreads();
    // scores: consecutive threads take consecutive keys of one row
    for (int pr = tid; pr < R * bs; pr += kThreads) {
      const int r = pr / bs, c = pr - r * bs;
      const float* qr = qs + r * hsp;
      const float* kc = kt + c * hsp;
      float dot = 0.f;
      for (int d = 0; d < hs; ++d) dot += qr[d] * kc[d];
      const int col = c0 + c;
      const bool keep = arena ? col < p : (col < T && col <= (row0 + r) % T);
      sc[pr] = keep ? dot / sm : kMaskValue;
    }
    __syncthreads();
    // one online-softmax step per query row
    for (int r = tid; r < R; r += kThreads) {
      float* s = sc + r * bs;
      float mx = m[r];
      for (int c = 0; c < bs; ++c) mx = fmaxf(mx, s[c]);
      float sum = 0.f;
      for (int c = 0; c < bs; ++c) {
        const float e = expf(s[c] - mx);
        s[c] = e;
        sum += e;
      }
      const float cr = expf(m[r] - mx);
      l[r] = l[r] * cr + sum;
      m[r] = mx;
      corr[r] = cr;
    }
    __syncthreads();
    // acc = acc * corr + cast(p) . V
    for (int i = tid; i < R * hs; i += kThreads) {
      const int r = i / hs, d = i - r * hs;
      const float* s = sc + r * bs;
      float pv = 0.f;
      for (int c = 0; c < bs; ++c) pv += round_to<TQ>(s[c]) * vt[c * hs + d];
      acc[i] = acc[i] * corr[r] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * hs; i += kThreads) {
    const int r = i / hs;
    out[q0 + i] = from_f<TQ>(acc[i] / l[r]);
  }
}

// grid (x tiles, nc), block 256.  Chunk block c (a slab of n vectors V)
// lands at block dest[pos / bs + c] of the arena, or at sink block 0 when
// that entry lies past the table.  Several chunk blocks may land in the sink
// at once; its bytes are never read.
template <typename V>
__global__ void paged_chunk_write_kernel(V* __restrict__ arena, const V* __restrict__ vals,
                                         const int* __restrict__ dest,
                                         const int* __restrict__ pos, int64_t n, int bs,
                                         int nbb) {
  const int c = blockIdx.y;
  const int idx = pos[0] / bs + c;
  const int64_t blk = idx < nbb ? dest[idx] : 0;
  V* dst = arena + blk * n;
  const V* src = vals + static_cast<int64_t>(c) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = src[i];
}

// grid (rows, nc), block 128 (4 warps), rows = L * ng.  Block (r, c) owns
// arena row r of chunk block c: bs slots of hs values, vals (nc, rows, bs,
// hs) at the compute type TV.  Warp w quantizes slots w, w + 4, ... into
// block dest[pos / bs + c] (sink block 0 past the table) of the quantized
// arena (num_blocks, rows, bs, hs) and its scale arena (num_blocks, rows,
// bs), and the block leaves sum|dq - x| and sum|x| over its slab in
// partial[c, r, 0..1] (lanes by xor shuffles, then warps in order).
template <typename TS, typename TV>
__global__ void __launch_bounds__(128) paged_chunk_write_fused_kernel(
    TS* __restrict__ arena, float* __restrict__ scale_arena, const TV* __restrict__ vals,
    const int* __restrict__ dest, const int* __restrict__ pos, float* __restrict__ partial,
    int rows, int bs, int hs, int nbb, float inv_qmax) {
  const int r = blockIdx.x, c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int idx = pos[0] / bs + c;
  const int64_t blk = idx < nbb ? dest[idx] : 0;
  const TV* src = vals + (static_cast<int64_t>(c) * rows + r) * bs * hs;
  const int64_t row0 = (blk * rows + r) * bs;        // the slab's first slot
  float e_err = 0.f, e_abs = 0.f;
  for (int t = warp; t < bs; t += 4) {
    const TV* x = src + static_cast<int64_t>(t) * hs;
    float amax = 0.f;
    for (int d = lane; d < hs; d += 32) amax = fmaxf(amax, fabsf(to_f<TV>(x[d])));
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = tt::absmax_scale(amax, inv_qmax);
    TS* dst = arena + (row0 + t) * hs;
    for (int d = lane; d < hs; d += 32) {
      const float xv = to_f<TV>(x[d]);
      const TS qv = tt::quantize<TS>(__fdiv_rn(xv, scale));
      dst[d] = qv;
      e_err += fabsf(__fmul_rn(to_f<TS>(qv), scale) - xv);
      e_abs += fabsf(xv);
    }
    if (lane == 0) scale_arena[row0 + t] = scale;
  }
  for (int o = 16; o > 0; o >>= 1) {
    e_err += __shfl_xor_sync(0xffffffffu, e_err, o);
    e_abs += __shfl_xor_sync(0xffffffffu, e_abs, o);
  }
  __shared__ float red[2][4];
  if (lane == 0) {
    red[0][warp] = e_err;
    red[1][warp] = e_abs;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int64_t at = (static_cast<int64_t>(c) * rows + r) * 2;
    partial[at] = red[0][0] + red[0][1] + red[0][2] + red[0][3];
    partial[at + 1] = red[1][0] + red[1][1] + red[1][2] + red[1][3];
  }
}

// grid nc, block 256: err[c, 0..1] = the sums of partial[c, :, 0..1] over
// the rows (each thread a strided run, then a tree: a fixed order), kept
// only when chunk block c was written to a real block (dest entry within
// the table and not the sink), as the Pallas kernel masks them.
__global__ void __launch_bounds__(256) chunk_err_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ err, const int* __restrict__ dest,
    const int* __restrict__ pos, int rows, int bs, int nbb) {
  const int c = blockIdx.x, tid = threadIdx.x;
  __shared__ float s[2][256];
  float a = 0.f, b = 0.f;
  for (int r = tid; r < rows; r += 256) {
    const int64_t at = (static_cast<int64_t>(c) * rows + r) * 2;
    a += partial[at];
    b += partial[at + 1];
  }
  s[0][tid] = a;
  s[1][tid] = b;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (tid < w) {
      s[0][tid] += s[0][tid + w];
      s[1][tid] += s[1][tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const int idx = pos[0] / bs + c;
    const bool live = idx < nbb && dest[min(idx, nbb - 1)] != 0;
    err[2 * c] = live ? s[0][0] : 0.f;
    err[2 * c + 1] = live ? s[1][0] : 0.f;
  }
}

// 8 quantized storage values (8 bytes at p, one slot, one scale) as the 8
// T values the tensor-core body stores in shared memory: f32(x) * scale
// rounded to T, the compute and query type alike.
template <typename T, typename TS>
__device__ __forceinline__ uint4 dequant8(const TS* p, float scale) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const TS* x = reinterpret_cast<const TS*>(&raw);
  uint4 out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = from_f<T>(__fmul_rn(to_f<TS>(x[e]), scale));
  return out;
}

// The tensor-core body: T is bf16 or f16 for q, the fresh K/V and a float
// arena alike; TS, the arena's storage, is T or a quantized type.
// grid (ceil(rows / R), ng, B), block 2*R threads (R/16 warps, 16 rows
// each).  A key tile holds KT = nbt * bs keys: nbt arena blocks (loaded
// together), or KT fresh keys.  Dynamic shared memory, in order, each row
// padded by 16 bytes so the rows of a 16x16 fragment fall in other banks
// (every buffer and fragment offset stays 32-byte aligned):
//   qs[R][hs+8] (T)  kt[KT][hs+8] (T)  vt[KT][hs+8] (T)  acc[R][hs+4] (f32)
//   sc[R][KT+4] (f32)  pb[R][KT+8] (T)  m[R] l[R] corr[R] (f32)
template <typename T, typename TS>
__global__ void __launch_bounds__(128) paged_attn_verify_mma_kernel(
    const T* __restrict__ q, const TS* __restrict__ k_arena, const TS* __restrict__ v_arena,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const T* __restrict__ fresh_k, const T* __restrict__ fresh_v,
    const int* __restrict__ tables, const int* __restrict__ pos, T* __restrict__ out, int ng,
    int rows, int T_, int hs, int bs, int nbb, int L, int layer, int R, int nbt, float sm) {
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int KT = nbt * bs;
  const int ldt = hs + 8, lda = hs + 4, lds = KT + 4, ldp = KT + 8;
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* kt = qs + R * ldt;
  T* vt = kt + KT * ldt;
  float* acc = reinterpret_cast<float*>(vt + KT * ldt);
  float* sc = acc + R * lda;
  T* pb = reinterpret_cast<T*>(sc + R * lds);
  float* m = reinterpret_cast<float*>(pb + R * ldp);
  float* l = m + R;
  float* corr = l + R;

  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int row0 = blockIdx.x * R;
  const int nr = min(R, rows - row0);
  const int p = pos[b];
  const int64_t q0 = ((static_cast<int64_t>(b) * ng + g) * rows + row0) * hs;
  const int vec = 16 / sizeof(T);                  // elements per 16-byte vector

  // queries (zero rows past the end), accumulators, softmax state
  for (int i = tid * vec; i < R * hs; i += nthreads * vec) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (i / hs < nr) v = *reinterpret_cast<const uint4*>(q + q0 + i);
    *reinterpret_cast<uint4*>(qs + (i / hs) * ldt + i % hs) = v;
  }
  for (int i = tid; i < R * lda; i += nthreads) acc[i] = 0.f;
  for (int r = tid; r < R; r += nthreads) {
    m[r] = kMaskValue;
    l[r] = 0.f;
  }

  const int n_blocks = min((p + bs - 1) / bs, nbb);  // live arena blocks
  const int n_arena = (n_blocks + nbt - 1) / nbt;
  const int n_fresh = (T_ + KT - 1) / KT;
  const int64_t tsz = static_cast<int64_t>(bs) * hs;
  const int64_t layer_stride = static_cast<int64_t>(ng) * tsz;
  const int64_t block_stride = static_cast<int64_t>(L) * layer_stride;
  const int64_t head_off = static_cast<int64_t>(layer) * layer_stride + g * tsz;
  const int64_t fresh0 = (static_cast<int64_t>(b) * ng + g) * T_ * hs;
  const int wr = warp * 16;                        // this warp's first row
  float* sw = sc + wr * lds;
  T* pw = pb + wr * ldp;
  float* aw = acc + wr * lda;
  const int half = lane & 1, lr = lane >> 1;       // two lanes per row in the softmax
  const int r = wr + lr;
  const int cols = KT / 2;

  for (int it = 0; it < n_arena + n_fresh; ++it) {
    const bool arena = it < n_arena;
    const int c0 = arena ? it * KT : (it - n_arena) * KT;  // first slot / fresh column
    __syncthreads();                     // every warp is done with the last tile
    for (int i = tid * vec; i < KT * hs; i += nthreads * vec) {
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (arena) {
        const int j = it * nbt + static_cast<int>(i / tsz);   // table column
        if (j < n_blocks) {
          const int64_t at = tables[static_cast<int64_t>(b) * nbb + j] * block_stride +
                             head_off + i % tsz;
          if constexpr (quantized<TS>::value) {
            kv = dequant8<T>(k_arena + at, k_scale[at / hs]);
            vv = dequant8<T>(v_arena + at, v_scale[at / hs]);
          } else {
            kv = *reinterpret_cast<const uint4*>(k_arena + at);
            vv = *reinterpret_cast<const uint4*>(v_arena + at);
          }
        }
      } else if (c0 + i / hs < T_) {     // the last fresh tile may be partial
        const int64_t at = fresh0 + static_cast<int64_t>(c0) * hs + i;
        kv = *reinterpret_cast<const uint4*>(fresh_k + at);
        vv = *reinterpret_cast<const uint4*>(fresh_v + at);
      }
      const int dst = (i / hs) * ldt + i % hs;
      *reinterpret_cast<uint4*>(kt + dst) = kv;
      *reinterpret_cast<uint4*>(vt + dst) = vv;
    }
    __syncthreads();
    // S = Q K^T for this warp's 16 rows: (16, hs) x (hs, KT)
    for (int n = 0; n < KT; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
      for (int k = 0; k < hs; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kb;
        wmma::load_matrix_sync(a, qs + wr * ldt + k, ldt);
        wmma::load_matrix_sync(kb, kt + n * ldt + k, ldt);
        wmma::mma_sync(s, a, kb, s);
      }
      wmma::store_matrix_sync(sw + n, s, lds, wmma::mem_row_major);
    }
    __syncwarp();
    // one online-softmax step per row; the lane pair (2*lr, 2*lr+1) takes
    // row wr + lr, half of the columns each
    {
      float* sr = sw + lr * lds + half * cols;
      float mx = m[r];
      for (int c = 0; c < cols; ++c) {
        const int col = c0 + half * cols + c;
        const bool keep = arena ? col < p : (col < T_ && col <= (row0 + r) % T_);
        sr[c] = keep ? sr[c] / sm : kMaskValue;
        mx = fmaxf(mx, sr[c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      float sum = 0.f;
      T* pr = pw + lr * ldp + half * cols;
      for (int c = 0; c < cols; ++c) {
        const float e = expf(sr[c] - mx);
        pr[c] = from_f<T>(e);
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float cr = expf(m[r] - mx);
      __syncwarp();
      if (half == 0) {
        l[r] = l[r] * cr + sum;
        m[r] = mx;
        corr[r] = cr;
      }
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const float cr = corr[wr + rr];
      for (int d = lane; d < hs; d += 32) aw[rr * lda + d] *= cr;
    }
    __syncwarp();
    // acc += cast(p) V: (16, KT) x (KT, hs)
    for (int j = 0; j < hs; j += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, aw + j, lda, wmma::mem_row_major);
      for (int k = 0; k < KT; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, pw + k, ldp);
        wmma::load_matrix_sync(vb, vt + k * ldt + j, ldt);
        wmma::mma_sync(o, pa, vb, o);
      }
      wmma::store_matrix_sync(aw + j, o, lda, wmma::mem_row_major);
    }
  }
  __syncwarp();
  for (int rr = 0; rr < 16 && wr + rr < nr; ++rr) {
    const float inv = 1.f / l[wr + rr];
    for (int d = lane; d < hs; d += 32)
      out[q0 + static_cast<int64_t>(wr + rr) * hs + d] = from_f<T>(aw[rr * lda + d] * inv);
  }
}

// bytes of dynamic shared memory one tensor-core verify block uses
size_t verify_mma_smem_bytes(int R, int hs, int KT, size_t esize) {
  const size_t r = R, ldt = hs + 8, lda = hs + 4, lds = KT + 4, ldp = KT + 8;
  return esize * (r + 2 * KT) * ldt + 4 * r * lda + 4 * r * lds + esize * r * ldp + 12 * r;
}

constexpr size_t kMaxSmem = 232448;                // shared memory a Hopper block may use

// arena blocks per key tile of the tensor-core body: up to 64 keys
int verify_mma_blocks_per_tile(int bs) { return bs >= 64 ? 1 : 64 / bs; }

template <typename T, typename TS>
cudaError_t launch_verify_mma(const void* q, const void* ka, const void* va, const float* ks,
                              const float* vs, const void* fk, const void* fv,
                              const int* tables, const int* pos, void* out, int B, int ng,
                              int rows, int T_, int hs, int bs, int nbb, int L, int layer,
                              float sm, cudaStream_t stream) {
  const int R = rows <= 16 ? 16 : rows <= 32 ? 32 : 64;
  const int nbt = verify_mma_blocks_per_tile(bs);
  const size_t smem = verify_mma_smem_bytes(R, hs, nbt * bs, sizeof(T));
  auto kern = paged_attn_verify_mma_kernel<T, TS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((rows + R - 1) / R, ng, B), 2 * R, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TS*>(ka), static_cast<const TS*>(va), ks, vs,
      static_cast<const T*>(fk), static_cast<const T*>(fv), tables, pos, static_cast<T*>(out),
      ng, rows, T_, hs, bs, nbb, L, layer, R, nbt, sm);
  return cudaGetLastError();
}

template <typename TQ, typename TS, typename TC>
cudaError_t launch_verify(const void* q, const void* ka, const void* va, const float* ks,
                          const float* vs, const void* fk, const void* fv, const int* tables,
                          const int* pos, void* out, int B, int ng, int rows, int T, int hs,
                          int bs, int nbb, int L, int layer, int R, float sm,
                          cudaStream_t stream) {
  const size_t smem = sizeof(float) * verify_smem_floats(R, hs, bs);
  auto kern = paged_attn_verify_kernel<TQ, TS, TC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((rows + R - 1) / R, ng, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TS*>(ka), static_cast<const TS*>(va), ks,
      vs, static_cast<const TC*>(fk), static_cast<const TC*>(fv), tables, pos,
      static_cast<TQ*>(out), ng, rows, T, hs, bs, nbb, L, layer, R, sm);
  return cudaGetLastError();
}

template <typename TS, typename TV>
cudaError_t launch_chunk_fused(void* arena, float* scale_arena, const void* vals, const int* dest,
                               const int* pos, float* err, float* partial, int nc, int rows,
                               int bs, int hs, int nbb, float inv_qmax, cudaStream_t s) {
  paged_chunk_write_fused_kernel<TS, TV><<<dim3(rows, nc), 128, 0, s>>>(
      static_cast<TS*>(arena), scale_arena, static_cast<const TV*>(vals), dest, pos, partial,
      rows, bs, hs, nbb, inv_qmax);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk_err_reduce_kernel<<<nc, 256, 0, s>>>(partial, err, dest, pos, rows, bs, nbb);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_chunk(void* arena, const void* vals, const int* dest, const int* pos, int nc,
                         int64_t slab_bytes, int bs, int nbb, cudaStream_t s) {
  const int64_t n = slab_bytes / static_cast<int64_t>(sizeof(V));
  const int threads = 256;
  const int64_t per_block = threads * 4;   // about four vectors per thread
  const int64_t tiles = (n + per_block - 1) / per_block;
  const int gx = static_cast<int>(tiles < 1024 ? (tiles > 0 ? tiles : 1) : 1024);
  paged_chunk_write_kernel<V><<<dim3(gx, nc), threads, 0, s>>>(
      static_cast<V*>(arena), static_cast<const V*>(vals), dest, pos, n, bs, nbb);
  return cudaGetLastError();
}

// Whether the tensor-core body takes these dtype codes and shapes: bf16 or
// f16 queries and fresh K/V, an arena of the same type or a quantized one,
// bs and hs multiples of 16, and the shared memory of 64 rows fitting.
bool verify_mma_ok(int q_dtype, int kv_dtype, int c_dtype, int hs, int bs) {
  return q_dtype != 0 && c_dtype == q_dtype && (kv_dtype == q_dtype || kv_dtype >= 3) &&
         bs % 16 == 0 && hs % 16 == 0 &&
         verify_mma_smem_bytes(64, hs, verify_mma_blocks_per_tile(bs) * bs, 2) <= kMaxSmem;
}

}  // namespace

// dtype codes: q_dtype and c_dtype (the fresh K/V) 0 = float32,
// 1 = float16, 2 = bfloat16; kv_dtype (the arena) those or 3 = int8,
// 4 = float8_e4m3fn, whose k_scale/v_scale (num_blocks, L, ng, bs) float32
// must then be given (null otherwise).  An unquantized arena has the fresh
// K/V's dtype.  rows = rep * T.  R: query rows per block of the scalar body
// (the wrapper picks it so the shared memory fits); the tensor-core body
// picks its own (16, 32 or 64).  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int tt_paged_attn_verify(const void* q, const void* k_arena, const void* v_arena,
                                    const float* k_scale, const float* v_scale,
                                    const void* fresh_k, const void* fresh_v,
                                    const int* tables, const int* pos, void* out, int B,
                                    int ng, int rows, int T, int hs, int bs, int nbb, int L,
                                    int layer, int R, float sm, int q_dtype, int kv_dtype,
                                    int c_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (verify_mma_ok(q_dtype, kv_dtype, c_dtype, hs, bs)) {
    return tt::by_float(q_dtype, [&](auto tq) {
      return tt::by_storage(kv_dtype, [&](auto ts) -> cudaError_t {
        using TQ = decltype(tq);
        using TS = decltype(ts);
        if constexpr (std::is_same<TQ, float>::value || !tt::kv_pair_ok<TS, TQ>()) {
          return cudaErrorInvalidValue;
        } else {
          return launch_verify_mma<TQ, TS>(q, k_arena, v_arena, k_scale, v_scale, fresh_k,
                                           fresh_v, tables, pos, out, B, ng, rows, T, hs, bs,
                                           nbb, L, layer, sm, s);
        }
      });
    });
  }
  return tt::by_float(q_dtype, [&](auto tq) {
    return tt::by_float(c_dtype, [&](auto tc) {
      return tt::by_storage(kv_dtype, [&](auto ts) -> cudaError_t {
        using TQ = decltype(tq);
        using TC = decltype(tc);
        using TS = decltype(ts);
        if constexpr (!tt::kv_pair_ok<TS, TC>()) {
          return cudaErrorInvalidValue;
        } else {
          return launch_verify<TQ, TS, TC>(q, k_arena, v_arena, k_scale, v_scale, fresh_k,
                                           fresh_v, tables, pos, out, B, ng, rows, T, hs, bs,
                                           nbb, L, layer, R, sm, s);
        }
      });
    });
  });
}

// The chunk write into a quantized arena (kv_dtype 3 = int8, 4 = fp8
// e4m3), quantizing vals (nc, rows, bs, hs) at v_dtype (0/1/2) on the way;
// err: (nc, 2) float32, the masked sum|dq - x| and sum|x| of each chunk
// block; partial: (nc, rows, 2) float32 scratch.  inv_qmax is f32(1/qmax).
// Two launches: the write, then the fixed-order reduction of the sums.
extern "C" int tt_paged_chunk_write_fused(void* arena, float* scale_arena, const void* vals,
                                          const int* dest, const int* pos, float* err,
                                          float* partial, int nc, int rows, int bs, int hs,
                                          int nbb, float inv_qmax, int kv_dtype, int v_dtype,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc == 0) return cudaSuccess;
  return tt::by_float(v_dtype, [&](auto tv) {
    return tt::by_storage(kv_dtype, [&](auto ts) -> cudaError_t {
      using TV = decltype(tv);
      using TS = decltype(ts);
      if constexpr (!quantized<TS>::value) {
        return cudaErrorInvalidValue;
      } else {
        return launch_chunk_fused<TS, TV>(arena, scale_arena, vals, dest, pos, err, partial, nc,
                                          rows, bs, hs, nbb, inv_qmax, s);
      }
    });
  });
}

// vec_bytes: 16, 8, 4, 2 or 1 — the widest that divides the slab and both
// base addresses (the wrapper picks it); the copy moves bits.
extern "C" int tt_paged_chunk_write(void* arena, const void* vals, const int* dest,
                                    const int* pos, int nc, int64_t slab_bytes, int bs, int nbb,
                                    int vec_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc == 0) return cudaSuccess;
  switch (vec_bytes) {
    case 16: return launch_chunk<uint4>(arena, vals, dest, pos, nc, slab_bytes, bs, nbb, s);
    case 8: return launch_chunk<uint2>(arena, vals, dest, pos, nc, slab_bytes, bs, nbb, s);
    case 4: return launch_chunk<uint32_t>(arena, vals, dest, pos, nc, slab_bytes, bs, nbb, s);
    case 2: return launch_chunk<uint16_t>(arena, vals, dest, pos, nc, slab_bytes, bs, nbb, s);
    case 1: return launch_chunk<uint8_t>(arena, vals, dest, pos, nc, slab_bytes, bs, nbb, s);
    default: return cudaErrorInvalidValue;
  }
}
