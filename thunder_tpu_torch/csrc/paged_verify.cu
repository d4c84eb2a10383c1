// Multi-query paged attention at many query rows and the chunk arena write
// for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces two Pallas TPU kernels of thunder_tpu/executors/pallasex.py that
// the chunked-prefill and speculative serving paths run (their third, the
// masked token write, shares paged_attention.cu's token-write kernel):
//
//   paged_attn_verify (pallasex.py:1376, pallas_call :1441, body
//     _paged_verify_kernel :1296): T queries per request against the
//     committed arena (every query sees the slots < pos), then the chunk's
//     own K/V folded last under the causal mask col <= t.  T = the chunk
//     width (e.g. 512) in a chunked prefill.  Calls with few query rows
//     (rep * T <= 64: the speculative verify, T = K+1, and small chunk
//     pieces) take paged_attention.cu's split-K body instead
//     (cudaex.paged_body names the body of every call).
//   paged_chunk_write (pallasex.py:1535, routing _chunk_dest :1520): chunk
//     block c lands as one (L, ng, bs, hs) slab at dest[pos / bs + c]; the
//     pair write lands K and V of a chunk piece in one launch.
//   paged_chunk_write_fused (pallasex.py:1616, body :1595, the quantize
//     _absmax_quant :1579): the chunk write into an int8 or fp8-e4m3 arena,
//     quantizing each slot-head on the way (as paged_attention.cu's fused
//     token write), plus the masked error sums sum|dq - x| and sum|x| of
//     each chunk block behind the serving.kv_quant.rel_err gauge.
//
// Every verify body also reads quantized arenas: each K/V element is
// dequantized as its tile loads (f32(x) * scale, rounded to the compute
// dtype, then to the query dtype, as the Pallas kernel rounds), so no
// dequantized arena ever exists.
//
// What bounds them on an H100:
//   * verify at the chunk shape (B=1, T=512, pos ~2500) does
//     4*nh*hs*(pos*T + T*T/2) flops per layer, tens of GFLOP against
//     ~0.1 GB of K/V: operations (23.9 us at 989 TFLOP/s at pos 2560).
//   * the chunk write moves bytes only (a 1 MiB slab per chunk block at
//     Llama-3-8B in bf16; K and V of a 512-token piece: 134 MB, 40.1 us):
//     bytes-bound.  The pair write reads both arenas' values in place from
//     the engine's (1, L, ng, T, hs) layout, where each (chunk block, arena
//     row) is one contiguous run of bs * hs elements (4 KiB at bs 16, hs
//     128 in bf16) as it is in the arena, so no staging copy folds them
//     into block granules: one launch moves whole runs as the widest
//     vectors dividing runs, strides and bases, four runs per block with
//     every load in flight before the first store.  The fused write is
//     bytes-bound too: it reads the compute-dtype values once and writes
//     half as many bytes plus 3% of scales (K and V of a 512-token piece: 101 MB, 30.4 us).  One pass
//     writes both arenas and their scale arenas, reading each arena's
//     fresh values in place from the engine's (1, L, ng, T, hs) layout (no
//     staging copy into block granules): a group of hs / 8 lanes per
//     slot-head, 8 values per lane from one 16-byte load, the absmax by xor
//     shuffles within the group, the quantize from the same registers, 8
//     bytes stored per lane and one scale per slot-head.  Each block leaves
//     its two partial error sums in a scratch buffer and a second small
//     kernel adds them per (arena, chunk block) in a fixed order, so the
//     sums repeat bit for bit (the TPU kernel adds them on one core in
//     grid order; here blocks finish in any order).

// Three verify bodies; the wrapper names one (cudaex.paged_body):
//
// The warpgroup body (bf16/f16 queries with the arena in that type or
// quantized, hs 64 or 128, 64 % bs == 0): the chunk shape.  Hopper's wgmma
// with every accumulator in registers (wgmma.cuh), as flash_attention.cu's
// forward:
//   * A block is one warpgroup owning 64 query rows of one (request,
//     group); 82-103 KB of shared memory, so two blocks share an SM and one's
//     softmax overlaps the other's products.  The grid (ng, B, row tiles)
//     schedules the heaviest row tiles (the last t of each head) first.
//   * Key tiles are 64 keys: 64 / bs arena blocks, each a contiguous bs*hs
//     slab at 64-bit strides inside the whole arena, the table entries read
//     by the block itself (each thread reads the entries its copies need
//     before it issues any); then the fresh keys.  They arrive through a
//     two-stage cp.async ring in the 128-byte swizzle the descriptors read:
//     the copies of tile it + 1 are issued while tile it's S product runs.
//     A quantized tile's stored bytes and scales arrive by cp.async a tile
//     earlier still, into raw slots each thread owns (16 bytes, 16 values,
//     per copy); the thread dequantizes its own slots into the tile the
//     products read, so no dequantized arena exists and no extra barrier
//     guards the slots.
//   * S = Q.K^T is an SS m64n64k16 wgmma, P.V an RS m64nHSk16 with V read
//     MN-major; the online softmax stays in registers and P, rounded to the
//     query type (the reference's rounding), is packed straight into the A
//     operand.
//   * Masks: the arena keep-mask slot < pos is the same for every row, so
//     only the last partial tile does per-element work; the fresh walk keeps
//     col <= t and stops after the tile holding the largest t of the block's
//     rows (a 64-row tile may straddle two heads when T % 64 != 0), so the
//     tiles wholly above the diagonal are never walked.
//
// The WMMA body (bf16/f16 at other head sizes that are multiples of 16, bs
// a multiple of 16) and the scalar body (float32, other shapes), simple and
// right first:
//   * The Pallas kernel keeps a (rep*T, hs) f32 accumulator of one (request,
//     group) in VMEM: 1 MiB at T=512, rep=4, past a Hopper block's 227 KB.
//     So the rep*T query rows (row r = rep_idx*T + t, the layout of q viewed
//     (B, ng, rep*T, hs)) are tiled over grid x: one block owns R <= 64 rows
//     of one (request, group) and keeps their queries, accumulators and
//     m/l in shared memory.
//   * The block walks key tiles: first the live arena blocks
//     [0, ceil(pos/bs)) of the table (keep-mask slot < pos), then the fresh
//     keys (keep col <= t, t = r % T; the diagonal is always kept, so no row
//     is ever fully masked).  One online-softmax step per tile.
//   * The WMMA body runs WMMA 16x16x16 tiles (f32 accumulation: the Pallas
//     kernel's dot_general with preferred_element_type=f32) with the running
//     accumulators in shared memory, a key tile of up to four arena blocks
//     (64 keys); quantized arenas take it too, 8 storage bytes dequantized
//     per load.  The scalar body computes the same function on FMAs over
//     tiles of bs keys.
//
// Numerics copied from the Pallas kernel: mask value -0.7*FLT_MAX, scores /
// sqrt(hs), arena and fresh K/V cast to the query dtype, p cast to the query
// dtype before P.V, f32 m, l and accumulators, the fresh term folded last.
// Arena offsets are 64-bit.

#include <mma.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using tt::fp8_e4m3;
using tt::from_f;
using tt::kMaskValue;
using tt::load8;
using tt::load_kv;
using tt::load_raw8;
using tt::quantized;
using tt::Raw8;
using tt::round_to;
using tt::store_q8;
using tt::to_f;
using tt::unpack8;

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

// The chunk write of one or two arenas (K and V) in one pass, bits moved as
// they are (an unquantized arena holds the compute dtype itself).  Arena z
// is (num_blocks, rows, bs, hs); the bs * hs elements of arena row r of
// chunk block c are one contiguous run in the values too, read in place at
// vals + c * sc + r * sr (the engine's (1, L, ng, T, hs): sc = bs * hs, sr =
// T * hs; the single-arena entry's (nc, L, ng, bs, hs): rows * bs * hs and
// bs * hs), and land as one run at block dest[pos / bs + c], or in sink
// block 0 when that entry lies past the table.  Several chunk blocks may
// land in the sink at once; its bytes are never read.
struct ChunkArgs {
  void* arena[2];
  const void* vals[2];
  const int* dest;
  const int* pos;
  int rows, bs, nbb;
  int run;                         // vectors V per run (bs * hs elements)
  int64_t sc[2], sr[2];            // each arena's vals strides in vectors V
};

constexpr int kChunkRows = 4;      // arena rows (runs) per block

// grid (ceil(rows / kChunkRows), nc, arenas).  Thread j of a block moves
// vector j (and j + blockDim.x, ...) of each of the block's kChunkRows runs:
// every load issued before the first store, no index per element.
template <typename V>
__global__ void __launch_bounds__(256) paged_chunk_write_kernel(const ChunkArgs a) {
  const int z = blockIdx.z, c = blockIdx.y;
  const int r0 = blockIdx.x * kChunkRows;
  const int n = min(kChunkRows, a.rows - r0);
  const int64_t sr = z ? a.sr[1] : a.sr[0];
  const V* src = static_cast<const V*>(z ? a.vals[1] : a.vals[0]) +
                 c * (z ? a.sc[1] : a.sc[0]) + r0 * sr;
  const int idx = a.pos[0] / a.bs + c;
  const int64_t blk = idx < a.nbb ? a.dest[idx] : 0;
  V* dst = static_cast<V*>(z ? a.arena[1] : a.arena[0]) + (blk * a.rows + r0) * a.run;
  for (int j = threadIdx.x; j < a.run; j += blockDim.x) {
    V v[kChunkRows];
#pragma unroll
    for (int k = 0; k < kChunkRows; ++k)
      if (k < n) v[k] = src[k * sr + j];
#pragma unroll
    for (int k = 0; k < kChunkRows; ++k)
      if (k < n) dst[static_cast<int64_t>(k) * a.run + j] = v[k];
  }
}

// The fused chunk write of one or two arenas (K and V) in one pass.  Arena
// z is (num_blocks, rows, bs, hs) quantized storage TS with its scale arena
// (num_blocks, rows, bs); its fresh values at the compute type TV are read
// in place: slot t of arena row r of chunk block c at vals + c * stride_c +
// r * stride_r + t * hs (the engine's (1, L, ng, T, hs): stride_c = bs * hs,
// stride_r = T * hs; the single-arena entry's (nc, L, ng, bs, hs): rows * bs
// * hs and bs * hs).  Chunk block c lands at block dest[pos / bs + c], or in
// sink block 0 when that entry lies past the table.
struct ChunkQArgs {
  void* arena[2];
  float* scale[2];
  const void* vals[2];
  const int* dest;
  const int* pos;
  float* partial;                  // (arenas, nc, tiles, 2)
  int nc, rows, bs, hs, nbb;
  int lanes_log2;                  // log2 of the lanes per slot-head, G <= 32
  int pieces;                      // 8-value pieces per lane: ceil(hs / (8 G))
  int spb;                         // slot-heads per block
  int64_t stride_c, stride_r;      // vals strides in elements
  float inv_qmax;
};

// grid (tiles, nc, arenas), block 256.  A slot-head (a slot of one arena
// row: hs values, one scale) belongs to a group of G lanes, each holding 8
// of its values (pieces of 8 further apart when hs > 8 G) in registers: the
// absmax is an xor-shuffle max within the group (order-free, so the scale
// is bit-exact), the quantize runs from the same registers, so each value
// is loaded once.  Block x of chunk block c owns slot-heads [x * spb, (x +
// 1) * spb) of the chunk block (slot-head s = r * bs + t, which is also its
// place in the destination block), and leaves its sums of |dq - x| and |x|
// in partial[z, c, x] (lanes by xor shuffles, then warps in order).
template <typename TS, typename TV, bool VEC>
__global__ void __launch_bounds__(256) paged_chunk_write_fused_kernel(const ChunkQArgs a) {
  const int z = blockIdx.z, c = blockIdx.y;
  const int G = 1 << a.lanes_log2;
  const int lane = threadIdx.x & (G - 1);
  const int groups = blockDim.x >> a.lanes_log2;
  const unsigned gmask = G == 32 ? 0xffffffffu
                                 : ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  const int idx = a.pos[0] / a.bs + c;
  const int64_t blk = idx < a.nbb ? a.dest[idx] : 0;
  const int n = a.rows * a.bs;
  const TV* src = static_cast<const TV*>(z ? a.vals[1] : a.vals[0]) + c * a.stride_c;
  TS* dst = static_cast<TS*>(z ? a.arena[1] : a.arena[0]) + blk * n * a.hs;
  float* sdst = (z ? a.scale[1] : a.scale[0]) + blk * n;
  const int s0 = static_cast<int>(blockIdx.x) * a.spb;
  const int s_end = min(n, s0 + a.spb);
  const int first = s0 + static_cast<int>(threadIdx.x >> a.lanes_log2);
  // the lambdas below read locals, never the parameter block itself
  const int hs = a.hs, bs = a.bs, pieces = a.pieces;
  const int64_t stride_r = a.stride_r;
  const float inv_qmax = a.inv_qmax;
  float e_err = 0.f, e_abs = 0.f;
  // quantizes one slot-head from the 8 values of piece 0 in v (the further
  // pieces, hs > 8 G, load again) and stores its bytes and scale
  auto slot_head = [&](int s, const TV* x, const float (&v)[8]) {
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    for (int k = 1; k < pieces; ++k) {
      float w[8];
      load8<TV, VEC>(x, (k * G + lane) * 8, hs, w);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(w[e]));
    }
    for (int o = G >> 1; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(gmask, amax, o));
    const float scale = tt::absmax_scale(amax, inv_qmax);
    TS* d = dst + static_cast<int64_t>(s) * hs;
    store_q8<TS, VEC>(d, lane * 8, hs, v, scale, e_err, e_abs);
    for (int k = 1; k < pieces; ++k) {
      float w[8];
      load8<TV, VEC>(x, (k * G + lane) * 8, hs, w);
      store_q8<TS, VEC>(d, (k * G + lane) * 8, hs, w, scale, e_err, e_abs);
    }
    if (lane == 0) sdst[s] = scale;
  };
  auto head = [&](int s) {         // slot t of arena row r: slot-head s = r * bs + t
    const int r = s / bs;
    return src + r * stride_r + static_cast<int64_t>(s - r * bs) * hs;
  };
  if (VEC && pieces == 1) {
    // one piece a lane: the next slot-head's 16 bytes load while this one
    // quantizes (lanes past hs, when hs < 8 G, hold zeros and store nothing)
    const bool on = lane * 8 < hs;
    Raw8<TV> cur{};
    if (first < s_end && on) cur = load_raw8<TV>(head(first) + lane * 8);
    for (int s = first; s < s_end; s += groups) {
      Raw8<TV> nxt{};
      if (s + groups < s_end && on) nxt = load_raw8<TV>(head(s + groups) + lane * 8);
      float v[8];
      unpack8<TV>(cur, v);
      slot_head(s, nullptr, v);
      cur = nxt;
    }
  } else {
    for (int s = first; s < s_end; s += groups) {
      const TV* x = head(s);
      float v[8];
      load8<TV, VEC>(x, lane * 8, hs, v);
      slot_head(s, x, v);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    e_err += __shfl_xor_sync(0xffffffffu, e_err, o);
    e_abs += __shfl_xor_sync(0xffffffffu, e_abs, o);
  }
  __shared__ float red[2][8];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = e_err;
    red[1][warp] = e_abs;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float se = 0.f, sa = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      se += red[0][w];
      sa += red[1][w];
    }
    float* out = a.partial + ((static_cast<int64_t>(z) * a.nc + c) * gridDim.x + blockIdx.x) * 2;
    out[0] = se;
    out[1] = sa;
  }
}

// grid (nc, arenas), block 256: err[z, c, 0..1] = the sums of partial[z, c,
// :, 0..1] over the tiles (each thread a strided run, then a tree: a fixed
// order, so two calls agree bit for bit), kept only when chunk block c was
// written to a real block (dest entry within the table and not the sink),
// as the Pallas kernel masks them.
__global__ void __launch_bounds__(256) chunk_err_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ err, const int* __restrict__ dest,
    const int* __restrict__ pos, int tiles, int bs, int nbb) {
  const int c = blockIdx.x, tid = threadIdx.x;
  const int64_t zc = static_cast<int64_t>(blockIdx.y) * gridDim.x + c;
  __shared__ float s[2][256];
  float a = 0.f, b = 0.f;
  for (int x = tid; x < tiles; x += 256) {
    a += partial[(zc * tiles + x) * 2];
    b += partial[(zc * tiles + x) * 2 + 1];
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
    err[zc * 2] = live ? s[0][0] : 0.f;
    err[zc * 2 + 1] = live ? s[1][0] : 0.f;
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

//
// The warpgroup body (bf16/f16 at hs 64 or 128, many query rows): wgmma
// products with register accumulators, K/V tiles through a cp.async ring.
//

namespace wgv {

namespace wg = tt::wg;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // query rows per block
constexpr int kTile = 64;      // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

template <int HS> __host__ __device__ constexpr uint32_t tile_bytes() { return kTile * HS * 2; }
// Q and a two-stage K/V ring, 1024 bytes of alignment slack included; a
// quantized arena adds its raw slots: 64 keys of HS stored bytes and 64
// scales per slot of a key chunk, for K and V.
template <int HS, bool kQuant> __host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + 5 * tile_bytes<HS>() + (kQuant ? 2 * kTile * HS + 2 * kTile * (HS / 16) * 4 : 0);
}

__device__ __forceinline__ void st_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr), "r"(0) : "memory");
}
__device__ __forceinline__ void st_zero4(uint32_t addr) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// grid (ng, B, ceil(rows / 64)), block 128: one warpgroup owns 64 query rows
// (r = rep_idx * T + t) of one (request, group) and walks 64-key tiles:
// first the live arena blocks [0, ceil(pos / bs)) of the table, 64 / bs
// blocks per tile (keep slot < pos, per element only in the last tile),
// then the fresh keys up to the largest t of its rows (keep col <= t; the
// tiles wholly above the diagonal are not walked).  The heaviest tiles (the
// last t of every head) are scheduled first.  Tile it + 1 is loaded into
// the other stage while tile it's S product runs: by cp.async, or, from a
// quantized arena, dequantized from raw slots that cp.async filled a tile
// earlier (16 values per 16-byte copy).  TS: the arena's storage, T or
// quantized.
template <typename T, typename TS, int HS>
__global__ void __launch_bounds__(kThreads) paged_attn_verify_wg_kernel(
    const T* __restrict__ q, const TS* __restrict__ k_arena, const TS* __restrict__ v_arena,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const T* __restrict__ fresh_k, const T* __restrict__ fresh_v, const int* __restrict__ tables,
    const int* __restrict__ pos, T* __restrict__ out, int ng, int rows, int T_, int bs, int nbb,
    int L, int layer, float sm) {
  constexpr bool kQuant = quantized<TS>::value;
  constexpr uint32_t kT = tile_bytes<HS>();
  constexpr int kChunks = HS / 8;                // 16-byte chunks of a T row
  constexpr int kPer = kTile * kChunks / kThreads;  // T chunks per thread per tile
  constexpr int kRaw = HS / 16;                  // 16-byte chunks of a stored row (quantized)
  constexpr int kRawPer = kTile * kRaw / kThreads;  // stored chunks per thread per tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s0 = wg::smem_u32(smem);
  const uint32_t sq = (s0 + 1023) & ~1023u;
  const uint32_t skv = sq + kT;     // stage st: K at skv + 2 st kT, V kT after it
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;

  const int grp = blockIdx.x, b = blockIdx.y;
  int x;                            // this block's row tile, heaviest first
  if (T_ % kRows == 0) {
    const int per = T_ / kRows, rep = rows / T_, i = blockIdx.z;
    x = (i % rep) * per + per - 1 - i / rep;
  } else {
    x = gridDim.z - 1 - blockIdx.z;
  }
  const int r0 = x * kRows, nr = min(kRows, rows - r0);
  const int p = pos[b];
  const int64_t pair = static_cast<int64_t>(b) * ng + grp;
  // the largest t of the rows: a tile may straddle two heads
  const int t_max = r0 / T_ == (r0 + nr - 1) / T_ ? (r0 + nr - 1) % T_ : T_ - 1;
  const int n_fresh = t_max / kTile + 1;
  const int nbt = kTile / bs;       // arena blocks per key tile
  const int n_blocks = min((p + bs - 1) / bs, nbb);
  const int n_arena = (n_blocks + nbt - 1) / nbt;
  const int p_arena = min(p, nbb * bs);  // the slots the table holds
  const int n_it = n_arena + n_fresh;
  const int r_lo = 16 * w + (l >> 2);  // the lane's rows r_lo, r_lo + 8
  const int t0 = (r0 + r_lo) % T_, t1 = (r0 + r_lo + 8) % T_;
  const float inv_sm = __frcp_rn(sm);

  const int64_t tsz = static_cast<int64_t>(bs) * HS;
  const int64_t layer_stride = ng * tsz, block_stride = L * layer_stride;
  const int64_t head_off = layer * layer_stride + grp * tsz;
  const int* trow = tables + static_cast<int64_t>(b) * nbb;
  const T* fk = fresh_k + pair * T_ * HS;
  const T* fv = fresh_v + pair * T_ * HS;
  // element offset of key r's slot in arena tile it, or -1 past the live
  // blocks (its table entry is read before any copy is issued)
  auto slot_at = [&](int it, int r) -> int64_t {
    const int j = it * nbt + r / bs;
    return j < n_blocks ? trow[j] * block_stride + head_off + (r % bs) * HS : -1;
  };

  // tile it into stage st by cp.async: arena keys (unquantized) or fresh ones
  auto copy_tile = [&](int it, int st) {
    const uint32_t sk = skv + st * 2 * kT;
    int64_t at[kPer];
    if (it < n_arena) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) at[k] = slot_at(it, (tid + k * kThreads) / kChunks);
    } else {
      const int c0 = (it - n_arena) * kTile;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int c = c0 + (tid + k * kThreads) / kChunks;
        at[k] = c < T_ ? static_cast<int64_t>(c) * HS : -1;  // the last fresh tile may be partial
      }
    }
    const T* kg = it < n_arena ? reinterpret_cast<const T*>(k_arena) : fk;
    const T* vg = it < n_arena ? reinterpret_cast<const T*>(v_arena) : fv;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads, r = i / kChunks, ch = i % kChunks;
      const uint32_t dk = sk + wg::swizzled(kTile, r, ch), dv = dk + kT;
      if (at[k] >= 0) {
        wg::cp_async16(dk, kg + at[k] + 8 * ch);
        wg::cp_async16(dv, vg + at[k] + 8 * ch);
      } else {
        st_zero16(dk);
        st_zero16(dv);
      }
    }
  };

  // A quantized arena tile's stored bytes and scales come by cp.async into
  // raw slots that each thread owns (16 stored bytes and one scale per
  // slot, K then V), a tile ahead; the same thread dequantizes them
  // (f32(x) * scale rounded to T) into the stage, so no barrier guards them.
  const uint32_t sraw = skv + 4 * kT;
  auto raw_slot = [&](int kv, int k) { return sraw + ((kv * kRawPer + k) * kThreads + tid) * 16; };
  auto scale_slot = [&](int kv, int k) {
    return sraw + 2 * kRawPer * kThreads * 16 + ((kv * kRawPer + k) * kThreads + tid) * 4;
  };
  auto load_raw = [&](int it) {
    int64_t at[kRawPer];
#pragma unroll
    for (int k = 0; k < kRawPer; ++k) at[k] = slot_at(it, (tid + k * kThreads) / kRaw);
#pragma unroll
    for (int k = 0; k < kRawPer; ++k) {
      const int ch = (tid + k * kThreads) % kRaw;
      if (at[k] >= 0) {
        wg::cp_async16(raw_slot(0, k), k_arena + at[k] + 16 * ch);
        wg::cp_async16(raw_slot(1, k), v_arena + at[k] + 16 * ch);
        cp_async4(scale_slot(0, k), k_scale + at[k] / HS);
        cp_async4(scale_slot(1, k), v_scale + at[k] / HS);
      } else {  // past the live blocks: zero bytes, zero scale
        st_zero16(raw_slot(0, k));
        st_zero16(raw_slot(1, k));
        st_zero4(scale_slot(0, k));
        st_zero4(scale_slot(1, k));
      }
    }
  };
  auto store_raw = [&](int st) {
#pragma unroll
    for (int k = 0; k < kRawPer; ++k) {
      const int i = tid + k * kThreads, r = i / kRaw, ch = i % kRaw;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const uint4 bytes = *reinterpret_cast<const uint4*>(smem + (raw_slot(kv, k) - s0));
        const float scale = *reinterpret_cast<const float*>(smem + (scale_slot(kv, k) - s0));
        const uint32_t words[4] = {bytes.x, bytes.y, bytes.z, bytes.w};
        uint32_t packed[8];  // 16 values, two per word, rounded to T
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v[4];
          tt::dequant4<TS>(words[e], scale, v);
          packed[2 * e] = wg::pack2<T>(v[0], v[1]);
          packed[2 * e + 1] = wg::pack2<T>(v[2], v[3]);
        }
        const uint4 lo = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        const uint4 hi = make_uint4(packed[4], packed[5], packed[6], packed[7]);
        const uint32_t tile = skv + st * 2 * kT + kv * kT;
        *reinterpret_cast<uint4*>(smem + (tile + wg::swizzled(kTile, r, 2 * ch) - s0)) = lo;
        *reinterpret_cast<uint4*>(smem + (tile + wg::swizzled(kTile, r, 2 * ch + 1) - s0)) = hi;
      }
    }
  };
  // tile it into stage st, whichever way it arrives
  auto produce = [&](int it, int st) {
    if constexpr (kQuant) {
      if (it < n_arena) {
        store_raw(st);                           // loaded a tile earlier
        if (it + 1 < n_arena) load_raw(it + 1);
        return;
      }
    }
    copy_tile(it, st);
  };

  // the query rows (rows past the end repeat the last one; never written)
  const T* qg = q + (pair * rows + r0) * HS;
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i - r * kChunks;
    wg::cp_async16(sq + wg::swizzled(kRows, r, ch),
                   qg + static_cast<int64_t>(min(r, nr - 1)) * HS + 8 * ch);
  }
  if constexpr (kQuant) {
    if (n_arena > 0) {  // the first tile's raw slots, before its dequantization
      load_raw(0);
      wg::cp_async_commit();
      wg::cp_async_wait<0>();
    }
  }
  produce(0, 0);
  wg::cp_async_commit();

  float o[HS / 2], s[32];
#pragma unroll
  for (int i = 0; i < HS / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m0 = kMaskValue, m1 = kMaskValue, l0 = 0.f, l1 = 0.f;  // rows r_lo, r_lo + 8
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const uint32_t sk = skv + st * 2 * kT, sv = sk + kT;
    wg::cp_async_wait<0>();
    wg::fence_async_smem();
    __syncthreads();
    wg::fence();
    wg::mma_ss<HS, T>(s, sq, kRows, 0, sk);
    wg::commit();
    if (it + 1 < n_it) produce(it + 1, st ^ 1);  // while the product runs
    wg::cp_async_commit();
    wg::wait<0>();
    wg::pin(s);
    const bool arena = it < n_arena;
    const int c0 = arena ? it * kTile : (it - n_arena) * kTile;
    const bool edge = !arena || c0 + kTile > p_arena;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = tt::div_rn(s[i], sm, inv_sm);  // s / sqrt(hs), correctly rounded
      if (edge) {
        const int col = c0 + 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
        const bool keep = arena ? col < p_arena : col < T_ && col <= ((i & 2) ? t1 : t0);
        if (!keep) x = kMaskValue;
      }
      s[i] = x;
      if (i & 2) {
        mx1 = fmaxf(mx1, x);
      } else {
        mx0 = fmaxf(mx0, x);
      }
    }
    mx0 = wg::quad_max(mx0);
    mx1 = wg::quad_max(mx1);
    const float c_0 = exp2f((m0 - mx0) * kLog2e), c_1 = exp2f((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pv = exp2f((s[i] - ((i & 2) ? mx1 : mx0)) * kLog2e);
      s[i] = pv;
      if (i & 2) {
        sum1 += pv;
      } else {
        sum0 += pv;
      }
    }
    l0 = l0 * c_0 + sum0;  // this lane's share of the row sum
    l1 = l1 * c_1 + sum1;
#pragma unroll
    for (int i = 0; i < HS / 2; ++i) o[i] *= (i & 2) ? c_1 : c_0;
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pack_a<T>(s, kk, a[kk]);  // p in the query type
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::mma_rs<HS, T>(o, a[kk], wg::desc_mn(sv, kTile, kk));
    wg::commit();
    wg::wait<0>();
    wg::pin(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pin(a[kk]);
    __syncthreads();  // this stage is free for the load two tiles on
  }
  wg::cp_async_wait<0>();
  l0 = wg::quad_sum(l0);
  l1 = wg::quad_sum(l1);
  T* o0 = out + (pair * rows + r0 + r_lo) * HS;
  T* o1 = o0 + 8 * HS;
#pragma unroll
  for (int jj = 0; jj < HS / 8; ++jj) {
    const int c = 8 * jj + 2 * (l & 3);
    if (r_lo < nr)
      *reinterpret_cast<uint32_t*>(o0 + c) = wg::pack2<T>(o[4 * jj] / l0, o[4 * jj + 1] / l0);
    if (r_lo + 8 < nr)
      *reinterpret_cast<uint32_t*>(o1 + c) =
          wg::pack2<T>(o[4 * jj + 2] / l1, o[4 * jj + 3] / l1);
  }
}

}  // namespace wgv

template <typename T, typename TS, int HS>
cudaError_t launch_verify_wg(const void* q, const void* ka, const void* va, const float* ks,
                             const float* vs, const void* fk, const void* fv, const int* tables,
                             const int* pos, void* out, int B, int ng, int rows, int T_, int bs,
                             int nbb, int L, int layer, float sm, cudaStream_t stream) {
  constexpr size_t smem = wgv::smem_bytes<HS, quantized<TS>::value>();
  auto kern = wgv::paged_attn_verify_wg_kernel<T, TS, HS>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(ng, B, (rows + wgv::kRows - 1) / wgv::kRows), wgv::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TS*>(ka), static_cast<const TS*>(va), ks, vs,
      static_cast<const T*>(fk), static_cast<const T*>(fv), tables, pos, static_cast<T*>(out),
      ng, rows, T_, bs, nbb, L, layer, sm);
  return cudaGetLastError();
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

template <typename TS, typename TV, bool VEC>
cudaError_t launch_chunk_fused(const ChunkQArgs& a, int tiles, int arenas, float* err,
                               cudaStream_t s) {
  paged_chunk_write_fused_kernel<TS, TV, VEC><<<dim3(tiles, a.nc, arenas), 256, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk_err_reduce_kernel<<<dim3(a.nc, arenas), 256, 0, s>>>(a.partial, err, a.dest, a.pos,
                                                             tiles, a.bs, a.nbb);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_chunk(const ChunkArgs& a, int nc, int arenas, cudaStream_t s) {
  const int threads = a.run >= 256 ? 256 : (a.run + 31) / 32 * 32;
  paged_chunk_write_kernel<V><<<dim3((a.rows + kChunkRows - 1) / kChunkRows, nc, arenas),
                                threads, 0, s>>>(a);
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
// K/V's dtype.  rows = rep * T.  body (cudaex.paged_body): 0 the scalar
// body, R query rows per block (the wrapper picks R so the shared memory
// fits); 1 the WMMA body (16, 32 or 64 rows per block, its own pick); 2 the
// warpgroup body (64 rows per warpgroup).  A body that does not take the
// types or shapes returns cudaErrorInvalidValue; none gives way to another.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tt_paged_attn_verify(const void* q, const void* k_arena, const void* v_arena,
                                    const float* k_scale, const float* v_scale,
                                    const void* fresh_k, const void* fresh_v,
                                    const int* tables, const int* pos, void* out, int B,
                                    int ng, int rows, int T, int hs, int bs, int nbb, int L,
                                    int layer, int R, float sm, int q_dtype, int kv_dtype,
                                    int c_dtype, int body, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1 || body == 2) {
    if (!verify_mma_ok(q_dtype, kv_dtype, c_dtype, hs, bs)) return cudaErrorInvalidValue;
    if (body == 2 && !((hs == 64 || hs == 128) && 64 % bs == 0)) return cudaErrorInvalidValue;
    return tt::by_float(q_dtype, [&](auto tq) {
      return tt::by_storage(kv_dtype, [&](auto ts) -> cudaError_t {
        using TQ = decltype(tq);
        using TS = decltype(ts);
        if constexpr (std::is_same<TQ, float>::value || !tt::kv_pair_ok<TS, TQ>()) {
          return cudaErrorInvalidValue;
        } else if (body == 1) {
          return launch_verify_mma<TQ, TS>(q, k_arena, v_arena, k_scale, v_scale, fresh_k,
                                           fresh_v, tables, pos, out, B, ng, rows, T, hs, bs,
                                           nbb, L, layer, sm, s);
        } else if (hs == 128) {
          return launch_verify_wg<TQ, TS, 128>(q, k_arena, v_arena, k_scale, v_scale, fresh_k,
                                               fresh_v, tables, pos, out, B, ng, rows, T, bs,
                                               nbb, L, layer, sm, s);
        } else {
          return launch_verify_wg<TQ, TS, 64>(q, k_arena, v_arena, k_scale, v_scale, fresh_k,
                                              fresh_v, tables, pos, out, B, ng, rows, T, bs,
                                              nbb, L, layer, sm, s);
        }
      });
    });
  }
  if (body != 0) return cudaErrorInvalidValue;
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

// The chunk write into one or two quantized arenas (arena1, scale1, vals1
// null: one; kv_dtype 3 = int8, 4 = fp8 e4m3), quantizing the values at
// v_dtype (0/1/2) on the way.  geom: nc, rows, bs, hs, nbb, stride_c,
// stride_r (the vals strides of a chunk block and an arena row, elements),
// lanes_log2, pieces, spb, tiles (the wrapper's plan, cudaex._chunk_q_plan).
// err: (arenas, nc, 2) float32, the masked sum|dq - x| and sum|x| of each
// chunk block; partial: (arenas, nc, tiles, 2) float32 scratch.  vec: 16-byte
// loads and 8-byte stores (hs % 8 == 0 and the bases aligned; the kernel
// checks) or element by element.  inv_qmax is f32(1/qmax).  Two launches:
// the write of both arenas, then the fixed-order sum of the error partials.
extern "C" int tt_paged_chunk_write_fused(void* arena0, float* scale0, const void* vals0,
                                          void* arena1, float* scale1, const void* vals1,
                                          const int* dest, const int* pos, float* err,
                                          float* partial, const int64_t* geom, float inv_qmax,
                                          int kv_dtype, int v_dtype, int vec, void* stream) {
  const int arenas = arena1 == nullptr ? 1 : 2;
  const ChunkQArgs a{{arena0, arenas == 2 ? arena1 : arena0},
                     {scale0, arenas == 2 ? scale1 : scale0},
                     {vals0, arenas == 2 ? vals1 : vals0},
                     dest, pos, partial,
                     static_cast<int>(geom[0]), static_cast<int>(geom[1]),
                     static_cast<int>(geom[2]), static_cast<int>(geom[3]),
                     static_cast<int>(geom[4]), static_cast<int>(geom[7]),
                     static_cast<int>(geom[8]), static_cast<int>(geom[9]),
                     geom[5], geom[6], inv_qmax};
  const int tiles = static_cast<int>(geom[10]);
  if (a.nc == 0 || a.rows * a.bs == 0) return cudaSuccess;
  if (a.lanes_log2 < 0 || a.lanes_log2 > 5 || a.pieces < 1 || a.spb < 1 ||
      static_cast<int64_t>(tiles) * a.spb < static_cast<int64_t>(a.rows) * a.bs)
    return cudaErrorInvalidValue;
  if (vec) {
    const uintptr_t in = reinterpret_cast<uintptr_t>(a.vals[0]) |
                         reinterpret_cast<uintptr_t>(a.vals[1]);
    const uintptr_t out = reinterpret_cast<uintptr_t>(a.arena[0]) |
                          reinterpret_cast<uintptr_t>(a.arena[1]);
    if (a.hs % 8 || a.stride_c % 8 || a.stride_r % 8 || in % 16 || out % 8)
      return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tt::by_float(v_dtype, [&](auto tv) {
    return tt::by_storage(kv_dtype, [&](auto ts) -> cudaError_t {
      using TV = decltype(tv);
      using TS = decltype(ts);
      if constexpr (!quantized<TS>::value) {
        return cudaErrorInvalidValue;
      } else if (vec) {
        return launch_chunk_fused<TS, TV, true>(a, tiles, arenas, err, s);
      } else {
        return launch_chunk_fused<TS, TV, false>(a, tiles, arenas, err, s);
      }
    });
  });
}

// The chunk write of one or two arenas (arena1/vals1 null: one).  geom: nc,
// rows, bs, nbb, the bytes of a run (bs * hs elements), then vals0's
// strides sc, sr and vals1's, in bytes; vec_bytes (16, 8, 4, 2 or 1)
// divides the run, the strides and every base address (the wrapper picks
// the widest); the copy moves bits, whatever the dtype.  One launch.
extern "C" int tt_paged_chunk_write(void* arena0, void* arena1, const void* vals0,
                                    const void* vals1, const int* dest, const int* pos,
                                    const int64_t* geom, int vec_bytes, void* stream) {
  const int nc = static_cast<int>(geom[0]), arenas = arena1 == nullptr ? 1 : 2;
  if (nc == 0 || geom[1] == 0) return cudaSuccess;
  const int64_t w = vec_bytes;
  if (w != 16 && w != 8 && w != 4 && w != 2 && w != 1) return cudaErrorInvalidValue;
  for (int k = 4; k < 9; ++k)
    if (geom[k] % w) return cudaErrorInvalidValue;
  const uintptr_t at =
      reinterpret_cast<uintptr_t>(arena0) | reinterpret_cast<uintptr_t>(arena1) |
      reinterpret_cast<uintptr_t>(vals0) | reinterpret_cast<uintptr_t>(vals1);
  if (at % w) return cudaErrorInvalidValue;
  const ChunkArgs a{{arena0, arenas == 2 ? arena1 : arena0},
                    {vals0, arenas == 2 ? vals1 : vals0},
                    dest, pos,
                    static_cast<int>(geom[1]), static_cast<int>(geom[2]),
                    static_cast<int>(geom[3]), static_cast<int>(geom[4] / w),
                    {geom[5] / w, geom[7] / w},
                    {geom[6] / w, geom[8] / w}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch_chunk<uint4>(a, nc, arenas, s);
    case 8: return launch_chunk<uint2>(a, nc, arenas, s);
    case 4: return launch_chunk<uint32_t>(a, nc, arenas, s);
    case 2: return launch_chunk<uint16_t>(a, nc, arenas, s);
    default: return launch_chunk<uint8_t>(a, nc, arenas, s);
  }
}
