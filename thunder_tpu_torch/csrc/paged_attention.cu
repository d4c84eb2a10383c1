// Paged attention at few query rows (the split-K body) and the single-token
// writes for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces these Pallas TPU kernels of thunder_tpu/executors/pallasex.py:
//
//   paged_attn_decode (pallasex.py:1165, pallas_call :1228, body
//     _paged_kernel :1076, walk _ragged_step :1148): single-token attention
//     read straight off the rank-5 KV block arena (num_blocks, L, ng, bs, hs).
//   paged_attn_verify (pallasex.py:1376, pallas_call :1441) at few query
//     rows: the speculative verify (T = K+1) and small chunk pieces, with
//     rep * T <= 64 (cudaex.paged_body; paged_verify.cu holds the bodies of
//     many rows).
//   paged_token_write (pallasex.py:1249, body _paged_write_kernel :1241):
//     in-place write of each request's fresh K/V (or scale) into its slot.
//   paged_token_write_masked (pallasex.py:1462): the same write of chunk
//     offset k at pos + k iff k < n_emit[b], else into sink block 0, slot 0
//     (the speculative commit).  One kernel serves both writes, and the pair
//     write of a whole step, round or multi-step iteration: both arenas
//     (K and V) and every offset of the round in one launch.
//   paged_token_write_fused (pallasex.py:1672, body :1661, the quantize
//     _absmax_quant :1579): the token write (plain or masked) into an int8
//     or fp8-e4m3 arena, quantizing on the way: per (row, layer, group) the
//     f32 absmax over hs, scale = amax == 0 ? 1 : amax * f32(1/qmax), the
//     values x / scale rounded into storage, value and scale stored.  Its
//     kernel also takes both arenas (K and V, with their scale arenas) and
//     every offset of a round in one launch, as the token write does.
//
// What bounds them on an H100: bytes.  Decode reads each live K/V byte once
// and does ~2 flops per byte per query row (Llama-3-8B, B=8, 32 heads over 8
// groups, pos ~1000: ~33 MB per layer, ~10 us at 3.35 TB/s; half of it,
// plus 3% of scales, from a 1-byte arena); the speculative verify (T=5)
// reads the same bytes for 5x the rows, still far below the card's
// 295 flops per byte.  A token write moves ~0.5 MB per arena and offset
// (Llama-3-8B, B=8, bf16: a 0.31 us bound), below any kernel's time from
// launch to finish, so what it can save is launches: the pair write moves
// K and V of every offset of a round in one launch (1 MiB per decode step,
// 5 MiB per K=4 round), each slot-head row as the widest vector that
// divides it (16 lanes of 16 bytes at hs 128 in bf16), one load and one
// store per thread, no index per element, no staging copy of a strided
// offset.  The fused write (~0.8 MB per arena and offset) is launch-bound
// the same way (a 0.24 us bound per arena and offset) and takes the same
// cure: K and V of a whole step or round in one launch, the values read in
// place by their strides (no per-offset staging copy), a group of hs / 8
// lanes per slot-head with 8 values per lane from one 16-byte load, the
// absmax a shuffle max within the group (order-free, so the scale is
// bit-exact), the quotient an IEEE division (never a reciprocal multiply),
// so the stored bytes equal serving.quant.quantize_kv's, 8 bytes stored per
// lane.
//
// The split-K body (flash-decoding):
//   * Grid (splits, ng * row tiles, B).  A block owns one (request, group),
//     up to 64 of its rep * T query rows (row r = rep_idx * T + t, the
//     layout of q viewed (B, ng, rep * T, hs)), and split s of the
//     request's live arena blocks [lo, hi): lo from the sliding window, hi
//     = ceil(pos / bs) clipped to the table, cut into `splits` contiguous
//     shares of ceil((hi - lo) / splits) blocks.  The split count is the
//     wrapper's, from shapes alone (cudaex.paged_splits): never from pos or
//     the tables, so a call reads no device value on the host.  A split with
//     no live block writes an empty partial (m = mask value, l = 0, acc = 0).
//   * Each split walks its blocks in table order, one online-softmax step
//     per arena block, and leaves its f32 (m, l, acc) in a scratch buffer.
//     A second kernel (paged_attn_decode_combine_kernel, or
//     paged_attn_verify_combine_kernel for a verify call) folds the splits
//     in split order -- bitwise repeatable, no atomics -- then the fresh key
//     or keys last (decode's never-masked one, verify's T under col <= t),
//     and writes acc / l.  A row with pos = 0 gets only empty partials and
//     returns the fresh V (decode) or causal attention over the chunk.
//   * Products, by the wrapper's choice (cudaex._split_products): for
//     bf16/f16 queries with the arena in that type or quantized, bs 16 and
//     hs a multiple of 16 up to 128, mma.sync m16n8k16 tensor-core tiles
//     (query rows padded to 16; the card has flops to spare here) with the
//     128 threads splitting the P.V columns (S = Q.K^T is formed by every
//     warp); K/V arrive as 16-byte cp.async copies into a four-stage ring
//     in shared memory, the next three blocks in flight while one computes;
//     a quantized slot is dequantized in registers as its fragment is read
//     (its scale loaded once per slot into the stage).  Otherwise (float32,
//     other block or head sizes) the same walk on scalar FMAs over tiles in
//     shared memory, any head size that fits.
//
// Numerics follow the Pallas kernels: masked scores take -0.7 * FLT_MAX (not
// -inf), scores are divided by sqrt(hs), arena and fresh K/V are cast to the
// query dtype before use (a quantized element as f32(x) * scale rounded to
// the compute dtype, then to the query dtype), the probabilities are cast
// to the query dtype before each P.V product, m, l and the accumulators
// are f32, and the fresh keys are folded last.

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using tt::fp8_e4m3;
using tt::from_f;
using tt::kMaskValue;
using tt::load_kv;
using tt::mma16816;
using tt::quantized;
using tt::round_to;
using tt::to_f;

namespace wg = tt::wg;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

//
// The split-K body of paged_attn_decode and of paged_attn_verify at few rows
//

constexpr int kSplitThreads = 128;  // four warps
constexpr int kRowTile = 64;        // query rows per block of the mma.sync products
constexpr int kStages = 4;          // ring of arena blocks (mma.sync products)
constexpr int kMmaBS = 16;          // the block size the mma.sync products take
constexpr int kMaxSplits = 64;      // the combine kernel's fold factors in shared memory
constexpr int kMaxFresh = 64;       // fresh keys the combine kernel folds per row

// Everything the split and combine kernels take.  q, out: (B, ng, rows, hs)
// at TQ (rows = rep * T); fresh K/V (B, ng, T, hs) at TC; arenas (num_blocks,
// L, ng, bs, hs) of storage TS with (num_blocks, L, ng, bs) f32 scales when
// quantized; part: the f32 partials, m and l (B, ng, splits, rows, 2) then
// acc (B, ng, splits, rows, hs).
struct SplitArgs {
  const void* q;
  const void* k_arena;
  const void* v_arena;
  const float* k_scale;
  const float* v_scale;
  const void* fresh_k;
  const void* fresh_v;
  const int* tables;
  const int* pos;
  void* out;
  float* part;
  int ng, rows, T, hs, bs, nbb, L, layer, window, splits, row_tile;
  float sm;
};

// Split s's share [jb, je) of the request's live arena blocks: slots
// [0, p) clipped to the window (p - window, p), the table bounding the walk
// (a padding row's position may run past it), cut into `splits` contiguous
// shares of ceil(n / splits) blocks (cudaex._split_range mirrors this).
__device__ __forceinline__ void split_range(const SplitArgs& a, int p, int s, int& jb, int& je) {
  const int hi = min((p + a.bs - 1) / a.bs, a.nbb);
  int lo = 0;
  if (a.window > 0) {
    const int first = p - (a.window - 1);
    lo = (first > 0 ? first : 0) / a.bs;
  }
  const int n = hi > lo ? hi - lo : 0;
  const int per = (n + a.splits - 1) / a.splits;
  jb = min(lo + s * per, lo + n);
  je = min(jb + per, lo + n);
}

__device__ __forceinline__ bool keep_slot(const SplitArgs& a, int slot, int p) {
  return slot < p && (a.window <= 0 || slot > p - a.window);
}

__device__ __forceinline__ float* part_acc(const SplitArgs& a) {
  return a.part + static_cast<int64_t>(gridDim.z) * a.ng * a.splits * a.rows * 2;
}

// Two arena elements as a T pair, *x0 in the low half: the stored bits, or
// quantized elements dequantized with their slots' scales (f32(x) * scale
// rounded to T, the compute and query type alike).
template <typename T, typename TS>
__device__ __forceinline__ uint32_t kv_pair(const TS* x0, const TS* x1, float s0, float s1) {
  if constexpr (quantized<TS>::value) {
    return wg::pack2<T>(__fmul_rn(to_f<TS>(*x0), s0), __fmul_rn(to_f<TS>(*x1), s1));
  } else {
    return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(x0)) |
           (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(x1)) << 16);
  }
}

// Bytes of shared memory of the mma.sync products: the query rows (T, rows
// padded by 8 elements), then kStages stages of K and V (bs rows of hs
// storage elements padded by 16 bytes) and, quantized, their 2 x bs scales.
template <typename TS> __host__ __device__ constexpr int mma_stage_bytes(int hs) {
  return 2 * kMmaBS * (hs * static_cast<int>(sizeof(TS)) + 16) +
         (quantized<TS>::value ? 2 * kMmaBS * 4 : 0);
}
template <typename TS> __host__ __device__ constexpr int mma_split_smem(int MT, int hs) {
  return 16 * MT * (hs + 8) * 2 + kStages * mma_stage_bytes<TS>(hs);
}

// The mma.sync products: T (bf16 or f16) queries, TS = T or quantized,
// MT 16-row tiles (16 MT >= the block's rows).  Warp w forms all of S and
// the P.V columns of its 8-column groups w, w + 4, w + 8, w + 12; every
// warp holds the same m and l.
template <typename T, typename TS, int MT>
__device__ __forceinline__ void split_mma(const SplitArgs& a, unsigned char* smem) {
  constexpr bool kQuant = quantized<TS>::value;
  constexpr int kPad = 16 / static_cast<int>(sizeof(TS));
  const int hs = a.hs, R = a.rows, n_rt = (R + kRowTile - 1) / kRowTile;
  const int s = blockIdx.x, grp = blockIdx.y / n_rt, b = blockIdx.z;
  const int r0 = (blockIdx.y % n_rt) * kRowTile, nr = min(kRowTile, R - r0);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int ldq = hs + 8, ldk = hs + kPad, n_cols = hs / 8;
  const int64_t pair = static_cast<int64_t>(b) * a.ng + grp;
  T* qs = reinterpret_cast<T*>(smem);
  unsigned char* stages = smem + 16 * MT * ldq * 2;
  const int stage_bytes = mma_stage_bytes<TS>(hs);
  const int p = a.pos[b];
  const float inv_sm = __frcp_rn(a.sm);
  int jb, je;
  split_range(a, p, s, jb, je);

  // the block's query rows (zero rows past the end)
  const T* qg = static_cast<const T*>(a.q) + (pair * R + r0) * hs;
  for (int i = tid; i < 16 * MT * n_cols; i += kSplitThreads) {
    const int r = i / n_cols, c = i - r * n_cols;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < nr) v = *reinterpret_cast<const uint4*>(qg + static_cast<int64_t>(r) * hs + 8 * c);
    *reinterpret_cast<uint4*>(qs + r * ldq + 8 * c) = v;
  }

  const int64_t tsz = static_cast<int64_t>(kMmaBS) * hs;
  const int64_t layer_stride = a.ng * tsz, block_stride = a.L * layer_stride;
  const int64_t head_off = a.layer * layer_stride + grp * tsz;
  const TS* ka = static_cast<const TS*>(a.k_arena);
  const TS* va = static_cast<const TS*>(a.v_arena);
  const int cpr = hs * static_cast<int>(sizeof(TS)) / 16;  // 16-byte chunks per slot
  // arena block j (table column) into stage st: K, V, then the scales
  auto load = [&](int j, int st) {
    unsigned char* dst = stages + st * stage_bytes;
    const int64_t base = a.tables[pair / a.ng * a.nbb + j] * block_stride + head_off;
    for (int i = tid; i < 2 * kMmaBS * cpr; i += kSplitThreads) {
      const int kv = i / (kMmaBS * cpr), rem = i - kv * kMmaBS * cpr;
      const int r = rem / cpr, c = rem - r * cpr;
      wg::cp_async16(wg::smem_u32(dst + (kv * kMmaBS + r) * ldk * sizeof(TS) + 16 * c),
                     (kv ? va : ka) + base + static_cast<int64_t>(r) * hs + c * kPad);
    }
    if constexpr (kQuant) {
      if (tid < 8) {  // 2 x 16 scales, four 16-byte chunks each
        const int kv = tid >> 2, c = tid & 3;
        wg::cp_async16(wg::smem_u32(dst + 2 * kMmaBS * ldk + kv * kMmaBS * 4 + 16 * c),
                       (kv ? a.v_scale : a.k_scale) + base / hs + 4 * c);
      }
    }
  };

  float acc[MT][4][4], m_r[MT][2], l_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][jj][i] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_r[mt][h] = kMaskValue;
      l_r[mt][h] = 0.f;
    }
  }

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (jb + k < je) load(jb + k, k);
    wg::cp_async_commit();
  }
  for (int j = jb; j < je; ++j) {
    const int it = j - jb;
    if (j + kStages - 1 < je) load(j + kStages - 1, (it + kStages - 1) % kStages);
    wg::cp_async_commit();
    wg::cp_async_wait<kStages - 1>();
    __syncthreads();
    const unsigned char* st = stages + (it % kStages) * stage_bytes;
    const TS* kt = reinterpret_cast<const TS*>(st);
    const TS* vt = kt + kMmaBS * ldk;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * kMmaBS * ldk * sizeof(TS));
    const float* vsc = ksc + kMmaBS;

    // S = Q K^T: (16 MT, hs) x (hs, 16), n-tiles of slots 0-7 and 8-15
    float sc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[mt][nt][i] = 0.f;
    for (int kk = 0; kk < hs / 16; ++kk) {
      uint32_t bk[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int row = 8 * nt + gq;
        const TS* x = kt + row * ldk + 16 * kk + 2 * tq;
        const float scale = kQuant ? ksc[row] : 0.f;
        bk[nt][0] = kv_pair<T, TS>(x, x + 1, scale, scale);
        bk[nt][1] = kv_pair<T, TS>(x + 8, x + 9, scale, scale);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const T* q0 = qs + (16 * mt + gq) * ldq + 16 * kk + 2 * tq;
        const uint32_t aq[4] = {*reinterpret_cast<const uint32_t*>(q0),
                                *reinterpret_cast<const uint32_t*>(q0 + 8 * ldq),
                                *reinterpret_cast<const uint32_t*>(q0 + 8),
                                *reinterpret_cast<const uint32_t*>(q0 + 8 * ldq + 8)};
        mma16816<T>(sc[mt][0], aq, bk[0]);
        mma16816<T>(sc[mt][1], aq, bk[1]);
      }
    }

    // one online-softmax step per row (rows gq and gq + 8 of each tile; a
    // row's 16 scores lie on the four lanes of a quad)
    uint32_t ap[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m_r[mt][h];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int slot = j * kMmaBS + 8 * nt + 2 * tq + e;
            const float x =
                keep_slot(a, slot, p) ? tt::div_rn(sc[mt][nt][2 * h + e], a.sm, inv_sm)
                                      : kMaskValue;
            sc[mt][nt][2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = wg::quad_max(mx);
        const float corr = expf(m_r[mt][h] - mx);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pv = expf(sc[mt][nt][2 * h + e] - mx);
            sc[mt][nt][2 * h + e] = pv;
            sum += pv;
          }
        l_r[mt][h] = l_r[mt][h] * corr + wg::quad_sum(sum);
        m_r[mt][h] = mx;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[mt][jj][2 * h] *= corr;
          acc[mt][jj][2 * h + 1] *= corr;
        }
      }
      // p, rounded to T, as the A operand (the accumulator layout is the
      // A layout: slots 0-7 from n-tile 0, 8-15 from n-tile 1)
      ap[mt][0] = wg::pack2<T>(sc[mt][0][0], sc[mt][0][1]);
      ap[mt][1] = wg::pack2<T>(sc[mt][0][2], sc[mt][0][3]);
      ap[mt][2] = wg::pack2<T>(sc[mt][1][0], sc[mt][1][1]);
      ap[mt][3] = wg::pack2<T>(sc[mt][1][2], sc[mt][1][3]);
    }

    // acc += cast(p) V over this warp's column groups
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int nt = w + 4 * jj;
      if (nt < n_cols) {
        const int col = 8 * nt + gq, k0 = 2 * tq;
        const TS* x = vt + k0 * ldk + col;
        const uint32_t bv[2] = {
            kv_pair<T, TS>(x, x + ldk, kQuant ? vsc[k0] : 0.f, kQuant ? vsc[k0 + 1] : 0.f),
            kv_pair<T, TS>(x + 8 * ldk, x + 9 * ldk, kQuant ? vsc[k0 + 8] : 0.f,
                           kQuant ? vsc[k0 + 9] : 0.f)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma16816<T>(acc[mt][jj], ap[mt], bv);
      }
    }
    __syncthreads();  // the stage is free for the load kStages - 1 blocks on
  }
  wg::cp_async_wait<0>();

  // the partial of this split
  float* pml = a.part + (pair * a.splits + s) * R * 2;
  float* pacc = part_acc(a) + (pair * a.splits + s) * R * hs;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * mt + gq + 8 * h;
      if (row >= nr) continue;
      if (w == 0 && tq == 0) {
        pml[2 * (r0 + row)] = m_r[mt][h];
        pml[2 * (r0 + row) + 1] = l_r[mt][h];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int nt = w + 4 * jj;
        if (nt < n_cols)
          *reinterpret_cast<float2*>(pacc + static_cast<int64_t>(r0 + row) * hs + 8 * nt +
                                     2 * tq) = make_float2(acc[mt][jj][2 * h], acc[mt][jj][2 * h + 1]);
      }
    }
}

// Floats of shared memory of the FMA products at RT rows per block.
__host__ __device__ constexpr int fma_split_floats(int RT, int hs, int bs) {
  return RT * (hs + 1) + RT * hs + bs * (hs + 1) + bs * hs + RT * bs + 3 * RT;
}

// The FMA products: any query, storage and compute types, any bs and hs
// that fit, a.row_tile rows per block.  Shared memory, in floats:
//   qs[RT][hs+1] acc[RT][hs] kt[bs][hs+1] vt[bs][hs] sc[RT][bs] m[RT] l[RT] corr[RT]
template <typename TQ, typename TS, typename TC>
__device__ __forceinline__ void split_fma(const SplitArgs& a, float* smem) {
  const int hs = a.hs, bs = a.bs, R = a.rows, RT = a.row_tile, n_rt = (R + RT - 1) / RT;
  const int hsp = hs + 1;
  float* qs = smem;
  float* acc = qs + RT * hsp;
  float* kt = acc + RT * hs;
  float* vt = kt + bs * hsp;
  float* sc = vt + bs * hs;
  float* m = sc + RT * bs;
  float* l = m + RT;
  float* corr = l + RT;
  const int s = blockIdx.x, grp = blockIdx.y / n_rt, b = blockIdx.z;
  const int r0 = (blockIdx.y % n_rt) * RT, nr = min(RT, R - r0);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int64_t pair = static_cast<int64_t>(b) * a.ng + grp;
  const int p = a.pos[b];
  int jb, je;
  split_range(a, p, s, jb, je);

  const TQ* qg = static_cast<const TQ*>(a.q) + (pair * R + r0) * hs;
  for (int i = tid; i < RT * hs; i += kSplitThreads) {
    const int r = i / hs, d = i - r * hs;
    qs[r * hsp + d] = r < nr ? to_f<TQ>(qg[i]) : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < RT; r += kSplitThreads) {
    m[r] = kMaskValue;
    l[r] = 0.f;
  }

  const int64_t tsz = static_cast<int64_t>(bs) * hs;
  const int64_t layer_stride = a.ng * tsz, block_stride = a.L * layer_stride;
  const int64_t head_off = a.layer * layer_stride + grp * tsz;
  const TS* ka = static_cast<const TS*>(a.k_arena);
  const TS* va = static_cast<const TS*>(a.v_arena);
  for (int j = jb; j < je; ++j) {
    __syncthreads();  // the previous block's readers are done
    const int64_t base = a.tables[static_cast<int64_t>(b) * a.nbb + j] * block_stride + head_off;
    const int64_t sbase = base / hs;  // the scale of slot c is sbase + c
    for (int i = tid; i < bs * hs; i += kSplitThreads) {
      const int c = i / hs, d = i - c * hs;
      float ks = 0.f, vs = 0.f;
      if constexpr (quantized<TS>::value) {
        ks = a.k_scale[sbase + c];
        vs = a.v_scale[sbase + c];
      }
      kt[c * hsp + d] = round_to<TQ>(load_kv<TS, TC>(ka[base + i], ks));
      vt[i] = round_to<TQ>(load_kv<TS, TC>(va[base + i], vs));
    }
    __syncthreads();
    for (int pr = tid; pr < RT * bs; pr += kSplitThreads) {
      const int r = pr / bs, c = pr - r * bs;
      const float* qr = qs + r * hsp;
      const float* kc = kt + c * hsp;
      float dot = 0.f;
      for (int d = 0; d < hs; ++d) dot += qr[d] * kc[d];
      sc[pr] = keep_slot(a, j * bs + c, p) ? dot / a.sm : kMaskValue;
    }
    __syncthreads();
    for (int r = w; r < RT; r += kSplitThreads / 32) {  // a warp per row
      float* sr = sc + r * bs;
      const float m_old = m[r];
      float mx = m_old;
      for (int c = lane; c < bs; c += 32) mx = fmaxf(mx, sr[c]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int c = lane; c < bs; c += 32) {
        const float e = expf(sr[c] - mx);
        sr[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float cr = expf(m_old - mx);
        l[r] = l[r] * cr + sum;
        m[r] = mx;
        corr[r] = cr;
      }
    }
    __syncthreads();
    for (int i = tid; i < RT * hs; i += kSplitThreads) {
      const int r = i / hs, d = i - r * hs;
      const float* sr = sc + r * bs;
      float pv = 0.f;
      for (int c = 0; c < bs; ++c) pv += round_to<TQ>(sr[c]) * vt[c * hs + d];
      acc[i] = acc[i] * corr[r] + pv;
    }
  }
  __syncthreads();
  float* pml = a.part + (pair * a.splits + s) * R * 2;
  float* pacc = part_acc(a) + (pair * a.splits + s) * R * hs;
  for (int r = tid; r < nr; r += kSplitThreads) {
    pml[2 * (r0 + r)] = m[r];
    pml[2 * (r0 + r) + 1] = l[r];
  }
  for (int i = tid; i < nr * hs; i += kSplitThreads) pacc[static_cast<int64_t>(r0) * hs + i] = acc[i];
}

// grid (splits, ng * row tiles, B), block 128; MT > 0: the mma.sync
// products over MT 16-row tiles, MT = 0: the FMA products.
template <typename TQ, typename TS, typename TC, int MT>
__global__ void __launch_bounds__(kSplitThreads) paged_attn_split_kernel(SplitArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (MT > 0) {
    split_mma<TQ, TS, MT>(a, smem);
  } else {
    split_fma<TQ, TS, TC>(a, reinterpret_cast<float*>(smem));
  }
}

// grid (ceil(rows / 4), ng, B), block 128: a warp per query row.  Folds the
// row's split partials in split order, then its fresh keys c <= t (t =
// r % T) as one last online-softmax step, and writes acc / l.
template <typename TQ, typename TC>
__device__ __forceinline__ void combine(const SplitArgs& a) {
  __shared__ float fac[4][kMaxSplits][2];  // each split's fold factors
  __shared__ float fsc[4][kMaxFresh];       // fresh scores, then their exps
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * 4 + w, grp = blockIdx.y, b = blockIdx.z;
  if (r >= a.rows) return;  // the whole warp leaves together
  const int R = a.rows, hs = a.hs, S = a.splits, T = a.T;
  const int64_t pair = static_cast<int64_t>(b) * a.ng + grp;
  const float* pml = a.part + pair * S * R * 2;
  const float* pacc = part_acc(a) + pair * S * R * hs;
  // every split's m and l at once (lane s and s + 32), then the fold in
  // split order through shuffles: no load waits inside the fold
  float m_lo = kMaskValue, l_lo = 0.f, m_hi = kMaskValue, l_hi = 0.f;
  if (lane < S) {
    m_lo = pml[2 * (lane * R + r)];
    l_lo = pml[2 * (lane * R + r) + 1];
  }
  if (lane + 32 < S) {
    m_hi = pml[2 * ((lane + 32) * R + r)];
    l_hi = pml[2 * ((lane + 32) * R + r) + 1];
  }
  float m = kMaskValue, l = 0.f;
  for (int s = 0; s < S; ++s) {
    const float ms = __shfl_sync(0xffffffffu, s < 32 ? m_lo : m_hi, s & 31);
    const float ls = __shfl_sync(0xffffffffu, s < 32 ? l_lo : l_hi, s & 31);
    const float mn = fmaxf(m, ms), co = expf(m - mn), cs = expf(ms - mn);
    l = l * co + ls * cs;
    m = mn;
    if (lane == 0) {
      fac[w][s][0] = co;
      fac[w][s][1] = cs;
    }
  }
  const int t = r % T;
  const TQ* qr = static_cast<const TQ*>(a.q) + (pair * R + r) * hs;
  const TC* fk = static_cast<const TC*>(a.fresh_k) + pair * T * hs;
  const TC* fv = static_cast<const TC*>(a.fresh_v) + pair * T * hs;
  float mx = m;
  for (int c = 0; c <= t; ++c) {
    float dot = 0.f;
    for (int d = lane; d < hs; d += 32)
      dot += to_f<TQ>(qr[d]) * round_to<TQ>(to_f<TC>(fk[static_cast<int64_t>(c) * hs + d]));
    dot = warp_sum(dot) / a.sm;
    mx = fmaxf(mx, dot);
    if (lane == 0) fsc[w][c] = dot;
  }
  __syncwarp();
  for (int c = lane; c <= t; c += 32) fsc[w][c] = expf(fsc[w][c] - mx);
  __syncwarp();
  const float corr = expf(m - mx);
  float fsum = 0.f;
  for (int c = 0; c <= t; ++c) fsum += fsc[w][c];
  l = l * corr + fsum;
  TQ* o = static_cast<TQ*>(a.out) + (pair * R + r) * hs;
  for (int d = lane; d < hs; d += 32) {
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s)  // unrolled, so the loads run ahead of the fold
      acc = acc * fac[w][s][0] + pacc[(static_cast<int64_t>(s) * R + r) * hs + d] * fac[w][s][1];
    float pv = 0.f;
    for (int c = 0; c <= t; ++c)
      pv += round_to<TQ>(fsc[w][c]) * round_to<TQ>(to_f<TC>(fv[static_cast<int64_t>(c) * hs + d]));
    o[d] = from_f<TQ>((acc * corr + pv) / l);
  }
}

// The combine kernel under each caller's name (the profiles group kernels
// by it).
template <typename TQ, typename TC>
__global__ void __launch_bounds__(128) paged_attn_decode_combine_kernel(SplitArgs a) {
  combine<TQ, TC>(a);
}
template <typename TQ, typename TC>
__global__ void __launch_bounds__(128) paged_attn_verify_combine_kernel(SplitArgs a) {
  combine<TQ, TC>(a);
}

// Launches kernel K with `smem` bytes of dynamic shared memory, having
// raised K's limit to all a block may use once per device (kept across
// calls: the limit does not change occupancy, the launch's size does).
template <auto K>
cudaError_t launch_smem(dim3 grid, int threads, size_t smem, cudaStream_t s, const SplitArgs& a) {
  if (smem > 48 * 1024) {
    static uint64_t raised = 0;  // a bit per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (!((raised >> dev) & 1)) {
      e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
      if (e != cudaSuccess) return e;
      raised |= 1ull << dev;
    }
  }
  K<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

// Whether the mma.sync products take these types: T bf16 or f16 for the
// queries and the fresh K/V, the arena in T or quantized.
template <typename TQ, typename TS, typename TC> constexpr bool mma_types() {
  return !std::is_same<TQ, float>::value && std::is_same<TQ, TC>::value &&
         (std::is_same<TS, TQ>::value || quantized<TS>::value);
}

template <typename TQ, typename TS, typename TC>
cudaError_t launch_split(const SplitArgs& a, int B, int products, int kind, cudaStream_t st) {
  const int n_rt = (a.rows + a.row_tile - 1) / a.row_tile;
  const dim3 grid(a.splits, a.ng * n_rt, B);
  cudaError_t e;
  if (products == 1) {
    if constexpr (mma_types<TQ, TS, TC>()) {
      if (a.bs != kMmaBS || a.hs % 16 != 0 || a.hs > 128 || a.row_tile != kRowTile)
        return cudaErrorInvalidValue;
      const int rt = min(a.rows, kRowTile);
      if (rt <= 16) {
        e = launch_smem<paged_attn_split_kernel<TQ, TS, TC, 1>>(
            grid, kSplitThreads, mma_split_smem<TS>(1, a.hs), st, a);
      } else if (rt <= 32) {
        e = launch_smem<paged_attn_split_kernel<TQ, TS, TC, 2>>(
            grid, kSplitThreads, mma_split_smem<TS>(2, a.hs), st, a);
      } else {
        e = launch_smem<paged_attn_split_kernel<TQ, TS, TC, 4>>(
            grid, kSplitThreads, mma_split_smem<TS>(4, a.hs), st, a);
      }
    } else {
      return cudaErrorInvalidValue;
    }
  } else if (products == 0) {
    e = launch_smem<paged_attn_split_kernel<TQ, TS, TC, 0>>(
        grid, kSplitThreads, sizeof(float) * fma_split_floats(a.row_tile, a.hs, a.bs), st, a);
  } else {
    return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  const dim3 cgrid((a.rows + 3) / 4, a.ng, B);
  if (kind == 0) {
    paged_attn_decode_combine_kernel<TQ, TC><<<cgrid, 128, 0, st>>>(a);
  } else {
    paged_attn_verify_combine_kernel<TQ, TC><<<cgrid, 128, 0, st>>>(a);
  }
  return cudaGetLastError();
}

// The token writes: paged_token_write, paged_token_write_masked and the
// pair write of both arenas (K and V) of one decode step, verify round or
// multi-step iteration, all one launch.  Arena z (0 = K, 1 = V) is
// (num_blocks, rows, bs, hs) with rows = L * ng (hs = 1 for a rank-4 scale
// arena); its values are read in place by their own strides, sb / sr / st
// per request b, arena row r and offset t, the head's hs elements
// contiguous.
// Row b's offset t (t < T) lands at position p = pos[b] + offset + t: block
// tables[b, p / bs] (the column clamped to the table), slot p % bs; when
// n_emit is given and offset + t >= n_emit[b], at block 0, slot 0, the sink.
// Batch-padding rows carry all-sink tables and write the sink too; several
// writes may land there at once, and nothing reads it.  The live offsets of
// one row land at distinct slots, so one launch leaves the arena that
// T sequential single-offset writes leave.
struct TokenWriteArgs {
  void* arena[2];
  const void* vals[2];
  const int* tables;
  const int* pos;
  const int* n_emit;               // null: every offset is live
  int offset, T, rows, bs, nbb;
  int row_v;                       // vectors of V per slot-head row
  int64_t sb[2], sr[2], st[2];     // each arena's vals strides in vectors of V
};

// grid (ceil(rows * row_v / threads), B * T, arenas).  Thread i of (b, t)
// moves vector i % row_v of arena row i / row_v: one load, one store, the
// value's load issued before the routing's.
template <typename V>
__global__ void __launch_bounds__(256) paged_token_write_kernel(const TokenWriteArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.rows * a.row_v) return;
  const int z = blockIdx.z, bt = blockIdx.y;
  const int b = bt / a.T, t = bt - b * a.T;
  const int r = i / a.row_v, lane = i - r * a.row_v;
  const V* src = static_cast<const V*>(z ? a.vals[1] : a.vals[0]);
  const V v = z ? src[b * a.sb[1] + r * a.sr[1] + t * a.st[1] + lane]
                : src[b * a.sb[0] + r * a.sr[0] + t * a.st[0] + lane];
  int64_t blk = 0;
  int slot = 0;
  const int k = a.offset + t;
  if (a.n_emit == nullptr || k < a.n_emit[b]) {
    const int p = a.pos[b] + k;
    blk = a.tables[static_cast<int64_t>(b) * a.nbb + min(p / a.bs, a.nbb - 1)];
    slot = p % a.bs;
  }
  V* dst = static_cast<V*>(z ? a.arena[1] : a.arena[0]);
  dst[((blk * a.rows + r) * a.bs + slot) * a.row_v + lane] = v;
}

template <typename V>
cudaError_t launch_token_write(const TokenWriteArgs& a, int B, int arenas, cudaStream_t s) {
  const int n = a.rows * a.row_v;
  const int threads = n >= 256 ? 256 : (n + 31) / 32 * 32;
  paged_token_write_kernel<V><<<dim3((n + threads - 1) / threads, B * a.T, arenas), threads, 0,
                                s>>>(a);
  return cudaGetLastError();
}

// The quantizing token write of one or two arenas (K and V) of a decode
// step, verify round or multi-step iteration, one launch.  Arena z is
// (num_blocks, rows, bs, hs) quantized storage TS with its scale arena
// (num_blocks, rows, bs); its values at the compute type TV are read in
// place by their strides (sb / sr / st per request, arena row and offset,
// in elements, the head's hs elements contiguous).  Routing as
// paged_token_write_kernel: offset t of row b at position pos[b] + offset +
// t, or sink block 0, slot 0 when n_emit is given and offset + t >=
// n_emit[b].
struct TokenQArgs {
  void* arena[2];
  float* scale[2];
  const void* vals[2];
  const int* tables;
  const int* pos;
  const int* n_emit;               // null: every offset is live
  int offset, T, rows, bs, hs, nbb;
  int lanes_log2;                  // log2 of the lanes per slot-head, G <= 32
  int pieces;                      // 8-value pieces per lane: ceil(hs / (8 G))
  int64_t sb[2], sr[2], st[2];     // each arena's vals strides in elements
  float inv_qmax;
};

// grid (ceil(rows / groups), B * T, arenas), block groups * G.  A slot-head
// (arena row r of request b at offset t: hs values, one scale) belongs to a
// group of G lanes, each holding 8 of its values (pieces of 8 further apart
// when hs > 8 G) in registers from one 16-byte load: the absmax is an
// xor-shuffle max within the group (order-free, so the scale is bit-exact),
// the quantize runs from the same registers (store_q8: the IEEE quotient,
// then quantize8, bit for bit quantize), 8 bytes stored per lane and the
// scale by the group's first lane.  The value loads are issued before the
// routing's, and both before either is used.
template <typename TS, typename TV, bool VEC>
__global__ void __launch_bounds__(256) paged_token_write_q_kernel(const TokenQArgs a) {
  const int G = 1 << a.lanes_log2;
  const int r = blockIdx.x * (blockDim.x >> a.lanes_log2) + (threadIdx.x >> a.lanes_log2);
  if (r >= a.rows) return;             // the whole group leaves together
  const int z = blockIdx.z, bt = blockIdx.y;
  const int b = bt / a.T, t = bt - b * a.T;
  const int lane = threadIdx.x & (G - 1);
  const unsigned gmask = G == 32 ? 0xffffffffu
                                 : ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  const int hs = a.hs, pieces = a.pieces;
  const TV* x = static_cast<const TV*>(z ? a.vals[1] : a.vals[0]) +
                (z ? b * a.sb[1] + r * a.sr[1] + t * a.st[1]
                   : b * a.sb[0] + r * a.sr[0] + t * a.st[0]);
  // the first piece's load, then the routing's (pos, n_emit, the table),
  // all in flight before either is used
  tt::Raw8<TV> raw{};
  if (VEC && lane * 8 < hs) raw = tt::load_raw8<TV>(x + lane * 8);
  int64_t blk = 0;
  int slot = 0;
  const int k = a.offset + t;
  if (a.n_emit == nullptr || k < a.n_emit[b]) {
    const int p = a.pos[b] + k;
    blk = a.tables[static_cast<int64_t>(b) * a.nbb + min(p / a.bs, a.nbb - 1)];
    slot = p % a.bs;
  }
  float v[8];
  if constexpr (VEC) {
    tt::unpack8<TV>(raw, v);         // zeros past hs
  } else {
    tt::load8<TV, false>(x, lane * 8, hs, v);
  }
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  for (int k2 = 1; k2 < pieces; ++k2) {
    float w[8];
    tt::load8<TV, VEC>(x, (k2 * G + lane) * 8, hs, w);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(w[e]));
  }
  for (int o = G >> 1; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(gmask, amax, o));
  const float scale = tt::absmax_scale(amax, a.inv_qmax);
  const int64_t row = (blk * a.rows + r) * a.bs + slot;
  TS* d = static_cast<TS*>(z ? a.arena[1] : a.arena[0]) + row * hs;
  float e_err = 0.f, e_abs = 0.f;      // no sums kept
  tt::store_q8<TS, VEC>(d, lane * 8, hs, v, scale, e_err, e_abs);
  for (int k2 = 1; k2 < pieces; ++k2) {
    float w[8];
    tt::load8<TV, VEC>(x, (k2 * G + lane) * 8, hs, w);
    tt::store_q8<TS, VEC>(d, (k2 * G + lane) * 8, hs, w, scale, e_err, e_abs);
  }
  if (lane == 0) (z ? a.scale[1] : a.scale[0])[row] = scale;
}

}  // namespace

// The split-K body (kind 0: a decode call, T = 1; kind 1: a verify call).
// dtype codes: q_dtype and c_dtype (the fresh K/V) 0 = float32, 1 = float16,
// 2 = bfloat16; kv_dtype (the arena) those or 3 = int8, 4 = float8_e4m3fn,
// whose k_scale/v_scale (num_blocks, L, ng, bs) float32 must then be given
// (null otherwise).  An unquantized arena has the fresh K/V's dtype.
// rows = rep * T.  window <= 0 means no sliding window.  splits (1 ..
// kMaxSplits) and row_tile (query rows per block: 64 for the mma.sync
// products) come from cudaex; products 1 = mma.sync, 0 = FMA.  partial:
// splits * B * ng * rows * (hs + 2) float32 of scratch.  T <= kMaxFresh.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int tt_paged_attn_split(const void* q, const void* k_arena, const void* v_arena,
                                   const float* k_scale, const float* v_scale,
                                   const void* fresh_k, const void* fresh_v, const int* tables,
                                   const int* pos, void* out, float* partial, int B, int ng,
                                   int rows, int T, int hs, int bs, int nbb, int L, int layer,
                                   int window, int splits, int row_tile, float sm, int q_dtype,
                                   int kv_dtype, int c_dtype, int products, int kind,
                                   void* stream) {
  if (B == 0) return cudaSuccess;
  if (splits < 1 || splits > kMaxSplits || T < 1 || T > kMaxFresh || row_tile < 1)
    return cudaErrorInvalidValue;
  const SplitArgs a{q,       k_arena, v_arena, k_scale, v_scale, fresh_k, fresh_v, tables,
                    pos,     out,     partial, ng,      rows,    T,       hs,      bs,
                    nbb,     L,       layer,   window,  splits,  row_tile, sm};
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
          return launch_split<TQ, TS, TC>(a, B, products, kind, s);
        }
      });
    });
  });
}

// The token writes of one or two arenas (arena1/vals1 null: one).  geom:
// B, T, rows, bs, nbb, the bytes of a slot-head row, then vals0's strides
// sb, sr, st and vals1's, in bytes; vec_bytes (16, 8, 4, 2 or 1) divides
// the row, the strides and every base address (the wrapper picks the
// widest); the copy
// moves bits, whatever the dtype.  n_emit null is the plain write, else the
// keep-masked one of offsets offset .. offset + T - 1.
extern "C" int tt_paged_token_write(void* arena0, void* arena1, const void* vals0,
                                    const void* vals1, const int* tables, const int* pos,
                                    const int* n_emit, const int64_t* geom, int offset,
                                    int vec_bytes, void* stream) {
  const int B = static_cast<int>(geom[0]), arenas = arena1 == nullptr ? 1 : 2;
  if (B == 0) return cudaSuccess;
  const int64_t w = vec_bytes;
  if (w != 16 && w != 8 && w != 4 && w != 2 && w != 1) return cudaErrorInvalidValue;
  for (int k = 5; k < 12; ++k)
    if (geom[k] % w) return cudaErrorInvalidValue;
  const uintptr_t at =
      reinterpret_cast<uintptr_t>(arena0) | reinterpret_cast<uintptr_t>(arena1) |
      reinterpret_cast<uintptr_t>(vals0) | reinterpret_cast<uintptr_t>(vals1);
  if (at % w) return cudaErrorInvalidValue;
  TokenWriteArgs a{{arena0, arenas == 2 ? arena1 : arena0},
                   {vals0, arenas == 2 ? vals1 : vals0},
                   tables, pos, n_emit, offset,
                   static_cast<int>(geom[1]), static_cast<int>(geom[2]),
                   static_cast<int>(geom[3]), static_cast<int>(geom[4]),
                   static_cast<int>(geom[5] / w),
                   {geom[6] / w, geom[9] / w},
                   {geom[7] / w, geom[10] / w},
                   {geom[8] / w, geom[11] / w}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch_token_write<uint4>(a, B, arenas, s);
    case 8: return launch_token_write<uint2>(a, B, arenas, s);
    case 4: return launch_token_write<uint32_t>(a, B, arenas, s);
    case 2: return launch_token_write<uint16_t>(a, B, arenas, s);
    default: return launch_token_write<uint8_t>(a, B, arenas, s);
  }
}

// The quantizing token write of one or two arenas (arena1, scale1, vals1
// null: one; kv_dtype 3 = int8, 4 = fp8 e4m3), quantizing the values at
// v_dtype (0/1/2, the compute dtype) on the way.  geom: B, T, rows, bs, hs,
// nbb, lanes_log2, pieces, threads (the wrapper's plan, cudaex._token_q_plan),
// then vals0's strides sb, sr, st and vals1's, in elements.  vec: 16-byte
// loads and 8-byte stores (hs and the strides multiples of 8, the bases
// aligned; checked here) or element by element.  n_emit null is the plain
// write of offsets offset .. offset + T - 1, else the keep-masked one.
// inv_qmax is f32(1/qmax) (1/127 or 1/448).  One launch.
extern "C" int tt_paged_token_write_fused(void* arena0, void* arena1, float* scale0,
                                          float* scale1, const void* vals0, const void* vals1,
                                          const int* tables, const int* pos, const int* n_emit,
                                          const int64_t* geom, int offset, float inv_qmax,
                                          int kv_dtype, int v_dtype, int vec, void* stream) {
  const int B = static_cast<int>(geom[0]), arenas = arena1 == nullptr ? 1 : 2;
  const TokenQArgs a{{arena0, arenas == 2 ? arena1 : arena0},
                     {scale0, arenas == 2 ? scale1 : scale0},
                     {vals0, arenas == 2 ? vals1 : vals0},
                     tables, pos, n_emit, offset,
                     static_cast<int>(geom[1]), static_cast<int>(geom[2]),
                     static_cast<int>(geom[3]), static_cast<int>(geom[4]),
                     static_cast<int>(geom[5]), static_cast<int>(geom[6]),
                     static_cast<int>(geom[7]),
                     {geom[9], geom[12]}, {geom[10], geom[13]}, {geom[11], geom[14]},
                     inv_qmax};
  const int threads = static_cast<int>(geom[8]);
  if (B == 0 || a.T == 0 || a.rows == 0) return cudaSuccess;
  if (a.lanes_log2 < 0 || a.lanes_log2 > 5 || a.pieces < 1 ||
      a.pieces * (8 << a.lanes_log2) < a.hs || threads > 256 || threads % 32 ||
      threads < (1 << a.lanes_log2))
    return cudaErrorInvalidValue;
  if (vec) {
    const uintptr_t in = reinterpret_cast<uintptr_t>(a.vals[0]) |
                         reinterpret_cast<uintptr_t>(a.vals[1]);
    const uintptr_t out = reinterpret_cast<uintptr_t>(a.arena[0]) |
                          reinterpret_cast<uintptr_t>(a.arena[1]);
    bool strided = a.hs % 8 == 0;
    for (int k = 9; k < 15; ++k) strided = strided && geom[k] % 8 == 0;
    if (!strided || in % 16 || out % 8) return cudaErrorInvalidValue;
  }
  const int groups = threads >> a.lanes_log2;
  const dim3 grid((a.rows + groups - 1) / groups, B * a.T, arenas);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tt::by_float(v_dtype, [&](auto tv) {
    return tt::by_storage(kv_dtype, [&](auto ts) -> cudaError_t {
      using TV = decltype(tv);
      using TS = decltype(ts);
      if constexpr (!quantized<TS>::value) {
        return cudaErrorInvalidValue;
      } else {
        if (vec) {
          paged_token_write_q_kernel<TS, TV, true><<<grid, threads, 0, s>>>(a);
        } else {
          paged_token_write_q_kernel<TS, TV, false><<<grid, threads, 0, s>>>(a);
        }
        return cudaGetLastError();
      }
    });
  });
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
