// Per-request LoRA delta for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel lora_delta_fused of
// thunder_tpu/executors/pallasex.py (:1740; body _lora_delta_kernel :1731,
// pallas_call :1756): for each request i of the batch,
//
//   out[i] = scaling * (x[i] . A[s_i]^T) . B[s_i]^T
//
// with x (B, T, fin) at the compute dtype, A (S, r, fin) and B (S, fout, r)
// at the registry's dtype, out (B, T, fout) at x's dtype, and s_i = slots[i]
// (the registry's adapter slot of request i, read inside the kernel) or i
// when no slots are given (factors gathered per request beforehand, the
// reference's signature).  The dtype flow is the reference's
// (_lora_delta_kernel, models/generate.py _lora_delta): A and B are rounded
// to x's dtype first; d = x . A^T accumulates in float32 and rounds to x's
// dtype; d . B^T accumulates in float32 and rounds; the product times
// scaling (itself rounded to x's dtype, as a weakly typed Python scalar is
// in JAX) is taken in float32 and rounded once more.  A request on the
// all-zero base slot gets an exact 0.0 delta, computed as any other row's.
//
// What bounds it on an H100: bytes.  At the Llama-3-8B decode shape (B = 8,
// T = 1, fin = fout = 4096, r = 16, float32 factors) the factors are 4 MB
// and the work 2 MFLOP; at the chunk shape (B = 1, T = 512) x and the
// output are 8 MB and the work 0.13 GFLOP, still far under the byte time.
//
// Design: the kernels of both phases launch from one call, on the caller's
// stream, in order; no atomics, so repeats are bitwise equal.
//   * Phase 1, d = x . A^T once per (request, row tile): the grid is (fin
//     split [x rank group], row tile, request), the split count chosen from
//     shapes alone (plan_of, which the host reads through tt_lora_plan) so
//     the grid fills the card when B * T is small (at decode, 8 splits of
//     512 x 4 rank groups x 8 requests).
//     Each block writes its partial d in float32 to a workspace (B, splits,
//     T, r).  bf16/f16 x with T >= 16 takes mma.sync m16n8k16 tiles: 64
//     rows a block, the x slab and the A slice (rounded to x's dtype)
//     staged in shared memory with 16-byte loads, bf16 x bf16 products
//     exact in the f32 accumulators, the partials leaving as whole 16-byte
//     rows.  Otherwise (float32 x, which stays off TF32, and the decode and
//     verify shapes' few rows) each warp reads one A row straight into
//     registers with 16-byte loads while x is staged, every lane keeps one
//     f32 sum per row and a butterfly adds the lanes: each A value is read
//     once per block and used for all its rows.
//   * Phase 2, out = round(round(d . B^T) * sc), one block per 128 output
//     columns and row tile.  FMA (one column per thread): the prologue
//     folds the partials in split order and rounds d to x's dtype into
//     shared memory while the thread's B row (64 ranks at a time) loads
//     into registers.  mma.sync (64 rows, 16 a warp): a fold kernel first
//     sums the partials in split order once into d (B, T, r) at x's dtype,
//     so no column tile folds them again; B is staged in 64-rank chunks and
//     the tile leaves through shared memory as whole 16-byte rows.  Any
//     rank runs, and d is never recomputed.
//   * Loads and sums do not depend on alignment: the host allows 16-byte
//     loads only where every row start is 16-byte aligned, and the elements
//     each lane owns are the same either way, so a slot read equals the
//     gathered call bit for bit.
//   * A slot outside [0, S) reads slot 0 in its place (in bounds), and its
//     rows come out NaN.

#include <algorithm>

#include "common.cuh"

namespace {

using tt::from_f;
using tt::mma16816;
using tt::round_to;

constexpr int kThreads = 128;   // four warps
constexpr int kRowsMma = 64;    // rows of x per phase-1 block on mma.sync, 16 a warp
constexpr int kRowsOutMma = 64; // rows per phase-2 block on mma.sync, 16 a warp
constexpr int kSplitMax = 256;  // fin per phase-1 mma.sync block at most
// rows per FMA block (both phases), by T: decode's one row, verify's few,
// else 16; the loops over them unroll to exactly these rows.  A phase-1
// FMA block takes kRanksFma ranks (one a warp: few sums, many blocks) and
// at most kSplitFma columns of fin (a lane's A values: four 16-byte loads).
constexpr int fma_rows(int T) { return T == 1 ? 1 : T <= 8 ? 8 : 16; }
constexpr int kRanksFma = 4;
static_assert(kRanksFma * 32 == kThreads, "one rank a warp");
constexpr int kSplitFma = 512;
constexpr int kSplitMin = 64;   // fin per phase-1 block at least
// phase-1 blocks the split count aims at on an H100's 132 SMs: FMA one
// wave, mma.sync two blocks an SM
constexpr int kTargetFma = 132, kTargetMma = 264;
constexpr int kRanksMma = 16;   // ranks per chunk of a phase-1 mma.sync block
constexpr int kCols = 128;      // fout columns per phase-2 FMA block, one a thread
constexpr int kColsMma = 128;   // fout columns per phase-2 mma.sync block, all a warp's
constexpr int kRankChunk = 64;  // ranks of B per phase-2 chunk
constexpr int kPad = 8;         // elements of padding per low-precision smem row
constexpr int kBatch = 8;       // 16-byte loads a thread keeps in flight while staging



struct Args {
  const void* x;
  const void* a;
  const void* b;
  const int* slots;  // (B,) or null: request i reads factors i
  void* out;
  float* ws;         // (B, splits, T, r) partials of d
  int B, T, fin, fout, r, n_slots;
  long long a_stride, b_stride;  // elements between two slots' factors
  int splits, ks, vec;           // fin split count and length; 16-byte loads allowed
  float scaling;
};

// Request i's slot; one outside [0, S) reads slot 0 in its place (in
// bounds) and is reported by valid, so no kernel branches on the slot
// before its other loads are in flight.
__device__ __forceinline__ int slot_of(const Args& p, int i, bool& valid) {
  const int s = p.slots != nullptr ? __ldg(p.slots + i) : i;
  valid = s >= 0 && s < p.n_slots;
  return valid ? s : 0;
}

// A value rounded to TX, as TD (float, or TX itself for the mma.sync operands)
template <typename TD, typename TX> __device__ __forceinline__ TD as_operand(float v) {
  if constexpr (std::is_same<TD, float>::value) {
    return round_to<TX>(v);
  } else {
    return from_f<TX>(v);
  }
}

// The V = 16 / sizeof(TS) elements at s as raw bits, of which the first n
// exist (the rest 0): one 16-byte load when vec (s is 16-byte aligned) and
// the chunk is whole, else element by element.
template <typename TS>
__device__ __forceinline__ uint4 load_chunk(const TS* s, int n, bool vec) {
  constexpr int V = 16 / sizeof(TS);
  if (vec && n >= V) return __ldg(reinterpret_cast<const uint4*>(s));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (k < n) {
      if constexpr (sizeof(TS) == 4) {
        w[k] = __ldg(reinterpret_cast<const unsigned int*>(s) + k);
      } else {
        w[k / 2] |= static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(s) + k))
                    << (16 * (k % 2));
      }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Element k (a compile-time index once unrolled) of the V = 16 /
// sizeof(TS) elements held in u, as float: bit shifts, so u stays in
// registers.
__device__ __forceinline__ uint32_t word_of(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}
template <typename TS> __device__ __forceinline__ float elem(const uint4& u, int k) {
  if constexpr (sizeof(TS) == 4) {
    return __uint_as_float(word_of(u, k));
  } else {
    const unsigned short h = static_cast<unsigned short>(word_of(u, k / 2) >> (16 * (k % 2)));
    if constexpr (std::is_same<TS, __half>::value) {
      return __half2float(__ushort_as_half(h));
    } else {
      return __bfloat162float(__ushort_as_bfloat16(h));
    }
  }
}

// The bits of v as TD stores them (float, or a 16-bit TD in the low half)
template <typename TD> __device__ __forceinline__ uint32_t bits_of(TD v) {
  if constexpr (std::is_same<TD, float>::value) {
    return __float_as_uint(v);
  } else if constexpr (std::is_same<TD, __half>::value) {
    return __half_as_ushort(v);
  } else {
    return __bfloat16_as_ushort(v);
  }
}

// Copies the (rows x cols) window of src (row stride ld_src) into dst (row
// stride ld_dst), each value rounded to TX, zeros out to (rows_pad x
// cols_pad).  Each thread takes V = 16 / sizeof(TS) consecutive elements of
// a row at a time (load_chunk), kBatch of them loaded before any is stored:
// load(0) ... store(0) let other loads fly in between, finish() stages the
// other batches, run() all of it.
template <typename TX, typename TS, typename TD>
struct Stage {
  static constexpr int V = 16 / sizeof(TS);
  TD* dst;
  int ld_dst;
  const TS* src;
  long long ld_src;
  int rows, cols, cols_pad, per_row, total;
  bool vec;
  uint4 u[kBatch];

  __device__ __forceinline__ Stage(TD* dst_, int ld_dst_, const TS* src_, long long ld_src_,
                                   int rows_, int cols_, int rows_pad, int cols_pad_, bool vec_)
      : dst(dst_), ld_dst(ld_dst_), src(src_), ld_src(ld_src_), rows(rows_), cols(cols_),
        cols_pad(cols_pad_), per_row((cols_pad_ + V - 1) / V), total(rows_pad * per_row),
        vec(vec_) {}

  __device__ __forceinline__ void load(int batch) {
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = threadIdx.x + (batch * kBatch + q) * kThreads;
      const int row = i / per_row, c = (i % per_row) * V;
      const int n = i < total && row < rows ? cols - c : 0;
      u[q] = n > 0 ? load_chunk<TS>(src + row * ld_src + c, n, vec) : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void store(int batch) {
    constexpr int kBytes = V * static_cast<int>(sizeof(TD));   // 8, 16 or 32
    constexpr int kAlign = kBytes < 16 ? kBytes : 16;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = threadIdx.x + (batch * kBatch + q) * kThreads;
      if (i < total) {
        const int row = i / per_row, c = (i % per_row) * V;
        TD* d = dst + row * ld_dst + c;
        if (c + V <= cols_pad && reinterpret_cast<uintptr_t>(d) % kAlign == 0) {
          // the chunk whole, as 8- or 16-byte stores of packed words
          constexpr int kWords = kBytes / 4, kPer = 4 / static_cast<int>(sizeof(TD));
          uint32_t w[kWords];
#pragma unroll
          for (int k = 0; k < kWords; ++k) w[k] = 0u;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            w[k / kPer] |= bits_of<TD>(as_operand<TD, TX>(elem<TS>(u[q], k)))
                           << (32 / kPer * (k % kPer));
          }
          if constexpr (kWords == 2) {
            *reinterpret_cast<uint2*>(d) = make_uint2(w[0], w[1]);
          } else {
#pragma unroll
            for (int k = 0; k < kWords / 4; ++k) {
              reinterpret_cast<uint4*>(d)[k] =
                  make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            if (c + k < cols_pad) d[k] = as_operand<TD, TX>(elem<TS>(u[q], k));
          }
        }
      }
    }
  }

  __device__ __forceinline__ void finish() {
    for (int batch = 1; batch * kBatch * kThreads < total; ++batch) {
      load(batch);
      store(batch);
    }
  }

  __device__ __forceinline__ void run() {
    load(0);
    store(0);
    finish();
  }
};

__device__ __forceinline__ uint32_t pair_at(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

//
// phase 1: partial d = x . A^T over one fin split
//

// FMA body of phase 1: R rows of request blockIdx.z; blockIdx.x is the
// fin split (fastest) and the group of 4 ranks, one a warp.  x's loads go
// first (they need no slot), then the warp's A row (every step of the
// split) into registers; x is staged in shared memory, each lane sums its
// elements in order, and a butterfly adds the lanes.
template <typename TX, typename TF, int R>
__global__ void __launch_bounds__(kThreads) lora_delta_d_fma_kernel(const Args p) {
  constexpr int V = 16 / sizeof(TF);
  constexpr int kSteps = kSplitFma / (32 * V);   // a lane's V-element steps over a split
  __shared__ __align__(16) float xs[R * kSplitFma];
  const int s = blockIdx.x % p.splits, jg = blockIdx.x / p.splits;
  const int t0 = blockIdx.y * R, req = blockIdx.z;
  const int nt = min(R, p.T - t0);
  const int k0 = s * p.ks, nk = min(p.ks, p.fin - k0);
  const int lane = threadIdx.x % 32, j = jg * kRanksFma + threadIdx.x / 32;   // this warp's rank
  bool valid;
  const int slot = slot_of(p, req, valid);
  // x zero-padded to whole steps of the lanes
  const int kp = (nk + 32 * V - 1) / (32 * V) * (32 * V);
  Stage<TX, TX, float> xst(xs, kSplitFma,
                           static_cast<const TX*>(p.x) +
                               (static_cast<size_t>(req) * p.T + t0) * p.fin + k0,
                           p.fin, nt, nk, nt, kp, p.vec);
  xst.load(0);
  const TF* a = static_cast<const TF*>(p.a) + slot * p.a_stride + static_cast<size_t>(j) * p.fin +
                k0;
  uint4 araw[kSteps];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int k = lane * V + st * 32 * V;
    araw[st] = j < p.r && k < nk ? load_chunk<TF>(a + k, nk - k, p.vec) : make_uint4(0, 0, 0, 0);
  }
  xst.store(0);
  xst.finish();
  __syncthreads();
  float acc[R];
#pragma unroll
  for (int t = 0; t < R; ++t) acc[t] = 0.f;
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    if (st * 32 * V >= nk) break;        // past the split (xs holds no zeros there)
    const int k = lane * V + st * 32 * V;
    float av[V];
#pragma unroll
    for (int q = 0; q < V; ++q) av[q] = round_to<TX>(elem<TF>(araw[st], q));
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (t < nt) {
        const float* xt = xs + t * kSplitFma + k;
#pragma unroll
        for (int q = 0; q < V; ++q) acc[t] = fmaf(xt[q], av[q], acc[t]);
      }
    }
  }
  if (!valid) return;                    // phase 2 writes the rows NaN
  float* ws = p.ws + ((static_cast<size_t>(req) * p.splits + s) * p.T + t0) * p.r;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    if (t < nt) {
      float v = acc[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && j < p.r) ws[t * p.r + j] = v;
    }
  }
}

// mma.sync body (bf16/f16 x): rows t0 .. t0 + 63, warp w rows 16 w ..
// 16 w + 15, the ranks in chunks of 16 (two 8-column tiles); the x slab
// and the first chunk of A are loaded together, and each chunk's partials
// leave through shared memory as whole 16-byte rows.
template <typename TX, typename TF>
__global__ void __launch_bounds__(kThreads) lora_delta_d_mma_kernel(const Args p) {
  constexpr int LD = kSplitMax + kPad;
  __shared__ __align__(16) unsigned char raw[(kRowsMma + kRanksMma) * LD * sizeof(TX)];
  __shared__ __align__(16) float ps[kRowsMma * kRanksMma];   // one chunk's partials
  TX* xs = reinterpret_cast<TX*>(raw);   // (kRowsMma, LD) x
  TX* as = xs + kRowsMma * LD;           // (kRanksMma, LD) A, rounded to TX
  const int s = blockIdx.x, t0 = blockIdx.y * kRowsMma, req = blockIdx.z;
  const int nt = min(kRowsMma, p.T - t0);
  const int k0 = s * p.ks, nk = min(p.ks, p.fin - k0);
  bool valid;
  const int slot = slot_of(p, req, valid);
  if (!valid) return;                   // phase 2 writes the rows NaN
  const int kp = (nk + 15) / 16 * 16;
  const TX* x = static_cast<const TX*>(p.x) + (static_cast<size_t>(req) * p.T + t0) * p.fin + k0;
  const TF* a = static_cast<const TF*>(p.a) + slot * p.a_stride + k0;
  float* ws = p.ws + ((static_cast<size_t>(req) * p.splits + s) * p.T + t0) * p.r;
  {
    Stage<TX, TX, TX> xst(xs, LD, x, p.fin, nt, nk, kRowsMma, kp, p.vec);
    Stage<TX, TF, TX> ast(as, LD, a, p.fin, min(kRanksMma, p.r), nk, kRanksMma, kp, p.vec);
    xst.load(0);
    ast.load(0);
    xst.store(0);
    ast.store(0);
    xst.finish();
    ast.finish();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int rw = 16 * warp;            // this warp's first row
  for (int j0 = 0; j0 < p.r; j0 += kRanksMma) {
    if (j0 > 0) {
      __syncthreads();                 // the last chunk of A and its partials are read
      Stage<TX, TF, TX>(as, LD, a + static_cast<size_t>(j0) * p.fin, p.fin,
                        min(kRanksMma, p.r - j0), nk, kRanksMma, kp, p.vec).run();
    }
    __syncthreads();
    if (rw < nt) {
      float acc[2][4] = {};
      for (int kk = 0; kk < kp; kk += 16) {
        const TX* xa = xs + (rw + g) * LD + kk + 2 * q;
        const uint32_t af[4] = {pair_at(xa), pair_at(xa + 8 * LD), pair_at(xa + 8),
                                pair_at(xa + 8 * LD + 8)};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const TX* ab = as + (8 * n + g) * LD + kk + 2 * q;
          const uint32_t bf[2] = {pair_at(ab), pair_at(ab + 8)};
          mma16816<TX>(acc[n], af, bf);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* pt = ps + (rw + g + 8 * h) * kRanksMma + 8 * n + 2 * q;
          pt[0] = acc[n][2 * h];
          pt[1] = acc[n][2 * h + 1];
        }
      }
    }
    __syncthreads();
    // rows t < nt, ranks j0 .. j0 + rc - 1: ws[t * r + j]
    const int rc = min(kRanksMma, p.r - j0);
    if (rc == kRanksMma && p.r % 4 == 0) {
      for (int i = threadIdx.x; i < nt * (kRanksMma / 4); i += kThreads) {
        const int t = i / (kRanksMma / 4), j4 = 4 * (i % (kRanksMma / 4));
        *reinterpret_cast<float4*>(ws + t * p.r + j0 + j4) =
            *reinterpret_cast<const float4*>(ps + t * kRanksMma + j4);
      }
    } else {
      for (int i = threadIdx.x; i < nt * rc; i += kThreads) {
        const int t = i / rc, j = i % rc;
        ws[t * p.r + j0 + j] = ps[t * kRanksMma + j];
      }
    }
  }
}

//
// phase 2: out = round(round(d . B^T) * sc), d folded from the partials
//

// d[t][j] of rows t0 .. t0 + nt - 1: the partials summed in split order,
// rounded to TX; zeros out to (rows_pad x cols_pad).  A thread folds
// kFoldVals values at once, kFoldBatch splits of each in flight (the
// host's 8 splits at decode and verify: one round trip).
constexpr int kFoldVals = 2, kFoldBatch = 8;
template <typename TX, typename TD>
__device__ __forceinline__ void fold_d(const Args& p, int req, int t0, int nt, TD* ds,
                                       int ld, int rows_pad, int cols_pad) {
  const size_t split_stride = static_cast<size_t>(p.T) * p.r;
  const float* w = p.ws + (static_cast<size_t>(req) * p.splits * p.T + t0) * p.r;
  const int n = rows_pad * cols_pad;
  for (int i0 = threadIdx.x; i0 < n; i0 += kFoldVals * kThreads) {
    const float* wt[kFoldVals];
    bool live[kFoldVals];
    float v[kFoldVals];
#pragma unroll
    for (int q = 0; q < kFoldVals; ++q) {
      const int i = i0 + q * kThreads, t = i / cols_pad, j = i % cols_pad;
      live[q] = i < n && t < nt && j < p.r;
      wt[q] = w + t * p.r + j;
      v[q] = 0.f;
    }
    for (int s = 0; s < p.splits; s += kFoldBatch) {   // splits past the last add 0
      float w8[kFoldVals][kFoldBatch];
#pragma unroll
      for (int q = 0; q < kFoldVals; ++q)
#pragma unroll
        for (int k = 0; k < kFoldBatch; ++k)
          w8[q][k] = live[q] && s + k < p.splits ? wt[q][(s + k) * split_stride] : 0.f;
#pragma unroll
      for (int q = 0; q < kFoldVals; ++q)
#pragma unroll
        for (int k = 0; k < kFoldBatch; ++k) v[q] += w8[q][k];
    }
#pragma unroll
    for (int q = 0; q < kFoldVals; ++q) {
      const int i = i0 + q * kThreads;
      if (i < n) ds[(i / cols_pad) * ld + i % cols_pad] = as_operand<TD, TX>(v[q]);
    }
  }
}

template <typename TX>
__device__ __forceinline__ TX out_value(float acc, float sc) {
  return from_f<TX>(__fmul_rn(round_to<TX>(acc), sc));
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// shared memory of phase 2: d (the block's rows of r); on mma.sync then a
// chunk of B's tile
__host__ __device__ constexpr int out_fma_smem(int rows, int r) {
  return static_cast<int>(sizeof(float)) * rows * r;
}
__host__ __device__ constexpr int out_mma_smem(int r) {
  return 2 * (kRowsOutMma * (round16(r) + kPad) + kColsMma * (kRankChunk + kPad));
}
static_assert(kRowsOutMma * (kColsMma + kPad) <= kColsMma * (kRankChunk + kPad),
              "the output tile reuses the operands' shared memory");

// Ranks j0 .. j0 + 63 of one B row (bc) into registers, 16 bytes a load
template <typename TF, int kRegs>
__device__ __forceinline__ void load_b_chunk(uint4 (&braw)[kRegs], const TF* bc, int j0,
                                             const Args& p, bool live) {
  constexpr int V = 16 / sizeof(TF);
  const int rc = min(kRankChunk, p.r - j0);
#pragma unroll
  for (int k = 0; k < kRegs; ++k) {
    braw[k] = live && k * V < rc ? load_chunk<TF>(bc + j0 + k * V, rc - k * V, p.vec)
                                 : make_uint4(0, 0, 0, 0);
  }
}

// FMA body of phase 2: R rows, the 128-column tile blockIdx.x, one column
// per thread.  Thread c keeps its column's B row (64 ranks at a time) in
// registers, loaded with 16-byte loads (the threads of a warp cover one
// contiguous stretch of B), the first chunk while d is folded into shared
// memory.
template <typename TX, typename TF, int R>
__global__ void __launch_bounds__(kThreads) lora_delta_out_fma_kernel(const Args p) {
  constexpr int V = 16 / sizeof(TF), kRegs = kRankChunk / V;
  extern __shared__ float ds[];           // (R, r) d
  const int t0 = blockIdx.y * R, req = blockIdx.z;
  const int nt = min(R, p.T - t0);
  const int c0 = blockIdx.x * kCols, c = threadIdx.x;
  const bool live = c < min(kCols, p.fout - c0);
  TX* out = static_cast<TX*>(p.out) + (static_cast<size_t>(req) * p.T + t0) * p.fout + c0 + c;
  bool valid;                             // else the rows come out NaN
  const int slot = slot_of(p, req, valid);
  const TF* bc = static_cast<const TF*>(p.b) + slot * p.b_stride +
                 static_cast<size_t>(c0 + (live ? c : 0)) * p.r;
  uint4 braw[kRegs];
  load_b_chunk<TF, kRegs>(braw, bc, 0, p, live);
  fold_d<TX, float>(p, req, t0, nt, ds, p.r, nt, p.r);
  __syncthreads();
  float acc[R];
#pragma unroll
  for (int t = 0; t < R; ++t) acc[t] = 0.f;
  for (int j0 = 0; j0 < p.r; j0 += kRankChunk) {
    if (j0 > 0) load_b_chunk<TF, kRegs>(braw, bc, j0, p, live);
    const int rc = min(kRankChunk, p.r - j0);
#pragma unroll
    for (int k = 0; k < kRegs; ++k) {
      if (k * V >= rc) break;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int j = j0 + k * V + q;
        if (k * V + q < rc) {
          const float bj = round_to<TX>(elem<TF>(braw[k], q));
#pragma unroll
          for (int t = 0; t < R; ++t) {
            if (t < nt) acc[t] = fmaf(ds[t * p.r + j], bj, acc[t]);
          }
        }
      }
    }
  }
  const float sc = round_to<TX>(p.scaling);
  if (live) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (t < nt) {
        out[static_cast<size_t>(t) * p.fout] =
            valid ? out_value<TX>(acc[t], sc) : from_f<TX>(__int_as_float(0x7fc00000));
      }
    }
  }
}

// The mma.sync path's d, once: d[i][t][j] = the partials summed in split
// order, rounded to TX, into (B, T, r).  Four lanes fold one value, each a
// quarter of the splits in order, and the quarters add in order; phase 2
// then reads d instead of folding it once per column tile.
template <typename TX>
__global__ void __launch_bounds__(kThreads) lora_delta_fold_kernel(const Args p, TX* d) {
  const long long n = static_cast<long long>(p.B) * p.T * p.r;
  const long long v = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 4;
  const int quarter = threadIdx.x % 4;
  const int per = (p.splits + 3) / 4;
  const int s0 = quarter * per, s1 = min(p.splits, s0 + per);
  float part = 0.f;
  if (v < n) {
    const long long tr = static_cast<long long>(p.T) * p.r;
    const long long req = v / tr, rest = v % tr;
    const float* w = p.ws + req * p.splits * tr + rest;
    int s = s0;
    for (; s + kBatch <= s1; s += kBatch) {
      float w8[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) w8[k] = w[(s + k) * tr];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) part += w8[k];
    }
    for (; s < s1; ++s) part += w[s * tr];
  }
  float sum = part;
#pragma unroll
  for (int k = 1; k < 4; ++k) sum += __shfl_down_sync(0xffffffffu, part, k, 4);
  if (quarter == 0 && v < n) d[v] = from_f<TX>(sum);
}

// mma.sync body (bf16/f16 x): kRowsOutMma rows (warp w rows 16 w .. 16 w +
// 15) of the kColsMma-column tile blockIdx.x (NT 8-column tiles a warp),
// d read from the fold kernel's output; the first chunk of B and d load
// together.
template <typename TX, typename TF>
__global__ void __launch_bounds__(kThreads) lora_delta_out_mma_kernel(const Args p,
                                                                      const TX* d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldd = round16(p.r) + kPad;
  constexpr int LDB = kRankChunk + kPad;
  constexpr int NT = kColsMma / 8;
  TX* ds = reinterpret_cast<TX*>(smem_raw);           // (kRowsOutMma, round16(r))
  TX* bs = ds + kRowsOutMma * ldd;                    // (kColsMma, kRankChunk)
  const int t0 = blockIdx.y * kRowsOutMma, req = blockIdx.z;
  const int nt = min(kRowsOutMma, p.T - t0);
  const int c0 = blockIdx.x * kColsMma, nc = min(kColsMma, p.fout - c0);
  TX* out = static_cast<TX*>(p.out) + (static_cast<size_t>(req) * p.T + t0) * p.fout + c0;
  bool valid;                             // else the rows come out NaN
  const int slot = slot_of(p, req, valid);
  const TF* b = static_cast<const TF*>(p.b) + slot * p.b_stride + static_cast<size_t>(c0) * p.r;
  {
    const int rc = min(kRankChunk, p.r);
    Stage<TX, TF, TX> bst(bs, LDB, b, p.r, nc, rc, kColsMma, round16(rc), p.vec);
    Stage<TX, TX, TX> dst(ds, ldd, d + (static_cast<size_t>(req) * p.T + t0) * p.r, p.r, nt,
                          p.r, kRowsOutMma, round16(p.r), p.vec);
    bst.load(0);
    dst.load(0);
    bst.store(0);
    dst.store(0);
    bst.finish();
    dst.finish();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int rw = 16 * warp;
  float acc[NT][4] = {};
  for (int j0 = 0; j0 < p.r; j0 += kRankChunk) {
    const int rc = min(kRankChunk, p.r - j0), kp = round16(rc);
    if (j0 > 0) {
      __syncthreads();                  // the last chunk is no longer read
      Stage<TX, TF, TX>(bs, LDB, b + j0, p.r, nc, rc, kColsMma, kp, p.vec).run();
    }
    __syncthreads();
    if (rw >= nt) continue;
    for (int kk = 0; kk < kp; kk += 16) {
      const TX* da = ds + (rw + g) * ldd + j0 + kk + 2 * q;
      const uint32_t af[4] = {pair_at(da), pair_at(da + 8 * ldd), pair_at(da + 8),
                              pair_at(da + 8 * ldd + 8)};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const TX* bb = bs + (8 * n + g) * LDB + kk + 2 * q;
        const uint32_t bf[2] = {pair_at(bb), pair_at(bb + 8)};
        mma16816<TX>(acc[n], af, bf);
      }
    }
  }
  // the tile through shared memory (the operands are read), then out as
  // whole 16-byte rows
  constexpr int LDO = kColsMma + kPad;
  TX* os = reinterpret_cast<TX*>(smem_raw);           // (kRowsOutMma, LDO)
  __syncthreads();
  if (rw < nt) {
    const float sc = round_to<TX>(p.scaling);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        TX* o = os + (rw + g + 8 * h) * LDO + 8 * n + 2 * q;
        const TX nan = from_f<TX>(__int_as_float(0x7fc00000));
        o[0] = valid ? out_value<TX>(acc[n][2 * h], sc) : nan;
        o[1] = valid ? out_value<TX>(acc[n][2 * h + 1], sc) : nan;
      }
    }
  }
  __syncthreads();
  constexpr int V = 8;                                // TX elements in 16 bytes
  if (nc == kColsMma && p.fout % V == 0) {
    for (int i = threadIdx.x; i < nt * (kColsMma / V); i += kThreads) {
      const int t = i / (kColsMma / V), c = V * (i % (kColsMma / V));
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(t) * p.fout + c) =
          *reinterpret_cast<const uint4*>(os + t * LDO + c);
    }
  } else {
    for (int i = threadIdx.x; i < nt * nc; i += kThreads) {
      const int t = i / nc, c = i % nc;
      out[static_cast<size_t>(t) * p.fout + c] = os[t * LDO + c];
    }
  }
}

template <typename TX, typename TF, int R>
cudaError_t launch_fma(const Args& p, cudaStream_t stream) {
  const int row_tiles = (p.T + R - 1) / R;
  const int groups = (p.r + kRanksFma - 1) / kRanksFma;
  lora_delta_d_fma_kernel<TX, TF, R>
      <<<dim3(p.splits * groups, row_tiles, p.B), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = out_fma_smem(R, p.r);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lora_delta_out_fma_kernel<TX, TF, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  lora_delta_out_fma_kernel<TX, TF, R>
      <<<dim3((p.fout + kCols - 1) / kCols, row_tiles, p.B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the mma.sync path's d, as TX, after the partials in the workspace
template <typename TX> TX* d_of(const Args& p) {
  const size_t n = static_cast<size_t>(p.B) * p.splits * p.T * p.r;
  return reinterpret_cast<TX*>(p.ws + (n + 3) / 4 * 4);
}

template <typename TX, typename TF>
cudaError_t launch_mma(const Args& p, cudaStream_t stream) {
  lora_delta_d_mma_kernel<TX, TF>
      <<<dim3(p.splits, (p.T + kRowsMma - 1) / kRowsMma, p.B), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  TX* d = d_of<TX>(p);
  const long long lanes = 4LL * p.B * p.T * p.r;
  lora_delta_fold_kernel<TX>
      <<<static_cast<unsigned>((lanes + kThreads - 1) / kThreads), kThreads, 0, stream>>>(p, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = out_mma_smem(p.r);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lora_delta_out_mma_kernel<TX, TF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  lora_delta_out_mma_kernel<TX, TF>
      <<<dim3((p.fout + kColsMma - 1) / kColsMma, (p.T + kRowsOutMma - 1) / kRowsOutMma, p.B),
         kThreads, smem, stream>>>(p, d);
  return cudaGetLastError();
}

// The launch plan of a call, from shapes and the dtype of x alone (no
// tensor value is read, so a call never syncs): the body, x rows per block,
// fin cut into `splits` pieces of `ks` (a multiple of 16, at most kSplitMax
// on mma.sync, else kSplitFma) so phase 1 holds about kTarget* blocks, the
// float32 workspace (the partials; on mma.sync then d at x's dtype) and
// phase 2's shared memory per block.
struct Plan {
  int mma, rows, splits, ks;
  long long n_ws;
  int smem;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

Plan plan_of(long long B, long long T, long long fin, long long r, int x_dtype) {
  Plan p{};
  p.mma = x_dtype != 0 && T >= 16;
  long long blocks, target, split_max;
  if (p.mma) {
    p.rows = kRowsMma;
    blocks = B * cdiv(T, kRowsMma);
    target = kTargetMma;
    split_max = kSplitMax;
  } else {
    p.rows = fma_rows(static_cast<int>(T));
    blocks = B * cdiv(T, p.rows) * cdiv(r, kRanksFma);
    target = kTargetFma;
    split_max = kSplitFma;
  }
  // as many splits as fill the target, no shorter than kSplitMin, no
  // longer than split_max
  const long long want = std::min(cdiv(target, std::max(blocks, 1LL)), cdiv(fin, kSplitMin));
  const long long splits = std::max(cdiv(fin, split_max), want);
  const long long ks = cdiv(cdiv(fin, splits), 16) * 16;
  p.ks = static_cast<int>(ks);
  p.splits = static_cast<int>(cdiv(fin, ks));
  p.n_ws = cdiv(B * p.splits * T * r, 4) * 4 + (p.mma ? cdiv(B * T * r, 2) : 0);
  p.smem = p.mma ? out_mma_smem(static_cast<int>(r)) : out_fma_smem(p.rows, static_cast<int>(r));
  return p;
}

constexpr int kMaxSmem = 232448;   // shared memory one block may use on Hopper

}  // namespace

// The plan of a call with x (B, T, fin) at dtype code x_dtype and rank r
// (plan_of): out[0..5] = mma, rows, splits, ks, workspace floats, phase 2's
// shared memory per block.  The host sizes the workspace from it and
// refuses a rank whose shared memory exceeds the block's before launching.
extern "C" int tt_lora_plan(long long B, long long T, long long fin, long long r, int x_dtype,
                            long long* out) {
  if (B < 0 || T < 0 || fin < 1 || r < 1 || x_dtype < 0 || x_dtype > 2) {
    return cudaErrorInvalidValue;
  }
  const Plan p = plan_of(B, T, fin, r, x_dtype);
  out[0] = p.mma;
  out[1] = p.rows;
  out[2] = p.splits;
  out[3] = p.ks;
  out[4] = p.n_ws;
  out[5] = p.smem;
  return cudaSuccess;
}

// x (B, T, fin) contiguous; a: S slots of (r, fin), slot s's at a + s *
// a_stride elements; b: S slots of (fout, r) at b_stride; slots: (B,) int32
// slot of each request, or null (then S == B and request i reads slot i);
// out (B, T, fout) contiguous at x's dtype; ws: at least the plan's n_ws
// floats (tt_lora_plan).  shape: the 10 integers B, T, fin, fout, r, S,
// a_stride, b_stride, x_dtype, f_dtype; dtype codes 0 = float32, 1 =
// float16, 2 = bfloat16 (x_dtype for x and out, f_dtype for a and b).
// vec: every row start of x, a and b is 16-byte aligned.
extern "C" int tt_lora_delta(const void* x, const void* a, const void* b, const void* slots,
                             void* out, void* ws, const long long* shape, int vec, float scaling,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long B = shape[0], T = shape[1], fin = shape[2], fout = shape[3], r = shape[4];
  const int x_dtype = static_cast<int>(shape[8]), f_dtype = static_cast<int>(shape[9]);
  if (B == 0 || T == 0 || fout == 0) return cudaSuccess;
  if (fin < 1 || r < 1 || shape[5] < 1 || x_dtype < 0 || x_dtype > 2) return cudaErrorInvalidValue;
  const Plan plan = plan_of(B, T, fin, r, x_dtype);
  if (plan.smem > kMaxSmem) return cudaErrorInvalidValue;
  const Args p{x, a, b, static_cast<const int*>(slots), out, static_cast<float*>(ws),
               static_cast<int>(B), static_cast<int>(T), static_cast<int>(fin),
               static_cast<int>(fout), static_cast<int>(r), static_cast<int>(shape[5]), shape[6],
               shape[7], plan.splits, plan.ks, vec, scaling};
  return tt::by_float(x_dtype, [&](auto tx) {
    return tt::by_float(f_dtype, [&](auto tf) -> cudaError_t {
      using TX = decltype(tx);
      using TF = decltype(tf);
      if constexpr (!std::is_same<TX, float>::value) {
        if (plan.mma) return launch_mma<TX, TF>(p, s);
      }
      switch (plan.rows) {
        case 1: return launch_fma<TX, TF, 1>(p, s);
        case 8: return launch_fma<TX, TF, 8>(p, s);
        default: return launch_fma<TX, TF, 16>(p, s);
      }
    });
  });
}
