// Fused cross-entropy forward for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel flash_cross_entropy of
// thunder_tpu/executors/pallasex.py (:984; _flash_ce :911, pallas_call :921,
// body _ce_kernel :832): per row of (N, V) logits, one pass of online
// logsumexp over the vocabulary plus the target's raw logit, giving
// lse = m + log(s) and loss = lse - logits[target], both float32.  The
// (N, V) matrix is read once and no (N, V) log-probability exists.
//
// What bounds it on an H100: bytes.  Each logit is read once and costs a
// few flops and one expf; at Llama-3-8B's training shape (N = 2048,
// V = 128256, float32) that is 1.05 GB, ~0.31 ms at 3.35 TB/s.
//
// Design (simple and right first):
//   * One block of kThreads threads per row.  The TPU kernel walks vocab
//     tiles along a sequential grid axis carrying (m, s, picked) in VMEM
//     scratch; here each thread walks the row with a stride and keeps its
//     own running max m (from -0.7 * FLT_MAX, the Pallas mask value) and
//     rescaled sum s in float32, then the block merges the (m, s) pairs with
//     warp shuffles and once more through shared memory, in a fixed order
//     (deterministic from run to run).
//   * The row is read in 16-byte vectors (4 float32 or 8 bfloat16 values)
//     when V is a multiple of the vector width and the logits are 16-byte
//     aligned; the wrapper picks the width.  bf16 logits are upcast as they
//     load.
//   * The thread that meets column target[row] keeps its raw logit; the
//     block sums the picked values (one is nonzero), as the Pallas kernel
//     sums where(col == t, x, 0) over its tiles.  A target outside [0, V)
//     picks 0, as there.
//
// Numerics: a sum of exp in float32 in another order than the tile order of
// the TPU kernel, so lse agrees with the plain version to ~1e-6 relative,
// not bitwise.

#include "common.cuh"

namespace {

using tt::kMaskValue;
using tt::to_f;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// folds one logit into a thread's running (m, s)
__device__ __forceinline__ void fold(float v, float& m, float& s) {
  if (v > m) {
    s = s * expf(m - v) + 1.f;
    m = v;
  } else {
    s += expf(v - m);
  }
}

// merges (m2, s2) into (m, s)
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// VEC values of type T make one 16-byte load; VEC == 1 reads scalars
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
flash_ce_kernel(const T* __restrict__ logits, const int* __restrict__ target,
                float* __restrict__ loss, float* __restrict__ lse, int V) {
  const int row = blockIdx.x;
  const T* x = logits + static_cast<size_t>(row) * V;
  const int t = target[row];
  float m = kMaskValue, s = 0.f, picked = 0.f;
  if constexpr (VEC > 1) {
    static_assert(VEC * sizeof(T) == 16, "one 16-byte load per step");
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const int nvec = V / VEC;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 raw = __ldg(xv + i);
      const T* val = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = to_f<T>(val[j]);
        fold(v, m, s);
        if (i * VEC + j == t) picked += v;
      }
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads) {
      const float v = to_f<T>(x[c]);
      fold(v, m, s);
      if (c == t) picked += v;
    }
  }
  // warp, then block: butterfly merges in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    picked += __shfl_xor_sync(0xffffffffu, picked, off);
    merge(m, s, m2, s2);
  }
  __shared__ float sm_m[kWarps], sm_s[kWarps], sm_p[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_s[warp] = s;
    sm_p[warp] = picked;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? sm_m[lane] : kMaskValue;
    s = lane < kWarps ? sm_s[lane] : 0.f;
    picked = lane < kWarps ? sm_p[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      picked += __shfl_xor_sync(0xffffffffu, picked, off);
      merge(m, s, m2, s2);
    }
    if (lane == 0) {
      const float l = m + logf(s);
      lse[row] = l;
      loss[row] = l - picked;
    }
  }
}

template <typename T>
cudaError_t launch_ce(const void* logits, const int* target, float* loss, float* lse, int N,
                      int V, int vec, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(logits);
  if (vec == kVec) {
    flash_ce_kernel<T, kVec><<<N, kThreads, 0, stream>>>(x, target, loss, lse, V);
  } else if (vec == 1) {
    flash_ce_kernel<T, 1><<<N, kThreads, 0, stream>>>(x, target, loss, lse, V);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// logits (N, V) contiguous, dtype 0 = float32 or 2 = bfloat16; target (N,)
// int32; loss and lse (N,) float32.  vec: 1, or the 16-byte vector width
// (4 for float32, 8 for bfloat16) when V is a multiple of it and logits is
// 16-byte aligned.
extern "C" int tt_flash_ce(const void* logits, const int* target, float* loss, float* lse,
                           int N, int V, int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 0) return cudaSuccess;
  if (V <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_ce<float>(logits, target, loss, lse, N, V, vec, s);
    case 2: return launch_ce<__nv_bfloat16>(logits, target, loss, lse, N, V, vec, s);
    default: return cudaErrorInvalidValue;
  }
}
