// Helpers shared by the port's CUDA sources: the Pallas kernels' mask value,
// the float conversions of the element types the kernels take, and the
// int8 / fp8-e4m3 storage of quantized KV arenas (serving/quant.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tt {

constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e38);

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x / d rounded to nearest even, as the IEEE division rounds it, given
// inv = 1/d rounded to nearest (__frcp_rn(d)): Markstein's correction of the
// product x * inv by its exact residual, two FMAs in place of a division's
// subroutine (for the finite, normal quotients of attention scores).
__device__ __forceinline__ float div_rn(float x, float d, float inv) {
  const float q = __fmul_rn(x, inv);
  return __fmaf_rn(__fmaf_rn(-q, d, x), inv, q);
}

// the value x holds after a cast to T (round to nearest even)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// One byte of float8_e4m3fn storage (a distinct type, so templates can tell
// it from int8 and from raw bytes).
struct fp8_e4m3 {
  uint8_t bits;
};

template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float to_f<fp8_e4m3>(fp8_e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.bits, __NV_E4M3)));  // exact
}

// Quantized storage types carry a float32 scale per (block, layer, group,
// slot); float storage types carry none.
template <typename T> struct quantized {
  static constexpr bool value = false;
};
template <> struct quantized<int8_t> {
  static constexpr bool value = true;
};
template <> struct quantized<fp8_e4m3> {
  static constexpr bool value = true;
};

// One arena element as the Pallas kernels load it before the cast to the
// query dtype: float storage as it is; quantized storage dequantized,
// f32(x) * scale rounded to the compute dtype TC (pallasex.py:1094-1098).
template <typename TS, typename TC>
__device__ __forceinline__ float load_kv(TS x, float scale) {
  if constexpr (quantized<TS>::value) {
    return round_to<TC>(__fmul_rn(to_f<TS>(x), scale));
  } else {
    return to_f<TS>(x);
  }
}

// Four quantized storage values (the bytes of w, lowest first) dequantized,
// f32(x) * scale, exactly as load_kv multiplies them, with few conversion
// instructions (the slow ones): int8 x as 2^23 + (x + 128) - (2^23 + 128),
// built from its biased byte by a byte permute; e4m3 two bytes to two
// halves per conversion (exact), then to f32.
template <typename TS>
__device__ __forceinline__ void dequant4(uint32_t w, float scale, float (&v)[4]) {
  if constexpr (std::is_same<TS, int8_t>::value) {
    const uint32_t biased = w ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __fmul_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650u | k)) - 8388736.f,
                       scale);
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> (16 * k)), __NV_E4M3);
      const float2 f = __half22float2(__half2(h));
      v[2 * k] = __fmul_rn(f.x, scale);
      v[2 * k + 1] = __fmul_rn(f.y, scale);
    }
  }
}

// y = x / scale, already an IEEE quotient, into storage: int8 rounds half
// to even and clips to +-127 (jnp.round, jnp.clip); fp8 rounds to nearest
// even, saturating (|y| stays within 448 (1 + eps) under absmax scaling,
// where this agrees with ml_dtypes' and PyTorch's casts).
template <typename TS> __device__ __forceinline__ TS quantize(float y);
template <> __device__ __forceinline__ int8_t quantize<int8_t>(float y) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f));
}
template <> __device__ __forceinline__ fp8_e4m3 quantize<fp8_e4m3>(float y) {
  return fp8_e4m3{static_cast<uint8_t>(__nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3))};
}

// Eight quotients y into storage at once, bit for bit as quantize<TS> stores
// each: the stored bytes packed in w (the first value in the lowest byte)
// and the stored values as float in q, for the error sums.  Built to spare
// the card's conversion units (a quarter of the other pipes' rate), which
// quantize<TS> and to_f<TS> per value would keep busy: int8 clamps y to
// +-127 first (the clamp and rintf commute at integer bounds; a NaN clamps
// to -127 either way) and rounds half to even by adding 1.5 * 2^23, whose
// sum holds the integer in its low bits (exact for |y| < 2^22); fp8 converts
// two values per instruction, and back.
template <typename TS>
__device__ __forceinline__ void quantize8(const float (&y)[8], float (&q)[8], uint32_t (&w)[2]);
template <>
__device__ __forceinline__ void quantize8<int8_t>(const float (&y)[8], float (&q)[8],
                                                  uint32_t (&w)[2]) {
  constexpr float kRound = 12582912.f;          // 1.5 * 2^23
  w[0] = w[1] = 0u;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float r = __fadd_rn(fminf(fmaxf(y[e], -127.f), 127.f), kRound);
    q[e] = __fsub_rn(r, kRound);
    w[e >> 2] |= (__float_as_uint(r) & 0xffu) << (8 * (e & 3));
  }
}
template <>
__device__ __forceinline__ void quantize8<fp8_e4m3>(const float (&y)[8], float (&q)[8],
                                                    uint32_t (&w)[2]) {
  w[0] = w[1] = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_fp8x2_storage_t b = __nv_cvt_float2_to_fp8x2(make_float2(y[2 * k], y[2 * k + 1]),
                                                           __NV_SATFINITE, __NV_E4M3);
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(b, __NV_E4M3)));
    q[2 * k] = f.x;
    q[2 * k + 1] = f.y;
    w[k >> 1] |= static_cast<uint32_t>(b) << (16 * (k & 1));
  }
}

// The absmax scale of one slot-head (serving/quant.py quantize_kv): 1 for
// an all-zero row, else amax * f32(1/qmax), the multiply the reference's
// programs compile its division by the constant qmax into.
__device__ __forceinline__ float absmax_scale(float amax, float inv_qmax) {
  return amax == 0.f ? 1.f : __fmul_rn(amax, inv_qmax);
}

// The quantizing writes' loads and stores, 8 values of a slot-head at a
// time (the fused chunk and token writes share them).
template <typename TV>
struct Raw8 {                      // 8 values of TV as loaded: 16 bytes (32 for float32)
  uint4 w[sizeof(TV) / 2];
};

template <typename TV>
__device__ __forceinline__ Raw8<TV> load_raw8(const TV* x) {
  Raw8<TV> r;
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(TV)) / 2; ++k)
    r.w[k] = reinterpret_cast<const uint4*>(x)[k];
  return r;
}

template <typename TV>
__device__ __forceinline__ void unpack8(const Raw8<TV>& r, float (&v)[8]) {
  const TV* e8 = reinterpret_cast<const TV*>(r.w);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = to_f<TV>(e8[e]);
}

// 8 values from piece d0 of a slot-head as float: one 16-byte load (two for
// float32) when VEC (hs % 8 == 0, the base 16-byte aligned), else element by
// element; values at or past hs read 0.
template <typename TV, bool VEC>
__device__ __forceinline__ void load8(const TV* x, int d0, int hs, float (&v)[8]) {
  if constexpr (VEC) {
    if (d0 >= hs) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      return;
    }
    unpack8<TV>(load_raw8<TV>(x + d0), v);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = d0 + e < hs ? to_f<TV>(x[d0 + e]) : 0.f;
  }
}

// Quantizes the 8 values of piece d0 (x / scale, an IEEE quotient, into TS,
// bit for bit as quantize<TS> stores it) and stores them: one 8-byte store
// when VEC (quantize8, eight at once; dst 8-byte aligned), else byte by
// byte; adds |f32(q) * scale - x| and |x| of the values below hs to the sums
// (a caller that keeps no sums passes locals it never reads).
template <typename TS, bool VEC>
__device__ __forceinline__ void store_q8(TS* dst, int d0, int hs, const float (&v)[8],
                                         float scale, float& e_err, float& e_abs) {
  if (d0 >= hs) return;
  if constexpr (VEC) {
    float y[8], q[8];
    uint32_t w[2];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = __fdiv_rn(v[e], scale);
    quantize8<TS>(y, q, w);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      e_err += fabsf(__fmul_rn(q[e], scale) - v[e]);
      e_abs += fabsf(v[e]);
    }
    *reinterpret_cast<uint2*>(dst + d0) = make_uint2(w[0], w[1]);
  } else {
    for (int e = 0; e < 8 && d0 + e < hs; ++e) {
      const TS q = quantize<TS>(__fdiv_rn(v[e], scale));
      e_err += fabsf(__fmul_rn(to_f<TS>(q), scale) - v[e]);
      e_abs += fabsf(v[e]);
      dst[d0 + e] = q;
    }
  }
}

// D (16 x 8) += A (16 x 16) . B (16 x 8), mma.sync on T operands (bf16 or f16),
// f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// Host-side dispatch on the wrappers' dtype codes: f(tag) is called with a
// value of the element type the code names (0 float32, 1 float16,
// 2 bfloat16; storage codes add 3 int8 and 4 float8_e4m3fn).
template <typename F> cudaError_t by_float(int code, F&& f) {
  switch (code) {
    case 0: return f(float{});
    case 1: return f(__half{});
    case 2: return f(__nv_bfloat16{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F> cudaError_t by_storage(int code, F&& f) {
  switch (code) {
    case 3: return f(int8_t{});
    case 4: return f(fp8_e4m3{});
    default: return by_float(code, f);
  }
}

// Whether an arena of storage TS may go with fresh K/V of type TC: float
// storage is the compute type itself; quantized storage goes with any.
template <typename TS, typename TC> constexpr bool kv_pair_ok() {
  return quantized<TS>::value || std::is_same<TS, TC>::value;
}

}  // namespace tt
