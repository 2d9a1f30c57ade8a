// Pieces shared by the attention kernels (decode_attention.cu,
// paged_attention.cu, flash_attention.cu) and the SSD chunk (ssd_scan.cu):
// element conversions, the loaded-value type of a K/V storage type, 16-byte
// chunks of a key row as f32, 16-, 8- and 4-byte cp.async, the key-row
// addressing of the many-row kernel (dense strides or a page-table lookup),
// 4-element row loads, 4- and 2-element stores, and the TF32 operands of
// the many-row kernel's and the SSD chunk's tensor-core products (the
// 3xTF32 split; the products themselves are wgmma_tf32.cuh's).
// The chunked decode kernel of the dense and the paged decode is in
// chunked_decode.cuh; the many-row kernel of the
// full-sequence flash attention and the paged chunked prefill is in
// many_row_attention.cuh.
//
// The decode contract (as the TPU kernels'): slot b's query row t sits at
// absolute position pos[b] + t and attends keys kpos <= pos[b] + t (and
// pos[b] + t - kpos < window when window > 0).  Query head h reads KV head
// h / G (GQA).  An inactive slot (active[b] == 0) writes zeros.  The online
// softmax state (m, l, acc) is f32; q and k are upcast to f32, the scale is
// applied after the dot, and p is rounded to v's dtype before the PV
// product.  Keys a row may not see add exactly 0 (mask-gated exp).  The
// denominator is guarded with max(l, 1e-30).
//
// Quantized paged pools (int8_t, __nv_fp8_e4m3) hold each K/V row with an
// f32 scale per (token, KV head): a value is float(x) * scale, computed as
// the row arrives, and is an f32 value from then on, so p is not rounded
// (the TPU kernel's quant branch casts p to the dequantized v's f32).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS = 16;  // G * T query rows a decode CTA serves
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The type a K/V value has once loaded: the storage type itself, or f32
// for the quantized pools (`quant`), whose values are dequantized with
// their row's scale.  p is rounded to this type before the PV product.
template <typename TKV> struct KVValue {
  using type = TKV;
  static constexpr bool quant = false;
};
template <> struct KVValue<int8_t> {
  using type = float;
  static constexpr bool quant = true;
};
template <> struct KVValue<__nv_fp8_e4m3> {
  using type = float;
  static constexpr bool quant = true;
};

// Two e4m3 values (the low byte first) as f32, exactly: e4m3 -> f16 is
// exact (cvt.rn.f16x2.e4m3x2), and so is f16 -> f32.
__device__ __forceinline__ float2 fp8x2_to_float2(unsigned short x) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(x, __NV_E4M3);
  return __half22float2(__half2(h));
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// One 16-byte chunk of a key row (4 f32, 8 bf16) as f32 values.
template <typename TKV> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void get(const uint4& raw, float* f) {
    const float4 k = *reinterpret_cast<const float4*>(&raw);
    f[0] = k.x; f[1] = k.y; f[2] = k.z; f[3] = k.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void get(const uint4& raw, float* f) {
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(k2[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};
// The quantized pools' raw values (16 per chunk), before their scale.
template <> struct Chunk<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void get(const uint4& raw, float* f) {
    const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[4 * i] = c[i].x;
      f[4 * i + 1] = c[i].y;
      f[4 * i + 2] = c[i].z;
      f[4 * i + 3] = c[i].w;
    }
  }
};
template <> struct Chunk<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void get(const uint4& raw, float* f) {
    const unsigned short* x2 = reinterpret_cast<const unsigned short*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 x = fp8x2_to_float2(x2[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

// 16 bytes from global to shared memory, bypassing L1 (cp.async.cg); with
// fill = false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0));
}

// 8 bytes from global to shared memory (cp.async.ca: .cg copies 16 bytes
// only); with fill = false nothing is read and the 8 bytes are zeroed.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 8 : 0));
}

// 4 bytes (a scale) from global to shared memory (cp.async.ca, the only
// form of that size); with fill = false nothing is read and 0 is stored.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 4 : 0));
}

// Waits for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Closes this thread's cp.async issued since the last commit into a group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Address of key row kpos of one (slot, KV head).  Dense: the slot's stripe
// through its sequence stride.  Paged: logical page kpos / page_size is
// physical page row[kpos / page_size] of the pool, at token offset
// kpos % page_size; only rows a tile actually loads look the table up.
template <typename TKV, bool PAGED>
struct KeyRows {
  const TKV* base;      // dense: cache + b*sb + j*sh; paged: pool + j*sh
  const int* row;       // paged: the slot's page-table row
  long long s_page;     // paged: page stride
  long long s_row;      // dense: sequence stride; paged: token stride
  int page_size;

  __device__ __forceinline__ const TKV* operator()(int kpos) const {
    if (!PAGED) return base + (long long)kpos * s_row;
    const int ip = kpos / page_size;
    return base + (long long)row[ip] * s_page +
           (long long)(kpos - ip * page_size) * s_row;
  }
};

// Four consecutive elements of a row as f32.
__device__ __forceinline__ void load4(const float* v, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(v);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* v, float* f) {
  const uint2 raw = *reinterpret_cast<const uint2*>(v);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(x[0]), b = __bfloat1622float2(x[1]);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
// The quantized pools' raw values (4 bytes), before their scale.
__device__ __forceinline__ void load4(const int8_t* v, float* f) {
  const char4 c = *reinterpret_cast<const char4*>(v);
  f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
}
__device__ __forceinline__ void load4(const __nv_fp8_e4m3* v, float* f) {
  const ushort2 raw = *reinterpret_cast<const ushort2*>(v);
  const float2 a = fp8x2_to_float2(raw.x), b = fp8x2_to_float2(raw.y);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// ---- TF32 operands (the many-row kernel and the SSD chunk) --------------

// cvt.rna.tf32.f32 for finite x: round to the nearest TF32 value, ties
// away from zero.  Adding half a TF32 ulp (bit 12) to the sign-magnitude
// bits and clearing the 13 low ones does it in two integer operations;
// sm_90's cvt.rna.tf32.f32 is a sequence of about five (it also handles
// NaN and infinity, which attention inputs do not hold).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// N operand values as TF32 registers: big parts, and (SPLIT, f32 values)
// the rounded remainders.  Values that are exact in TF32 (from bf16) pass
// through unchanged.
template <int N, bool SPLIT>
struct Frag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(int i, float x) {
    if (SPLIT) {
      big[i] = tf32_rna(x);
      small[i] = tf32_rna(x - __uint_as_float(big[i]));
    } else {
      big[i] = __float_as_uint(x);
    }
  }
};

// Four consecutive f32 values to memory as f32 or bf16 (16 or 8 bytes).
__device__ __forceinline__ void store4(float* p, const float* y) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* y) {
  __nv_bfloat162 v[2] = {__floats2bfloat162_rn(y[0], y[1]),
                         __floats2bfloat162_rn(y[2], y[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
}

// Two consecutive f32 values to memory as f32 or bf16 (8 or 4 bytes).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace
