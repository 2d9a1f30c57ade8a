// Pieces shared by the attention kernels over a dense cache
// (decode_attention.cu, flash_attention.cu) and over the paged pool
// (paged_attention.cu): element conversions, warp reductions, the 16-byte
// score dot, 16-byte cp.async, the key-row addressing (dense strides or a
// page-table lookup), the key-tile loader, the online-softmax step of one
// row over one key tile, and the dense ragged decode kernel with its
// split-K combine kernel.  The many-row kernel of the full-sequence flash
// attention and the paged chunked prefill is in many_row_attention.cuh; the
// paged decode kernel is in paged_decode.cuh.
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

constexpr int TK = 32;        // keys per tile (one per lane in the softmax)
constexpr int MAX_ROWS = 16;  // G * T query rows a decode CTA serves
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* pos;
  const int* active;
  int B, T, H, KV, S, window, num_splits;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;  // (batch, seq, kv head) strides
  long long v_sb, v_ss, v_sh;
  float* o_part;  // (B, H, ns, D) split-K partial accumulators
  float* m_part;  // (B, H, ns)
  float* l_part;  // (B, H, ns)
};

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One 16-byte chunk of a key row (4 f32 or 8 bf16) as f32 values.
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

// s0/s1 += one 16-byte chunk of a key row . the matching f32 query
// elements (two accumulators shorten the dependent FMA chain).
template <typename TKV>
__device__ __forceinline__ void dot_chunk(const uint4* kc, const float* q,
                                          float& s0, float& s1) {
  float k[Chunk<TKV>::N];
  Chunk<TKV>::get(*kc, k);
#pragma unroll
  for (int i = 0; i < Chunk<TKV>::N; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(q + i);
    s0 = fmaf(a.x, k[i], s0);
    s1 = fmaf(a.y, k[i + 1], s1);
    s0 = fmaf(a.z, k[i + 2], s0);
    s1 = fmaf(a.w, k[i + 3], s1);
  }
}

// 16 bytes from global to shared memory, bypassing L1 (cp.async.cg); with
// fill = false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0));
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

// Stages keys [k0, k0 + TK) of one (slot, KV head) with 16-byte loads
// spread over NT threads: load() issues every load of the tile into
// registers at once (so a whole tile is in flight), store() moves them to
// shared memory tiles of row stride LD elements.  Keys outside [klo, khi)
// are zero-filled without touching memory (and masked later), so no row
// past the last live key and none wholly before the window is read.
template <typename TKV, int D, int NT>
struct TileLoader {
  static constexpr int VEC = 16 / sizeof(TKV);
  static constexpr int VPR = D / VEC;      // 16-byte vectors per key row
  static constexpr int N = TK * VPR / NT;  // vectors per thread per tensor
  static_assert(N * NT == TK * VPR, "tile must split evenly over threads");
  uint4 k[N], v[N];

  template <typename Rows>
  __device__ __forceinline__ void load(const Rows& krows, const Rows& vrows,
                                       int k0, int klo, int khi) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int kk = idx / VPR, c = idx - kk * VPR;
      const int kpos = k0 + kk;
      k[i] = v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (kpos >= klo && kpos < khi) {
        k[i] = *reinterpret_cast<const uint4*>(krows(kpos) + c * VEC);
        v[i] = *reinterpret_cast<const uint4*>(vrows(kpos) + c * VEC);
      }
    }
  }

  template <int LD>
  __device__ __forceinline__ void store(TKV* Ks, TKV* Vs) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int kk = idx / VPR, c = idx - kk * VPR;
      *reinterpret_cast<uint4*>(Ks + kk * LD + c * VEC) = k[i];
      *reinterpret_cast<uint4*>(Vs + kk * LD + c * VEC) = v[i];
    }
  }
};

// Online-softmax step of one query row over one key tile, run by one warp
// with lane i holding the row's (scaled) score for key k0 + i and `ok`
// whether the row may see it.  Updates the row's running max m and sum l
// and returns p = exp(s - m_new) rounded to v's dtype (0 where !ok);
// `alpha` = exp(m_old - m_new) rescales the row's accumulator.  l sums the
// unrounded p, as the TPU kernel does.
template <typename TKV>
__device__ __forceinline__ float softmax_step(float s, bool ok, float& m,
                                              float& l, float& alpha) {
  const float sv = ok ? s : NEG_INF;
  const float m_new = fmaxf(m, warp_max(sv));
  const float pr = ok ? expf(sv - m_new) : 0.f;
  alpha = expf(m - m_new);
  l = l * alpha + warp_sum(pr);
  m = m_new;
  return to_f(from_f<TKV>(pr));
}

// Ragged decode over a dense cache.  One CTA per (KV head j, slot b[,
// split]); D threads, thread d owns output column d of every query row.
// SPLIT=false writes the normalised output; SPLIT=true writes this split's
// unnormalised (acc, m, l).  A split owns keys [isp * S/ns, (isp + 1) *
// S/ns).
template <typename TQ, typename TKV, int D, bool SPLIT>
__global__ void __launch_bounds__(D) decode_kernel(Params p) {
  constexpr int NW = D / 32;
  const int j = blockIdx.x, b = blockIdx.y, isp = blockIdx.z;
  const int G = p.H / p.KV, T = p.T, R = G * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int VEC = 16 / sizeof(TKV);  // elements per 16-byte chunk
  // lanes per score dot: the most of 1, 2, 4 that R * TK * P threads fill
  const int P = R * TK * 4 <= D ? 4 : (R * TK * 2 <= D ? 2 : 1);
  const int CPP = D / VEC / P;  // chunks per lane per dot (a power of 2)

  __shared__ __align__(16) TKV Ks[TK][D];
  __shared__ __align__(16) TKV Vs[TK][D];
  __shared__ __align__(16) float qs[MAX_ROWS][D];
  __shared__ float ps[MAX_ROWS][TK];
  __shared__ float m_s[MAX_ROWS], l_s[MAX_ROWS], alpha_s[MAX_ROWS];

  const int pos = p.pos[b];
  // keys this CTA may need: [lo, hi).  Row 0 has the lowest window bound.
  int lo = 0, hi = min(p.S, pos + T);
  if (p.window) lo = max(lo, pos - p.window + 1);
  if (SPLIT) {
    const int L = p.S / p.num_splits;
    lo = max(lo, isp * L);
    hi = min(hi, (isp + 1) * L);
  }
  if (p.active[b] == 0) hi = lo;  // inactive: no tile, output 0

  const TQ* q = static_cast<const TQ*>(p.q) + b * p.q_sb;
  for (int idx = tid; idx < R * D; idx += D) {
    const int r = idx / D, d = idx - r * D;
    const int g = r / T, t = r - g * T;
    qs[r][d] = to_f(q[t * p.q_st + (j * G + g) * p.q_sh + d]);
  }
  if (tid < R) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAX_ROWS];
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0.f;

  KeyRows<TKV, false> krows, vrows;
  krows.s_row = p.k_ss;
  vrows.s_row = p.v_ss;
  krows.base = static_cast<const TKV*>(p.k) + j * p.k_sh + b * p.k_sb;
  vrows.base = static_cast<const TKV*>(p.v) + j * p.v_sh + b * p.v_sb;
  const float scale = 1.0f / sqrtf((float)D);
  __syncthreads();

  const int kbeg = lo < hi ? (lo / TK) * TK : hi;  // empty range: no tile
  TileLoader<TKV, D, D> tile;
  if (kbeg < hi) tile.load(krows, vrows, kbeg, lo, hi);
  for (int k0 = kbeg; k0 < hi; k0 += TK) {
    tile.template store<D>(&Ks[0][0], &Vs[0][0]);
    __syncthreads();
    // the next tile's loads fly while this tile's math runs
    if (k0 + TK < hi) tile.load(krows, vrows, k0 + TK, lo, hi);
    // scores: P adjacent lanes share one (row, key) dot, each over 1/P of
    // the 16-byte chunks of the row (P fills the CTA when G*T is small);
    // the chunk order is rotated per key and part so that the lanes of a
    // quarter-warp read 8 different 16-byte bank groups
    for (int idx = tid; idx < R * TK * P; idx += D) {
      const int dot = idx / P, part = idx - dot * P;
      const int r = dot / TK, k = dot - r * TK;
      const int shift = part * (8 / P);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
      for (int c = 0; c < CPP; ++c) {
        const int ch = part * CPP + ((c + k + shift) & (CPP - 1));
        dot_chunk<TKV>(reinterpret_cast<const uint4*>(&Ks[k][ch * VEC]),
                       &qs[r][ch * VEC], s0, s1);
      }
      float s = s0 + s1;
      for (int o = 1; o < P; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (part == 0) ps[r][k] = s * scale;
    }
    __syncthreads();
    // online softmax: one warp per row, one lane per key
    for (int r = warp; r < R; r += NW) {
      const int qpos = pos + (r % T);
      const int kpos = k0 + lane;
      const bool ok = kpos >= lo && kpos < hi && kpos <= qpos &&
                      (p.window == 0 || qpos - kpos < p.window);
      float m = m_s[r], l = l_s[r], alpha;
      const float pr = softmax_step<TKV>(ps[r][lane], ok, m, l, alpha);
      __syncwarp();
      ps[r][lane] = pr;
      if (lane == 0) {
        alpha_s[r] = alpha;
        l_s[r] = l;
        m_s[r] = m;
      }
    }
    __syncthreads();
    // PV: thread d accumulates column d of every row
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r)
      if (r < R) acc[r] *= alpha_s[r];
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      const float vk = to_f(Vs[k][tid]);
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r)
        if (r < R) acc[r] += ps[r][k] * vk;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    if (r >= R) break;
    const int g = r / T, t = r - g * T, h = j * G + g;
    if (SPLIT) {
      const long long row = ((long long)b * p.H + h) * p.num_splits + isp;
      p.o_part[row * D + tid] = acc[r];
      if (tid == 0) {
        p.m_part[row] = m_s[r];
        p.l_part[row] = l_s[r];
      }
    } else {
      TQ* out = static_cast<TQ*>(p.out);
      const float y = acc[r] / fmaxf(l_s[r], 1e-30f);
      out[(((long long)b * T + t) * p.H + h) * D + tid] = from_f<TQ>(y);
    }
  }
}

// Phase 2 of split-K: one CTA per (query head h, slot b), thread d merges
// column d of the num_splits partials.  An empty split has m = -1e30 and
// l = 0, so it weighs exp(-1e30 - m*) = 0.
template <typename TQ, int D>
__global__ void __launch_bounds__(D) splitk_combine_kernel(Params p) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int ns = p.num_splits;
  const long long base = ((long long)b * p.H + h) * ns;
  float m_star = NEG_INF;
  for (int i = 0; i < ns; ++i) m_star = fmaxf(m_star, p.m_part[base + i]);
  float denom = 0.f, num = 0.f;
  for (int i = 0; i < ns; ++i) {
    const float a = expf(p.m_part[base + i] - m_star);
    denom += p.l_part[base + i] * a;
    num += p.o_part[(base + i) * D + d] * a;
  }
  const float y = p.active[b] ? num / fmaxf(denom, 1e-30f) : 0.f;
  static_cast<TQ*>(p.out)[((long long)b * p.H + h) * D + d] = from_f<TQ>(y);
}

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

template <typename TQ, typename TKV, bool SPLIT>
cudaError_t launch_decode_typed(const Params& p, int D, cudaStream_t st) {
  // head_dim 128 is the one width built: the served arch's (internlm2)
  // and most configs'; D is a template parameter, so another width
  // (musicgen's 64, zamba2's 80) is one more instantiation
  if (D != 128) return cudaErrorInvalidValue;
  const dim3 grid(p.KV, p.B, SPLIT ? p.num_splits : 1);
  decode_kernel<TQ, TKV, 128, SPLIT><<<grid, 128, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return err;
  splitk_combine_kernel<TQ, 128><<<dim3(p.H, p.B), 128, 0, st>>>(p);
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16
template <bool SPLIT>
cudaError_t launch_decode(const Params& p, int D, int q_dtype, int kv_dtype,
                          cudaStream_t st) {
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_decode_typed<float, float, SPLIT>(p, D, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_decode_typed<float, __nv_bfloat16, SPLIT>(p, D, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_decode_typed<__nv_bfloat16, float, SPLIT>(p, D, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_decode_typed<__nv_bfloat16, __nv_bfloat16, SPLIT>(p, D,
                                                                     st);
  return cudaErrorInvalidValue;
}

// q strides (batch, token, head) and cache strides (batch, seq, kv head),
// in elements.
Params make_params(const void* q, const void* k, const void* v, void* out,
                   const int* pos, const int* active, int B, int T, int H,
                   int KV, int S, int window, const long long* qs,
                   const long long* ks, const long long* vs) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.out = out; p.pos = pos; p.active = active;
  p.B = B; p.T = T; p.H = H; p.KV = KV; p.S = S; p.window = window;
  p.num_splits = 1;
  p.q_sb = qs[0]; p.q_st = qs[1]; p.q_sh = qs[2];
  p.k_sb = ks[0]; p.k_ss = ks[1]; p.k_sh = ks[2];
  p.v_sb = vs[0]; p.v_ss = vs[1]; p.v_sh = vs[2];
  return p;
}

}  // namespace
