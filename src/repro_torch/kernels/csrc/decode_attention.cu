// Ragged flash-decode for Hopper (sm_90a): a single-pass kernel and a
// two-phase split-K kernel, with a plain C interface loaded via ctypes.
//
// Replaces
//   decode_attention_tpu        (src/repro/kernels/decode_attention.py,
//                                _decode_kernel)
//   decode_attention_splitk_tpu (src/repro/kernels/decode_attention.py,
//                                _splitk_partial_kernel +
//                                _splitk_combine_kernel)
//
// Contract (as the TPU kernels): q (B, T, H, D), caches (B, S, KV, D) -- the
// MODEL layout, read in place through strides, so no cache is transposed or
// copied.  Slot b's query row t sits at absolute position pos[b] + t and
// attends keys kpos <= pos[b] + t (and pos[b] + t - kpos < window when
// window > 0).  Query head h reads KV head h / G (GQA).  An inactive slot
// (active[b] == 0) writes zeros.  The online softmax state (m, l, acc) is
// f32; q and k are upcast to f32, the scale is applied after the dot, and
// p is rounded to v's dtype before the PV product.  Rows fully masked in a
// loaded tile add exactly 0 (mask-gated exp).  The denominator is guarded
// with max(l, 1e-30).
//
// What bounds it on an H100: device-memory bytes.  Decode reads the live
// K/V prefix once, 2 * KV * D * bytes * sum_b(pos_b + 1) per layer, and
// does ~2 * G * T flops per K/V element -- far below the card's
// ops-per-byte balance point.
//
// What the design does about it:
//   * one CTA per (slot b, KV head j) -- per (b, j, split) for split-K --
//     serving all G * T query rows of that KV head, so each K/V byte is
//     read from device memory once (the TPU grid (b, h, kv_block) re-reads
//     K/V once per query head);
//   * loop bounds come from pos and window: tiles past pos[b] + T - 1 or
//     wholly before the window are never loaded, inactive slots load none;
//   * 32-key tiles are staged in shared memory with 16-byte vector loads,
//     the next tile's loads issued into registers before this tile's math
//     (a two-stage register pipeline);
//   * split-K spreads one slot's long prefix over num_splits CTAs so that
//     few slots still put enough loads in flight; a small combine kernel
//     (one CTA per (b, h)) merges the partials with exp(m_i - m*).
// Not yet done (later work): deeper cp.async / TMA rings, more CTAs per
// slot when few slots are live, and wgmma for the G*T x 32 score tile.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TK = 32;        // keys per tile (one per lane in the softmax)
constexpr int MAX_ROWS = 16;  // G * T query rows a CTA serves
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
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float* o_part;  // (B, H, ns, D) split-K partial accumulators
  float* m_part;  // (B, H, ns)
  float* l_part;  // (B, H, ns)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// s0/s1 += one 16-byte chunk of a key row (4 f32 or 8 bf16) . the matching
// f32 query elements (two accumulators shorten the dependent FMA chain).
template <typename TKV>
__device__ __forceinline__ void dot_chunk(const uint4* kc, const float* q,
                                          float& s0, float& s1);
template <>
__device__ __forceinline__ void dot_chunk<float>(const uint4* kc,
                                                 const float* q, float& s0,
                                                 float& s1) {
  const float4 k = *reinterpret_cast<const float4*>(kc);
  const float4 a = *reinterpret_cast<const float4*>(q);
  s0 = fmaf(a.x, k.x, s0);
  s1 = fmaf(a.y, k.y, s1);
  s0 = fmaf(a.z, k.z, s0);
  s1 = fmaf(a.w, k.w, s1);
}
template <>
__device__ __forceinline__ void dot_chunk<__nv_bfloat16>(const uint4* kc,
                                                         const float* q,
                                                         float& s0,
                                                         float& s1) {
  const uint4 raw = *kc;
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 a = *reinterpret_cast<const float4*>(q);
  const float4 b = *reinterpret_cast<const float4*>(q + 4);
  const float2 k0 = __bfloat1622float2(k2[0]), k1 = __bfloat1622float2(k2[1]);
  const float2 k2f = __bfloat1622float2(k2[2]);
  const float2 k3 = __bfloat1622float2(k2[3]);
  s0 = fmaf(a.x, k0.x, s0);
  s1 = fmaf(a.y, k0.y, s1);
  s0 = fmaf(a.z, k1.x, s0);
  s1 = fmaf(a.w, k1.y, s1);
  s0 = fmaf(b.x, k2f.x, s0);
  s1 = fmaf(b.y, k2f.y, s1);
  s0 = fmaf(b.z, k3.x, s0);
  s1 = fmaf(b.w, k3.y, s1);
}

// Stages keys [k0, k0 + TK) of one (slot, KV head) with 16-byte loads:
// load() issues every load of the tile into registers at once (so a whole
// tile is in flight), store() moves them to shared memory.  Keys at or past
// kend are zero-filled (and masked later).
template <typename TKV, int D>
struct TileLoader {
  static constexpr int VEC = 16 / sizeof(TKV);
  static constexpr int VPR = D / VEC;      // 16-byte vectors per key row
  static constexpr int N = TK * VPR / D;   // vectors per thread per tensor
  uint4 k[N], v[N];

  __device__ __forceinline__ void load(const TKV* kb, const TKV* vb,
                                       long long k_ss, long long v_ss, int k0,
                                       int kend) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * D;
      const int kk = idx / VPR, c = idx - kk * VPR;
      k[i] = v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + kk < kend) {
        k[i] = *reinterpret_cast<const uint4*>(
            kb + (long long)(k0 + kk) * k_ss + c * VEC);
        v[i] = *reinterpret_cast<const uint4*>(
            vb + (long long)(k0 + kk) * v_ss + c * VEC);
      }
    }
  }

  __device__ __forceinline__ void store(TKV (*Ks)[D], TKV (*Vs)[D]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * D;
      const int kk = idx / VPR, c = idx - kk * VPR;
      *reinterpret_cast<uint4*>(&Ks[kk][c * VEC]) = k[i];
      *reinterpret_cast<uint4*>(&Vs[kk][c * VEC]) = v[i];
    }
  }
};

// One CTA per (KV head j, slot b[, split]); D threads, thread d owns output
// column d of every query row.  SPLIT=false writes the normalised output;
// SPLIT=true writes this split's unnormalised (acc, m, l).
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

  const TKV* kb = static_cast<const TKV*>(p.k) + b * p.k_sb + j * p.k_sh;
  const TKV* vb = static_cast<const TKV*>(p.v) + b * p.v_sb + j * p.v_sh;
  const float scale = 1.0f / sqrtf((float)D);
  __syncthreads();

  const int kbeg = lo < hi ? (lo / TK) * TK : hi;  // empty range: no tile
  TileLoader<TKV, D> tile;
  if (kbeg < hi) tile.load(kb, vb, p.k_ss, p.v_ss, kbeg, hi);
  for (int k0 = kbeg; k0 < hi; k0 += TK) {
    tile.store(Ks, Vs);
    __syncthreads();
    // the next tile's loads fly while this tile's math runs
    if (k0 + TK < hi) tile.load(kb, vb, p.k_ss, p.v_ss, k0 + TK, hi);
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
      const float s = ok ? ps[r][lane] : NEG_INF;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float pr = ok ? expf(s - m_new) : 0.f;
      const float tot = warp_sum(pr);
      ps[r][lane] = to_f(from_f<TKV>(pr));  // p in v's dtype for PV
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + tot;
        m_s[r] = m_new;
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

template <typename TQ, typename TKV, bool SPLIT>
cudaError_t launch_typed(const Params& p, int D, cudaStream_t st) {
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
cudaError_t launch(const Params& p, int D, int q_dtype, int kv_dtype,
                   cudaStream_t st) {
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_typed<float, float, SPLIT>(p, D, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_typed<float, __nv_bfloat16, SPLIT>(p, D, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_typed<__nv_bfloat16, float, SPLIT>(p, D, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16, SPLIT>(p, D, st);
  return cudaErrorInvalidValue;
}

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

// Strides are in elements: q_strides = (batch, token, head), cache strides
// = (batch, seq, kv head); the last dimension must be contiguous.  `out`
// is a contiguous (B, T, H, D) tensor of q's dtype.  Returns the launch's
// cudaError_t (0 = success).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, void* out, const int* pos,
    const int* active, int B, int T, int H, int KV, int S, int D, int window,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, int q_dtype, int kv_dtype, void* stream) {
  Params p = make_params(q, k, v, out, pos, active, B, T, H, KV, S, window,
                         q_strides, k_strides, v_strides);
  return (int)launch<false>(p, D, q_dtype, kv_dtype, (cudaStream_t)stream);
}

// Two-phase split-K (T = 1, S % num_splits == 0).  o_part (B, H, ns, D),
// m_part and l_part (B, H, ns) are f32 scratch allocated by the caller.
extern "C" int decode_attention_splitk_fwd(
    const void* q, const void* k, const void* v, void* out, const int* pos,
    const int* active, int B, int H, int KV, int S, int D, int window,
    int num_splits, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, float* o_part, float* m_part, float* l_part,
    int q_dtype, int kv_dtype, void* stream) {
  Params p = make_params(q, k, v, out, pos, active, B, 1, H, KV, S, window,
                         q_strides, k_strides, v_strides);
  p.num_splits = num_splits;
  p.o_part = o_part;
  p.m_part = m_part;
  p.l_part = l_part;
  return (int)launch<true>(p, D, q_dtype, kv_dtype, (cudaStream_t)stream);
}
