// Paged attention for Hopper (sm_90a): decode, split-K decode and fused
// chunked prefill over the shared page pool, with a plain C interface
// loaded via ctypes.
//
// Replaces
//   paged_decode_attention_tpu        (src/repro/kernels/paged_attention.py,
//                                      _paged_decode_kernel +
//                                      _accumulate_page)
//   paged_decode_attention_splitk_tpu (src/repro/kernels/paged_attention.py,
//                                      _paged_splitk_partial_kernel + the
//                                      shared _splitk_combine_kernel)
//   paged_prefill_attention_tpu       (src/repro/kernels/paged_attention.py,
//                                      _paged_prefill_kernel)
//
// Layout: the pools stay in the MODEL layout (P, page_size, KV, D) and are
// read in place through strides (the TPU wrapper's swap to
// (P, KV, page_size, D) would copy the whole pool per layer per tick).
// Logical key kpos of a slot lives in physical page
// page_idx[b, kpos / page_size] at token offset kpos % page_size; masks
// use the logical position only.  Unmapped table entries are the null
// page 0: a kernel reads the table only for keys at or before the slot's
// last query position (pos + T - 1, or the chunk's last row) and inside
// the window, so it never computes on an unmapped entry.
//
// Decode and split-K decode are the dense kernels of attention_common.cuh
// with a page-table row lookup in the tile loader (KeyRows<.., true>): one
// CTA per (slot, KV head[, split]) serving all G * T query rows.
//   Bound on an H100: device-memory bytes of the live prefix, as for the
//   dense decode kernel (2 * KV * D * bytes per live key).  Each K/V byte is
//   read once; a 32-key tile spans two 16-token pages.  Split-K split i owns
//   logical pages [i * pps, (i + 1) * pps), max_pages % ns == 0, as the
//   reference partitions the page table.
//
// Prefill: one slot's chunk of C query rows at absolute q_offset, causal
// against its own page chain (the chunk's K/V already written).
//   Bound on an H100: operations.  A chunk at q_offset does
//   4 * C * H * D * (q_offset + C / 2) flops (QK and PV) against
//   2 * KV * D * bytes * (q_offset + C) bytes of K/V: C * G / 8 to
//   C * G / 4 flops per f32 byte (64-128 at C = 256, G = 2), far above the
//   card's non-tensor f32 balance (67 TFLOP/s over 3.35 TB/s = 20).
//   Design: one CTA per (KV head, tile of QT = 64 / G query positions),
//   serving all G heads of those positions (64 query rows), so each K/V
//   tile is read once per 64 rows and fed to 64 x 32 score dots.  Eight
//   warps own eight rows each for the whole loop: a lane computes its key's
//   score for the warp's rows, runs the online softmax across the warp with
//   shuffles, and accumulates 4 output columns of those rows, so only the
//   K/V tile loads need the whole CTA.  The key loop ends at the tile's last
//   position (the causal skip) and starts at the window's first tile.
//   q (f32) and the K/V tiles sit in dynamic shared memory (65 KiB with an
//   f32 pool, 49 KiB with bf16: past the 48 KiB static limit); K/V rows
//   are padded by 16 bytes so a quarter-warp's 16-byte reads of 8 key rows
//   hit distinct banks.
//   CUDA-core FMAs for now; mma.sync / wgmma for the 64 x 32 score and PV
//   tiles is later work.

#include "attention_common.cuh"

namespace {

constexpr int PF_ROWS = 64;                   // query rows per prefill CTA
constexpr int PF_WARPS = 8;
constexpr int PF_THREADS = 32 * PF_WARPS;
constexpr int PF_RPW = PF_ROWS / PF_WARPS;    // rows per warp

struct PrefillParams {
  const void* q;  // (1, C, H, D)
  const void* k;  // pools (P, page_size, KV, D)
  const void* v;
  void* out;      // contiguous (1, C, H, D), q's dtype
  const int* page_row;  // the slot's page-table row (max_pages,)
  int C, H, KV, q_offset, window, page_size;
  long long q_st, q_sh;
  long long k_sp, k_ss, k_sh;
  long long v_sp, v_ss, v_sh;
};

// Four consecutive elements of a V row as f32.
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

template <typename TKV, int D>
constexpr int prefill_smem_bytes() {
  return PF_ROWS * D * (int)sizeof(float) +
         2 * TK * (D + 16 / (int)sizeof(TKV)) * (int)sizeof(TKV);
}

// Query row r of a CTA is chunk row t0 + r / G, query head j * G + r % G.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(PF_THREADS)
    paged_prefill_kernel(PrefillParams p) {
  static_assert(D == 32 * 4, "a lane owns 4 output columns");
  constexpr int VEC = 16 / sizeof(TKV);
  constexpr int LD = D + VEC;  // padded K/V row, in elements
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);          // [PF_ROWS][D]
  TKV* Ks = reinterpret_cast<TKV*>(qs + PF_ROWS * D);  // [TK][LD]
  TKV* Vs = Ks + TK * LD;                              // [TK][LD]

  const int j = blockIdx.x;
  const int G = p.H / p.KV, QT = PF_ROWS / G;
  const int t0 = blockIdx.y * QT;
  const int nt = min(QT, p.C - t0);  // chunk rows this CTA holds
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const TQ* q = static_cast<const TQ*>(p.q);
  for (int idx = tid; idx < PF_ROWS * D; idx += PF_THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int t = r / G, g = r - t * G;
    qs[idx] = t < nt ? to_f(q[(t0 + t) * p.q_st + (j * G + g) * p.q_sh + d])
                     : 0.f;
  }
  // keys this CTA may need: [lo, hi), ending at its last row (causal skip)
  const int qfirst = p.q_offset + t0;
  const int hi = qfirst + nt;
  const int lo = p.window ? max(0, qfirst - p.window + 1) : 0;

  float m[PF_RPW], l[PF_RPW], acc[PF_RPW][4];
#pragma unroll
  for (int i = 0; i < PF_RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }

  KeyRows<TKV, true> krows, vrows;
  krows.row = vrows.row = p.page_row;
  krows.page_size = vrows.page_size = p.page_size;
  krows.base = static_cast<const TKV*>(p.k) + j * p.k_sh;
  vrows.base = static_cast<const TKV*>(p.v) + j * p.v_sh;
  krows.s_page = p.k_sp;
  vrows.s_page = p.v_sp;
  krows.s_row = p.k_ss;
  vrows.s_row = p.v_ss;
  const float scale = 1.0f / sqrtf((float)D);
  __syncthreads();

  const int kbeg = (lo / TK) * TK;
  TileLoader<TKV, D, PF_THREADS> tile;
  tile.load(krows, vrows, kbeg, lo, hi);
  for (int k0 = kbeg; k0 < hi; k0 += TK) {
    tile.template store<LD>(Ks, Vs);
    __syncthreads();
    // the next tile's loads fly while this tile's math runs
    if (k0 + TK < hi) tile.load(krows, vrows, k0 + TK, lo, hi);

    // scores: lane i holds key k0 + i against each of the warp's rows
    float s[PF_RPW];
#pragma unroll
    for (int i = 0; i < PF_RPW; ++i) s[i] = 0.f;
    const TKV* krow = Ks + lane * LD;
#pragma unroll 2
    for (int c = 0; c < D / VEC; ++c) {
      float kf[VEC];
      Chunk<TKV>::get(*reinterpret_cast<const uint4*>(krow + c * VEC), kf);
#pragma unroll
      for (int i = 0; i < PF_RPW; ++i) {
        const float* qr = qs + (warp * PF_RPW + i) * D + c * VEC;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + e);
          s[i] = fmaf(a.x, kf[e], s[i]);
          s[i] = fmaf(a.y, kf[e + 1], s[i]);
          s[i] = fmaf(a.z, kf[e + 2], s[i]);
          s[i] = fmaf(a.w, kf[e + 3], s[i]);
        }
      }
    }

    // online softmax, one row at a time across the warp
    const int kpos = k0 + lane;
    float pr[PF_RPW];
#pragma unroll
    for (int i = 0; i < PF_RPW; ++i) {
      const int t = (warp * PF_RPW + i) / G;
      const int qpos = qfirst + t;
      const bool ok = t < nt && kpos >= lo && kpos <= qpos &&
                      (p.window == 0 || qpos - kpos < p.window);
      float alpha;
      pr[i] = softmax_step<TKV>(s[i] * scale, ok, m[i], l[i], alpha);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
    }

    // PV: lane owns output columns 4 * lane .. 4 * lane + 3
#pragma unroll 4
    for (int k = 0; k < TK; ++k) {
      float vf[4];
      load4(Vs + k * LD + lane * 4, vf);
#pragma unroll
      for (int i = 0; i < PF_RPW; ++i) {
        const float pk = __shfl_sync(0xffffffffu, pr[i], k);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(pk, vf[e], acc[i][e]);
      }
    }
    __syncthreads();
  }

  TQ* out = static_cast<TQ*>(p.out);
#pragma unroll
  for (int i = 0; i < PF_RPW; ++i) {
    const int r = warp * PF_RPW + i;
    const int t = r / G, g = r - t * G;
    if (t >= nt) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    TQ* o = out + ((long long)(t0 + t) * p.H + j * G + g) * D + lane * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = from_f<TQ>(acc[i][e] * inv);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch_prefill_typed(const PrefillParams& p, int D,
                                 cudaStream_t st) {
  if (D != 128) return cudaErrorInvalidValue;
  constexpr int smem = prefill_smem_bytes<TKV, 128>();
  // above 48 KB dynamic shared memory must be allowed explicitly, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_prefill_kernel<TQ, TKV, 128>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int qt = PF_ROWS / (p.H / p.KV);
  const dim3 grid(p.KV, (p.C + qt - 1) / qt);
  paged_prefill_kernel<TQ, TKV, 128><<<grid, PF_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

Params make_paged_params(const void* q, const void* k, const void* v,
                         void* out, const int* pos, const int* active,
                         const int* page_idx, long long pt_stride, int B,
                         int T, int H, int KV, int max_pages, int page_size,
                         int window, const long long* qs,
                         const long long* ks, const long long* vs) {
  Params p = make_params(q, k, v, out, pos, active, B, T, H, KV,
                         max_pages * page_size, window, qs, ks, vs);
  p.page_idx = page_idx;
  p.pt_sb = pt_stride;
  p.page_size = page_size;
  return p;
}

}  // namespace

// Strides are in elements: q_strides = (batch, token, head), pool strides
// = (page, token, kv head); the last dimension must be contiguous.
// page_idx is (B, max_pages) int32 with row stride pt_stride.  `out` is a
// contiguous (B, T, H, D) tensor of q's dtype.  Returns the launch's
// cudaError_t (0 = success).
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k, const void* v, void* out, const int* pos,
    const int* active, const int* page_idx, long long pt_stride, int B,
    int T, int H, int KV, int max_pages, int page_size, int D, int window,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, int q_dtype, int kv_dtype, void* stream) {
  Params p = make_paged_params(q, k, v, out, pos, active, page_idx,
                               pt_stride, B, T, H, KV, max_pages, page_size,
                               window, q_strides, k_strides, v_strides);
  return (int)launch_decode<false, true>(p, D, q_dtype, kv_dtype,
                                         (cudaStream_t)stream);
}

// Two-phase paged split-K (T = 1, max_pages % num_splits == 0).  o_part
// (B, H, ns, D), m_part and l_part (B, H, ns) are f32 scratch allocated by
// the caller.
extern "C" int paged_decode_attention_splitk_fwd(
    const void* q, const void* k, const void* v, void* out, const int* pos,
    const int* active, const int* page_idx, long long pt_stride, int B,
    int H, int KV, int max_pages, int page_size, int D, int window,
    int num_splits, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, float* o_part, float* m_part, float* l_part,
    int q_dtype, int kv_dtype, void* stream) {
  Params p = make_paged_params(q, k, v, out, pos, active, page_idx,
                               pt_stride, B, 1, H, KV, max_pages, page_size,
                               window, q_strides, k_strides, v_strides);
  p.num_splits = num_splits;
  p.o_part = o_part;
  p.m_part = m_part;
  p.l_part = l_part;
  return (int)launch_decode<true, true>(p, D, q_dtype, kv_dtype,
                                        (cudaStream_t)stream);
}

// Fused paged prefill of one slot's chunk: q (1, C, H, D) with strides
// (token, head) = q_strides[0..1]; pools as above; page_row the slot's
// contiguous int32 page-table row.  `out` is a contiguous (1, C, H, D)
// tensor of q's dtype.  (H / KV) must divide 64.
extern "C" int paged_prefill_attention_fwd(
    const void* q, const void* k, const void* v, void* out,
    const int* page_row, int C, int H, int KV, int page_size, int D,
    int q_offset, int window, const long long* q_strides,
    const long long* k_strides, const long long* v_strides, int q_dtype,
    int kv_dtype, void* stream) {
  PrefillParams p{};
  p.q = q; p.k = k; p.v = v; p.out = out; p.page_row = page_row;
  p.C = C; p.H = H; p.KV = KV; p.q_offset = q_offset; p.window = window;
  p.page_size = page_size;
  p.q_st = q_strides[0]; p.q_sh = q_strides[1];
  p.k_sp = k_strides[0]; p.k_ss = k_strides[1]; p.k_sh = k_strides[2];
  p.v_sp = v_strides[0]; p.v_ss = v_strides[1]; p.v_sh = v_strides[2];
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)launch_prefill_typed<float, float>(p, D, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)launch_prefill_typed<float, __nv_bfloat16>(p, D, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return (int)launch_prefill_typed<__nv_bfloat16, float>(p, D, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch_prefill_typed<__nv_bfloat16, __nv_bfloat16>(p, D, st);
  return (int)cudaErrorInvalidValue;
}
