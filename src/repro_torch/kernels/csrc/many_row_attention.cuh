// The many-row attention kernel on Hopper's warpgroup products: full-
// sequence flash attention (flash_attention.cu: dense, batch B, causal or
// not, windowed or not) and one slot's paged prefill chunk
// (paged_attention.cu: the same body with a page-table lookup per key row).
//
// Replaces
//   flash_attention_tpu          (src/repro/kernels/flash_attention.py:83,
//                                 _flash_kernel)
//   paged_prefill_attention_tpu  (src/repro/kernels/paged_attention.py:228,
//                                 _paged_prefill_kernel)
//
// Contract (as the TPU kernels' and as attention_common.cuh states it for
// decode): query row t of batch b sits at position q_offset + t and sees
// key kpos when kpos <= qpos (causal) and qpos - kpos < window
// (window > 0).  q and k are taken as f32 values, the scale is applied
// after the dot, the online softmax state (m, l, acc) is f32 and l sums
// the unrounded p, p is rounded to v's dtype before the PV product, masked
// keys add exactly 0 (the mask selects before the exp), and the output is
// acc / max(l, 1e-30) in q's dtype.  A row that sees no key writes 0.
//
// What bounds it on an H100: operations.  4 * D flops per attended
// (row, key) pair (QK and PV): 137.4 GFLOP for internlm2's causal 2 x 4096
// prefill against 50 MB of q, K, V and output (~2,700 flops per f32 byte).
// On the CUDA cores the ceiling is 67 TFLOP/s; this kernel multiplies on
// the tensor cores, whose TF32 rate is 495 TFLOP/s dense, and keeps f32
// accuracy with three TF32 products per f32 product (below), so its bound
// is 495 / 3 = 165 TFLOP/s of f32-accurate work (0.833 ms at 2 x 4096).
// Only wgmma reaches the full TF32 rate on Hopper; the warp-level mma
// reaches part of it.
//
// What the design does about it:
//   * Products on wgmma.mma_async m64nNk8 TF32 with f32 accumulation
//     (wgmma_tf32.cuh, shared with ssd_scan.cu).  A CTA is MR_WG = 2
//     consumer warpgroups of 64 query rows each.  S = q K^T is m64n32 per 32-key
//     tile: A is q, loaded from shared memory and split per k-step; B is
//     the K tile in the K-major core-matrix layout (d contiguous, so an f32
//     row's 16-byte chunks land in place).  O += P V is m64nD (D = 64, 80
//     or 128 are legal TF32 N): A is P, formed in registers from S's
//     accumulator, whose columns (2t, 2t + 1) of an 8-key step become A's
//     k indices (t, t + 4); B is V^T, transposed as the tile is staged with
//     the keys of each 8-key step permuted to match (k index t is key 2t,
//     k index t + 4 key 2t + 1).  A tile's P V is summed in fresh
//     registers and added to O in f32: the accumulation truncates, and O
//     as the accumulator over every tile drifted 8x further in internlm2's
//     prefill logits (4.2e-4) and past the logits' tolerance in
//     qwen3-moe's (PERF.md).
//   * 3xTF32: an f32 operand x is split into x_big = rna_tf32(x) and
//     x_small = rna_tf32(x - x_big) (as CUTLASS's OpMultiplyAddFastF32):
//     a.b = a_small.b_big + a_big.b_small + a_big.b_big, in that order, the
//     small.small term (<= 2^-22 |a b|) dropped.  A bf16 operand (a bf16 q
//     or cache, or p rounded to a bf16 v) is exact in TF32 and has no small
//     part, so bf16 x f32 takes two products and bf16 x bf16 one.  The
//     split is integer work (attention_common.cuh's tf32_rna and Frag).
//   * Rows: (position, group head) flattened.  Within one (batch row, KV
//     head j), query row r is position r / G, query head j G + r % G; a CTA
//     takes MR_ROWS = 64 MR_WG consecutive rows, each warpgroup 64 of them,
//     whatever G is, so no row is idle but in the last CTA of a (batch row,
//     KV head): its rows past Sq G load q as 0 and store nothing (their
//     m, l and O stay finite and no shuffle crosses rows).  Each K/V tile
//     so feeds MR_ROWS rows at every grouping (granite's G = 48 too).
//     The CTA's key range runs from its first row's window start to its
//     last row's position; the mask is per row and selects before the exp.
//     Key tiles start at multiples of MR_TK on the global key axis, so a row
//     meets the same tiles in the same order in whichever CTA holds it: a
//     tile it sees none of adds exactly 0 and rescales by exp(0) = 1.  G > 64
//     is refused (no arch needs more).  Causal row blocks run last-first,
//     heaviest first.
//   * The ring: 32-key tiles in two stages of shared memory, each four
//     operand tiles of 32 x D f32 (K big and small, V^T big and small: 64 KB
//     at D = 128), one CTA per SM.  While tile i's products run, tile i + 1
//     is copied by 16-byte cp.async into its stage's small slots (raw
//     values: f32 K in the core-matrix layout, other K row-major with a
//     16-byte pad, V row-major; rows outside [lo, hi) zero-filled without a
//     read; the paged instance finds each row's page in the table, as
//     KeyRows<.., true> does); then every thread reads its share of the raw
//     tile, the CTA syncs, and the staging pass writes the operand tiles:
//     quantized values dequantized (float(x) * scale, so #4q keeps the
//     arithmetic of its contract: K, V and p f32, split), f32 values split,
//     V transposed.  The staging of tile i + 1 overlaps tile i's PV product.
//   * q in shared memory as f32, in the A fragments' order (a lane's four
//     values of a k-step are one 16-byte read): 32 KB a warpgroup at
//     D = 128.  Split per k-step, two k-steps per wgmma group, the
//     fragments of two groups alive (wgmma_wait<1>).
//   * Softmax in the accumulator layout: a row's 8 key scores of a tile lie
//     in the four lanes of a quad, so its max and sum take two
//     __shfl_xor_sync; the mask is computed per element from the row's
//     position (a table in shared memory), not at all in a tile every row
//     of the CTA sees whole.  The exp is __expf.  A warp whose rows all
//     kept their max skips O's rescale (alpha = 1 is exact).
//   * Shared memory and registers: q 32 KB a warpgroup + the ring 128 KB at
//     D = 128 (+ the rows' positions, and 256 B of scales for 1-byte
//     pools): 192.5 KB, one CTA per SM (a third warpgroup fits the 227 KB
//     but not a tile's fresh P V sum under its 168-register cap).  Per
//     thread: O and the tile's P V (D / 2 f32 each), S (16), the q
//     fragments of two groups and P's of one tile, under
//     __launch_bounds__(MR_THREADS, 1).  The copy and staging offsets and
//     the rows' indices are recomputed from the thread's index each tile
//     (thread_index), not held through the products, and the staging holds
//     one operand's share at a time; no instance spills (chip_smoke's
//     phase 2 prints ptxas's report and fails on a spill).
//   * Filling the card: a launch with fewer CTAs than SMs (the paged
//     prefill of one 256-row chunk at G = 2: 8 KV heads x 4 row blocks of
//     128 = 32) splits each CTA's key range over num_splits CTAs (the
//     wrapper picks it by waves: 4 for that chunk at 3840, 128 CTAs on 132
//     SMs), whole tiles each.
//     Each split writes its unnormalised (acc, m, l) to f32 scratch and a
//     combine kernel merges them with the split-K rule exp(m_i - m*); an
//     empty split has m = -1e30 and l = 0 and so weighs 0.
#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int MR_WG = 2;               // consumer warpgroups per CTA
constexpr int MR_ROWS = 64 * MR_WG;    // flattened query rows per CTA
constexpr int MR_THREADS = 128 * MR_WG;
constexpr int MR_TK = 32;              // keys per tile
constexpr int MR_MAX_G = 64;           // query heads per KV head, at most

struct PrefillParams {
  const void* q;        // (B, Sq, H, D) through strides
  const void* k;        // dense (B, Sk, KV, D); paged (P, page_size, KV, D)
  const void* v;
  const float* ks;      // quantized pools: scales (P, page_size, KV, 1)
  const float* vs;      // through strides; null otherwise
  void* out;            // contiguous (B, Sq, H, D), q's dtype
  const int* page_row;  // paged only: the slot's page-table row
  int Sq, Sk, H, KV, q_offset, window, causal, page_size;
  int num_splits;       // > 1: key-range splits, merged by the combine
  long long q_sb, q_st, q_sh;
  // dense: (batch, seq, kv head) strides; paged: (page, token, kv head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long ks_sb, ks_ss, ks_sh;  // scale strides, as the pools'
  long long vs_sb, vs_ss, vs_sh;
  float* o_part;  // splits: (ns, B, Sq, H, D) unnormalised accumulators
  float* m_part;  // (ns, B, Sq, H)
  float* l_part;  // (ns, B, Sq, H)
};

// q in fragment order, the 2-stage ring of four 32 x D f32 operand tiles,
// each row's position, and (quantized pools) the landing tile's K and V
// scales.
template <typename TKV, int D>
constexpr int many_row_smem_bytes() {
  return (MR_ROWS * D + 2 * 4 * MR_TK * D + MR_ROWS) * (int)sizeof(float) +
         (KVValue<TKV>::quant ? 2 * MR_TK * (int)sizeof(float) : 0);
}

// The key rows of pool `base` (K, V or a scale pool) for batch row b, KV
// head j: dense through (batch, seq, head) strides, paged through the
// slot's page-table row and (page, token, head) strides.
template <typename T, bool PAGED>
__device__ __forceinline__ KeyRows<T, PAGED> pool_rows(
    const PrefillParams& p, const void* base, long long sb, long long ss,
    long long sh, int b, int j) {
  KeyRows<T, PAGED> r;
  r.row = p.page_row;
  r.page_size = p.page_size;
  r.base = static_cast<const T*>(base) + j * sh + (PAGED ? 0 : b * sb);
  r.s_page = sb;
  r.s_row = ss;
  return r;
}

// One raw K/V value as f32 (before a quantized pool's scale).
__device__ __forceinline__ float raw_f(float x) { return x; }
__device__ __forceinline__ float raw_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float raw_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float raw_f(__nv_fp8_e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}

// Warp w of the CTA (warpgroup w / 4) owns rows 16 w .. 16 w + 15; lane
// (g = lane / 4, tq = lane % 4) holds rows 16 w + g and 16 w + g + 8 of
// every accumulator (wgmma_tf32.cuh's layout).
template <typename TQ, typename TKV, int D, bool PAGED, bool CAUSAL>
__global__ void __launch_bounds__(MR_THREADS, 1)
    many_row_kernel(PrefillParams p) {
  constexpr bool QUANT = KVValue<TKV>::quant;
  using TV = typename KVValue<TKV>::type;  // a loaded K/V value's type
  constexpr bool SQ = std::is_same<TQ, float>::value;   // q has small parts
  constexpr bool SKV = std::is_same<TV, float>::value;  // K, V and p do
  constexpr bool F32KV = std::is_same<TKV, float>::value;
  constexpr int VEC = 16 / sizeof(TKV);  // values in a 16-byte chunk
  constexpr int CPR = D / VEC;           // chunks per K/V row
  constexpr int UNITS = MR_TK * CPR;     // chunks per K or V tile
  constexpr int NCH = (UNITS + MR_THREADS - 1) / MR_THREADS;
  constexpr bool CH_WHOLE = NCH * MR_THREADS == UNITS;
  constexpr int VUNITS = MR_TK / 8 * D;  // V^T staging units (k-step, col)
  constexpr int NVU = (VUNITS + MR_THREADS - 1) / MR_THREADS;
  constexpr bool VU_WHOLE = NVU * MR_THREADS == VUNITS;
  constexpr int KS = D / 8;              // k-steps of QK
  constexpr int KG = 2;                  // k-steps per wgmma group of QK
  constexpr int TILE = MR_TK * D;        // floats of one operand tile
  constexpr int LR = D * (int)sizeof(TKV) + 16;  // raw K row bytes (not f32)
  static_assert(D % 16 == 0 && KS % KG == 0, "head dim: whole 16-d blocks");
  static_assert(F32KV || MR_TK * LR <= TILE * (int)sizeof(float),
                "a raw K tile fits its landing slot");
  static_assert(!QUANT || PAGED, "quantized pools are paged");
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [warp][KS][lane][4]
  float* ring = qs + MR_ROWS * D;  // [2][K big|K small|V^T big|V^T small]
  int* qrow = reinterpret_cast<int*>(ring + 2 * 4 * TILE);  // positions
  float* scs = reinterpret_cast<float*>(qrow + MR_ROWS);  // [K|V][MR_TK]

  const int ns = p.num_splits;
  const int j = blockIdx.x, b = blockIdx.z / ns, isp = blockIdx.z % ns;
  const int nb = gridDim.z / ns;
  const int G = p.H / p.KV;
  const int nrows = p.Sq * G;  // flattened rows of this (b, j)
  // causal: the last row blocks see the most keys; issue them first
  const int r0 =
      (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * MR_ROWS;
  const int tid = threadIdx.x, tq = tid & 3;

  // q into shared memory in the A fragments' order: element (row r, d) is
  // value h + 2 hi of lane 4 (r % 8) + d % 4 of k-step d / 8 of warp r / 16
  // (h = r % 16 / 8, hi = d % 8 / 4); rows past the last position are 0
  {
    const TQ* q = static_cast<const TQ*>(p.q) + b * p.q_sb;
    for (int idx = tid; idx < MR_ROWS * (D / 4); idx += MR_THREADS) {
      const int r = idx / (D / 4), c4 = idx - r * (D / 4);
      const int row = r0 + r, t = row / G, gg = row - t * G;
      const bool in = row < nrows;
      const TQ* src = q + (long long)t * p.q_st +
                      (long long)(j * G + gg) * p.q_sh + 4 * c4;
      float* dst = qs + (((r >> 4) * KS + (c4 >> 1)) * 32 + (r & 7) * 4) * 4 +
                   ((r >> 3) & 1) + 2 * (c4 & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[4 * i] = in ? to_f(src[i]) : 0.f;
    }
    // row r's position, read by the mask (rows past the last position see
    // keys too: their q is 0, their results finite and never stored)
    for (int r = tid; r < MR_ROWS; r += MR_THREADS)
      qrow[r] = p.q_offset + (r0 + r) / G;
  }

  // keys this CTA may need: [lo, hi), from its first row's window start
  // to its last row's position (causal)
  const int tfirst = r0 / G, tlast = (min(r0 + MR_ROWS, nrows) - 1) / G;
  const int qfirst = p.q_offset + tfirst, qlast = p.q_offset + tlast;
  const int hi = CAUSAL ? min(p.Sk, qlast + 1) : p.Sk;
  const int lo = p.window ? max(0, qfirst - p.window + 1) : 0;
  int kbeg = lo < hi ? (lo / MR_TK) * MR_TK : hi;  // empty range: no tile
  int kend = hi;
  if (ns > 1) {  // this split's whole tiles of [kbeg, hi)
    const int ntiles = (hi - kbeg + MR_TK - 1) / MR_TK;
    const int per = (ntiles + ns - 1) / ns;
    kend = min(hi, kbeg + min(ntiles, (isp + 1) * per) * MR_TK);
    kbeg += min(ntiles, isp * per) * MR_TK;
  }

  // K chunk u of a tile: a warp's lanes take 8 keys x 4 chunks, so each
  // quarter-warp writes 8 keys' core-matrix rows (distinct bank groups)
  // and the warp reads whole 64-byte row segments
  auto k_unit = [](int u, int& kk, int& c) {
    const int rest = u >> 3;
    kk = 8 * (rest / CPR) + (u & 7);
    c = rest - (rest / CPR) * CPR;
  };
  // where raw K chunk (kk, c) lands in its slot: f32 in place in the
  // core-matrix layout, other types row-major with a 16-byte pad
  auto k_raw = [](float* slot, int kk, int c) -> TKV* {
    if constexpr (F32KV)
      return reinterpret_cast<TKV*>(slot + bt_offset(kk, c));
    else
      return reinterpret_cast<TKV*>(reinterpret_cast<unsigned char*>(slot) +
                                    kk * LR) + c * VEC;
  };

  // keys [k0, k0 + TK) into stage st's small slots (raw); rows outside
  // [lo, hi) are zero-filled without a read.  Quantized: thread i < 2 TK
  // also copies the K (i < TK) or V scale of key i % TK.
  auto load_tile = [&](int k0, int st) {
    // built here from the launch's parameters: nothing of them need stay
    // in registers across the key loop
    const auto krows = pool_rows<TKV, PAGED>(p, p.k, p.k_sb, p.k_ss, p.k_sh,
                                             b, j);
    const auto vrows = pool_rows<TKV, PAGED>(p, p.v, p.v_sb, p.v_ss, p.v_sh,
                                             b, j);
    const int tid = thread_index();
    float* kl = ring + (st * 4 + 1) * TILE;
    TKV* vl = reinterpret_cast<TKV*>(ring + (st * 4 + 3) * TILE);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int u = tid + i * MR_THREADS;
      if (!CH_WHOLE && u >= UNITS) break;  // the last pass's rest
      int kk, c;
      k_unit(u, kk, c);
      int kpos = k0 + kk;
      bool in = kpos >= lo && kpos < hi;
      cp_async16(k_raw(kl, kk, c), in ? krows(kpos) + c * VEC : krows.base,
                 in);
      kk = u / CPR;  // V: row-major, the lanes along a row
      c = u - kk * CPR;
      kpos = k0 + kk;
      in = kpos >= lo && kpos < hi;
      cp_async16(vl + kk * D + c * VEC, in ? vrows(kpos) + c * VEC
                                           : vrows.base, in);
    }
    if (QUANT && tid < 2 * MR_TK) {
      const int kk = tid % MR_TK, isv = tid / MR_TK;
      const int kpos = k0 + kk;
      const bool in = kpos >= lo && kpos < hi;
      // (a reference to one of the two KeyRows would put both in local
      // memory; select the address instead)
      const auto ksrows = pool_rows<float, PAGED>(p, p.ks, p.ks_sb, p.ks_ss,
                                                  p.ks_sh, b, j);
      const auto vsrows = pool_rows<float, PAGED>(p, p.vs, p.vs_sb, p.vs_ss,
                                                  p.vs_sh, b, j);
      const float* src = isv ? (in ? vsrows(kpos) : vsrows.base)
                             : (in ? ksrows(kpos) : ksrows.base);
      cp_async4(scs + isv * MR_TK + kk, src, in);
    }
  };

  // stage st's raw tile (landed) into its operand tiles: K big/small in
  // the core layout (a thread stages the chunks it copied; an f32 chunk is
  // read and rewritten in place), then V^T big/small, keys permuted within
  // each 8-key step (k index t = key 2t, k index t + 4 = key 2t + 1).
  // Where small parts overwrite a raw tile other threads still read (1-byte
  // K; f32 or 1-byte V), every thread reads its share, then the CTA syncs.
  // Last, a fence for wgmma's reads.
  auto stage_tile = [&](int st) {
    const int tid = thread_index();
    float* kb = ring + st * 4 * TILE;
    float* ksm = kb + TILE;
    float* vb = kb + 2 * TILE;
    float* vsm = kb + 3 * TILE;
    {
      uint4 kr[NCH];  // raw chunks: 16 bytes a chunk held through the sync
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int u = tid + i * MR_THREADS;
        if (!CH_WHOLE && u >= UNITS) break;
        int kk, c;
        k_unit(u, kk, c);
        kr[i] = *reinterpret_cast<const uint4*>(k_raw(ksm, kk, c));
      }
      if constexpr (QUANT) __syncthreads();
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int u = tid + i * MR_THREADS;
        if (!CH_WHOLE && u >= UNITS) break;
        int kk, c;
        k_unit(u, kk, c);
        float kf[VEC];
        Chunk<TKV>::get(kr[i], kf);
        if (QUANT) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[e] *= scs[kk];
        }
#pragma unroll
        for (int q4 = 0; q4 < VEC / 4; ++q4) {
          const int off = bt_offset(kk, c * (VEC / 4) + q4);
          float big[4], small[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = kf[4 * q4 + e];
            big[e] = SKV ? __uint_as_float(tf32_rna(x)) : x;
            small[e] = __uint_as_float(tf32_rna(x - big[e]));
          }
          store4(kb + off, big);
          if (SKV) store4(ksm + off, small);
        }
      }
    }
    {
      const TKV* vl = reinterpret_cast<const TKV*>(vsm);
      float vf[NVU][8];
#pragma unroll
      for (int i = 0; i < NVU; ++i) {
        const int u = tid + i * MR_THREADS;
        if (!VU_WHOLE && u >= VUNITS) break;
        const int ks = u / D, col = u - ks * D;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          vf[i][e] = raw_f(vl[(8 * ks + e) * D + col]);
          if (QUANT) vf[i][e] *= scs[MR_TK + 8 * ks + e];
        }
      }
      if constexpr (SKV) __syncthreads();
#pragma unroll
      for (int i = 0; i < NVU; ++i) {
        const int u = tid + i * MR_THREADS;
        if (!VU_WHOLE && u >= VUNITS) break;
        const int ks = u / D, col = u - ks * D;
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          const int off = ks * kstep_floats(D) + core_offset(col, kc);
          float big[4], small[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = vf[i][2 * e + kc];
            big[e] = SKV ? __uint_as_float(tf32_rna(x)) : x;
            small[e] = __uint_as_float(tf32_rna(x - big[e]));
          }
          store4(vb + off, big);
          if (SKV) store4(vsm + off, small);
        }
      }
    }
    fence_proxy_async();  // the generic-proxy writes, seen by wgmma
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this lane's part
  const float scale = 1.0f / sqrtf((float)D);
  // this lane's rows of the CTA, 16 warp + g + 8 h, from the thread's index
  // where used (held through the loop they would cost registers the
  // products use)
  auto cta_row = [](int h) {
    return (thread_index() >> 5) * 16 + ((thread_index() & 31) >> 2) + 8 * h;
  };

  if (kbeg < kend) {
    load_tile(kbeg, 0);
    cp_async_wait_all();
    __syncthreads();
    stage_tile(0);
  }
  int st = 0;
  for (int k0 = kbeg; k0 < kend; k0 += MR_TK, st ^= 1) {
    // tile k0 is staged by every thread, and every wgmma of the last tile
    // has completed: the next tile's copies go to the other stage and fly
    // while this tile's products run
    __syncthreads();
    const bool more = k0 + MR_TK < kend;
    if (more) load_tile(k0 + MR_TK, st ^ 1);
    const float* kb = ring + st * 4 * TILE;
    const float* ksm = kb + TILE;
    const float* vb = kb + 2 * TILE;
    const float* vsm = kb + 3 * TILE;

    // S = q K^T over D, KG k-steps a group; the q fragments of two groups
    // stay alive (the last group's until its wgmma are done)
    float s[16];
    Frag<4, SQ> qa[2][KG];
    const float4* qf = reinterpret_cast<const float4*>(qs) +
                       (thread_index() >> 5) * KS * 32 +
                       (thread_index() & 31);
#pragma unroll
    for (int kg = 0; kg < KS / KG; ++kg) {
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        const float4 x = qf[(kg * KG + u) * 32];
        qa[kg & 1][u].set(0, x.x);
        qa[kg & 1][u].set(1, x.y);
        qa[kg & 1][u].set(2, x.z);
        qa[kg & 1][u].set(3, x.w);
      }
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        const int ks = kg * KG + u;
        const Frag<4, SQ>& a = qa[kg & 1][u];
        const uint64_t db = smem_desc(kb + ks * BT_KSTEP);
        const uint64_t dsm = smem_desc(ksm + ks * BT_KSTEP);
        const int acc = ks > 0;  // the tile's first product starts fresh
        if (SQ) wgmma_tf32(s, a.small, db, acc);
        if (SKV) wgmma_tf32(s, a.big, dsm, SQ ? 1 : acc);
        wgmma_tf32(s, a.big, db, (SQ || SKV) ? 1 : acc);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the group before: its fragments may be formed anew
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        fence_regs(qa[(kg + 1) & 1][u].big);
        if constexpr (SQ) fence_regs(qa[(kg + 1) & 1][u].small);
      }
    }
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      fence_regs(qa[(KS / KG - 1) & 1][u].big);
      if constexpr (SQ) fence_regs(qa[(KS / KG - 1) & 1][u].small);
    }

    // online softmax of rows g (h = 0) and g + 8 (h = 1): element 4 n + 2 h
    // + e of S is key k0 + 8 n + 2 tq + e; p overwrites s.  A tile that
    // every row of the CTA sees whole needs no mask.
    const bool whole = k0 >= lo && k0 + MR_TK <= hi &&
                       (!CAUSAL || k0 + MR_TK - 1 <= qfirst) &&
                       (p.window == 0 || qlast - k0 < p.window);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = qrow[cta_row(h)];
      float mx = NEG_INF;
      unsigned ok = 0;
#pragma unroll
      for (int n = 0; n < MR_TK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * n + 2 * tq + e;
          const bool seen =
              whole || (kpos >= lo && (CAUSAL ? kpos <= qpos : kpos < hi) &&
                        (p.window == 0 || qpos - kpos < p.window));
          float& x = s[4 * n + 2 * h + e];
          x = seen ? x * scale : NEG_INF;
          ok |= (unsigned)seen << (2 * n + e);
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = __expf(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < MR_TK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * n + 2 * h + e];
          const float pr =
              (ok >> (2 * n + e)) & 1u ? __expf(x - m_new) : 0.f;
          sum += pr;
          x = to_f(from_f<TV>(pr));
        }
      l[h] = l[h] * alpha[h] + sum;
    }
    // O's rows rescaled where their max moved (alpha = 1 is exact: a warp
    // whose 16 rows all kept theirs skips the multiplies)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[4 * c + i] *= alpha[i >> 1];
    }

    // O += P V: k-step n is keys 8 n .. 8 n + 7, A's k index tq holding
    // key 2 tq and k index tq + 4 key 2 tq + 1, as V^T was staged.  The
    // accumulation truncates, so the tile's product is summed in fresh
    // registers and added to O in f32: the truncation then scales with one
    // tile's sum, not with every key's
    Frag<4, SKV> pa[MR_TK / 8];
#pragma unroll
    for (int n = 0; n < MR_TK / 8; ++n) {
      pa[n].set(0, s[4 * n]);
      pa[n].set(1, s[4 * n + 2]);
      pa[n].set(2, s[4 * n + 1]);
      pa[n].set(3, s[4 * n + 3]);
    }
    float pv[D / 2];
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < MR_TK / 8; ++n) {
      const uint64_t db = smem_desc(vb + n * kstep_floats(D));
      const uint64_t dsm = smem_desc(vsm + n * kstep_floats(D));
      const int acc = n > 0;  // the tile's first product starts fresh
      if (SKV) {
        wgmma_tf32(pv, pa[n].small, db, acc);
        wgmma_tf32(pv, pa[n].big, dsm, 1);
      }
      wgmma_tf32(pv, pa[n].big, db, SKV ? 1 : acc);
    }
    wgmma_commit();
    if (more) {  // the next tile, staged while this tile's PV runs
      cp_async_wait_all();
      __syncthreads();
      stage_tile(st ^ 1);
    }
    wgmma_wait<0>();
    fence_regs(pv);
#pragma unroll
    for (int n = 0; n < MR_TK / 8; ++n) {
      fence_regs(pa[n].big);
      if constexpr (SKV) fence_regs(pa[n].small);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] += pv[i];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int r = r0 + cta_row(h);
    if (r >= nrows) continue;
    const int t = r / G, gg = r - t * G;
    const long long row =
        ((long long)b * p.Sq + t) * p.H + j * G + gg;
    // this lane's columns of the row: 8 c + 2 tq + e, held in o[4 c + 2 h + e]
    const float inv = ns > 1 ? 1.f : 1.0f / fmaxf(lr, 1e-30f);
    const long long prow = (long long)isp * nb * p.Sq * p.H + row;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * tq;
      const float y0 = o[4 * c + 2 * h] * inv, y1 = o[4 * c + 2 * h + 1] * inv;
      if (ns > 1)
        store2(p.o_part + prow * D + col, y0, y1);
      else
        store2(static_cast<TQ*>(p.out) + row * D + col, y0, y1);
    }
    if (ns > 1 && tq == 0) {
      p.m_part[prow] = m[h];
      p.l_part[prow] = lr;
    }
  }
}

// Merges the key-range splits: one CTA per output row (b, t, h), thread d
// one column.  A split that saw no key of the row has m = -1e30, l = 0 and
// weighs exp(-1e30 - m*) = 0; a row no split saw writes 0.
template <typename TQ, int D>
__global__ void __launch_bounds__(D)
    many_row_combine_kernel(PrefillParams p) {
  const long long row = blockIdx.x, rows = gridDim.x;
  const int d = threadIdx.x, ns = p.num_splits;
  float m_star = NEG_INF;
  for (int i = 0; i < ns; ++i)
    m_star = fmaxf(m_star, p.m_part[i * rows + row]);
  float denom = 0.f, num = 0.f;
  for (int i = 0; i < ns; ++i) {
    const float a = expf(p.m_part[i * rows + row] - m_star);
    denom += p.l_part[i * rows + row] * a;
    num += p.o_part[(i * rows + row) * D + d] * a;
  }
  static_cast<TQ*>(p.out)[row * D + d] =
      from_f<TQ>(num / fmaxf(denom, 1e-30f));
}

template <typename TQ, typename TKV, int D, bool PAGED, bool CAUSAL>
cudaError_t launch_many_row_causal(const PrefillParams& p, int B,
                                   cudaStream_t st) {
  constexpr int smem = many_row_smem_bytes<TKV, D>();
  // above 48 KB dynamic shared memory must be allowed explicitly, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      many_row_kernel<TQ, TKV, D, PAGED, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  if (p.num_splits < 1) return cudaErrorInvalidValue;
  // MR_ROWS flattened (position, head) rows a CTA, per (batch, KV head)
  const int blocks = (p.Sq * (p.H / p.KV) + MR_ROWS - 1) / MR_ROWS;
  const dim3 grid(p.KV, blocks, B * p.num_splits);
  many_row_kernel<TQ, TKV, D, PAGED, CAUSAL>
      <<<grid, MR_THREADS, smem, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.num_splits == 1) return err;
  many_row_combine_kernel<TQ, D>
      <<<(unsigned)(B * p.Sq * p.H), D, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D, bool PAGED>
cudaError_t launch_many_row_typed(const PrefillParams& p, int B,
                                  cudaStream_t st) {
  if (p.causal)
    return launch_many_row_causal<TQ, TKV, D, PAGED, true>(p, B, st);
  if constexpr (PAGED) {
    return cudaErrorInvalidValue;  // the paged prefill is always causal
  } else {
    return launch_many_row_causal<TQ, TKV, D, PAGED, false>(p, B, st);
  }
}

template <typename TQ, int D, bool PAGED>
cudaError_t launch_many_row_kv(const PrefillParams& p, int B, int kv_dtype,
                               cudaStream_t st) {
  if (kv_dtype == 0)
    return launch_many_row_typed<TQ, float, D, PAGED>(p, B, st);
  if (kv_dtype == 1)
    return launch_many_row_typed<TQ, __nv_bfloat16, D, PAGED>(p, B, st);
  if constexpr (PAGED) {
    if (kv_dtype == 2)
      return launch_many_row_typed<TQ, int8_t, D, PAGED>(p, B, st);
    if (kv_dtype == 3)
      return launch_many_row_typed<TQ, __nv_fp8_e4m3, D, PAGED>(p, B, st);
  }
  return cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16; the paged pools also 2 = int8
// and 3 = float8_e4m3fn, the quantized pools, which need both scale pools
// (and only they take scales).  Each library instantiates its head dim D;
// a launch at another head dim `d` is refused.
template <bool PAGED, int D>
cudaError_t launch_many_row(const PrefillParams& p, int B, int d, int q_dtype,
                            int kv_dtype, cudaStream_t st) {
  const bool quant = kv_dtype == 2 || kv_dtype == 3;
  if (d != D || (p.ks != nullptr) != quant || (p.vs != nullptr) != quant)
    return cudaErrorInvalidValue;
  if (p.KV < 1 || p.H % p.KV || p.H / p.KV > MR_MAX_G)
    return cudaErrorInvalidValue;
  if (q_dtype == 0)
    return launch_many_row_kv<float, D, PAGED>(p, B, kv_dtype, st);
  if (q_dtype == 1)
    return launch_many_row_kv<__nv_bfloat16, D, PAGED>(p, B, kv_dtype, st);
  return cudaErrorInvalidValue;
}

}  // namespace
