// The many-row attention kernel on Hopper's tensor cores: full-sequence
// flash attention (flash_attention.cu: dense, batch B, causal or not,
// windowed or not) and one slot's paged prefill chunk (paged_attention.cu:
// the same body with a page-table lookup per key row).
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
// mma.sync reaches only part of the TF32 rate on Hopper (wgmma the rest),
// and the count of mma.sync products, not the split's integer work, sets
// this kernel's time now (PERF.md).
//
// What the design does about it:
//   * Products on the tensor cores: mma.sync m16n8k8 TF32 with f32
//     accumulation, FlashAttention-2 style (each warp owns 16 query rows,
//     the mma's M).  An f32 operand x is split into x_big = rna_tf32(x)
//     and x_small = rna_tf32(x - x_big) (3xTF32, as CUTLASS's
//     OpMultiplyAddFastF32): a.b = a_small.b_big + a_big.b_small +
//     a_big.b_big, the small.small term (<= 2^-22 |a b|) dropped.  A bf16
//     operand (a bf16 q or cache, or p rounded to a bf16 v) is exact in
//     TF32 and has no small part, so bf16 x f32 takes two products and
//     bf16 x bf16 one, each exact as a bf16 product.  (mma m16n8k16 bf16
//     would run bf16 x bf16 at twice the TF32 rate; TF32 on the exact bf16
//     values gives the same products with one code path, and the served
//     model is f32.)  The split is integer work (tf32_rna, in
//     attention_common.cuh with the other TF32 helpers): sm_90's
//     cvt.rna.tf32.f32 is a sequence of about five instructions, and with
//     it the split, not the mma, set the kernel's time.
//   * Softmax in the accumulator layout: a row's 8 key scores of a tile
//     lie in the four lanes of a quad, so its max and sum take two
//     __shfl_xor_sync; the mask is computed per fragment element (not at
//     all in a tile every row sees whole), and it selects before the exp.
//     The exp is __expf (ex2.approx after a multiply by log2 e, relative
//     error ~2^-21 where p matters): faster than expf, and the max abs
//     error against the plain version did not move.  P then
//     feeds the PV product from registers: the S accumulator's columns
//     (2t, 2t + 1) become the A operand's k indices (t, t + 4) and the V
//     fragment reads keys (2t, 2t + 1) to match, so P never round-trips
//     through shared memory and needs no shuffle.
//   * K/V tiles of 32 keys in a 2-stage ring filled by 16-byte cp.async
//     (the paged instance finds each row's page in the table, as
//     KeyRows<.., true> does); rows outside [lo, hi) are zero-filled
//     without a read.  A lane reads 4 consecutive values of q, K and V at
//     once (16 bytes in f32): QK takes d in a permuted order and PV's
//     output n-tiles a permuted set of columns, which both sums allow.
//     K/V and q rows are padded by 16 bytes, so the 16-byte reads of each
//     quarter-warp hit 8 distinct bank groups (f32).
//   * q (64 rows, f32) lives in shared memory and its fragments are
//     reloaded and split per k-step, so the 3xTF32 halves pin no
//     registers across the loop.
//   * One CTA per (KV head, QT = floor(64 / G) query positions, batch)
//     serves all G heads of those positions, so each K/V tile feeds QT * G
//     rows: 64 where G divides 64, 60 at G = 5 (QT = 12), 48 at granite's
//     G = 48 (QT = 1).  The 64 - QT * G rows left over load q as 0, take
//     no key in the mask (t >= nt) and store nothing; their (m, l, acc)
//     stay finite (m = -1e30, l = 0) and no shuffle crosses rows, so they
//     touch no row that writes.  G > 64 is refused.  The key loop starts
//     at the window's first tile and, causal, ends at the tile's last
//     position (the TPU's skip of masked blocks); causal query tiles run
//     last-first, heaviest first.
//   * Filling the card: a launch with fewer CTAs than SMs (the paged
//     prefill of one 256-row chunk is 8 KV heads x 8 query tiles = 64)
//     splits each CTA's key range over num_splits CTAs (the wrapper picks
//     it: 4 for that chunk, 256 CTAs on 132 SMs).  Each split writes its
//     unnormalised (acc, m, l) to f32 scratch and a combine kernel merges
//     them with the split-K rule exp(m_i - m*); an empty split has
//     m = -1e30 and l = 0 and so weighs 0.
//   * Quantized pools (the paged instance only; the TPU kernel's quant
//     branch): int8 or fp8 K/V tiles with their rows' f32 scales, 4-byte
//     cp.async.ca beside the rows.  Each value is dequantized where the
//     fragment is loaded (float(x) * scale), so K, V and p are f32 values
//     and take the 3xTF32 split, and p is not rounded: the same products as
//     f32 operands, from a quarter of the tile bytes.  (int8 and e4m3
//     values are exact in TF32, so K and V could skip their small parts
//     with the scale applied to the score and folded into p; that changes
//     the rounding against the dequantize-first reference and is left to a
//     later redesign.)
//   * Head dims D in {64, 80, 128} (one library per head dim).  QK takes d
//     in blocks of 32 (each lane 4 consecutive d of two 16-d halves) and,
//     at D = 80, a last block of 16 (lane tq reads d 64 + 4 tq ..); PV's
//     output n-tiles cover 32 columns per 4 tiles and, at D = 80, 16
//     columns in 2 tiles (n index x: columns 64 + 2 x, 64 + 2 x + 1, read
//     2 at a time).  The tile copy's last pass is guarded where a tile's
//     16-byte chunks do not split evenly over the threads (D = 80 bf16 and
//     1-byte pools).
//   * Registers and occupancy: 128 threads and 99 KB of shared memory per
//     CTA with f32 K/V (68 KB with bf16, 52 KB with int8/fp8), two CTAs per
//     SM for every instance (__launch_bounds__(128, 2): up to 255 registers
//     a thread, no spills).  The split makes the paged instance launch as many CTAs
//     as two per SM hold, so it needs no budget of its own; 16-key tiles
//     at three CTAs per SM ran no faster (PERF.md).
#pragma once

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int MR_ROWS = 64;  // query rows (positions x heads) per CTA
constexpr int MR_WARPS = MR_ROWS / 16;
constexpr int MR_THREADS = 32 * MR_WARPS;
constexpr int MR_TK = 32;  // keys per tile
constexpr int MR_CTAS_PER_SM = 2;

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

// q, the 2-stage K/V ring and (quantized pools) the ring's scales.
template <typename TKV, int D>
constexpr int many_row_smem_bytes() {
  return MR_ROWS * (D + 4) * (int)sizeof(float) +
         2 * 2 * MR_TK * (D + 16 / (int)sizeof(TKV)) * (int)sizeof(TKV) +
         (KVValue<TKV>::quant ? 2 * 2 * MR_TK * (int)sizeof(float) : 0);
}

// Query row r of a CTA is row t0 + r / G, query head j * G + r % G.  Warp
// w owns rows 16 w .. 16 w + 15; lane (g = lane / 4, tq = lane % 4) holds
// rows 16 w + g and 16 w + g + 8 of every accumulator fragment.
template <typename TQ, typename TKV, int D, bool PAGED, bool CAUSAL>
__global__ void __launch_bounds__(MR_THREADS, MR_CTAS_PER_SM)
    many_row_kernel(PrefillParams p) {
  constexpr bool QUANT = KVValue<TKV>::quant;
  using TV = typename KVValue<TKV>::type;  // a loaded K/V value's type
  constexpr bool SQ = std::is_same<TQ, float>::value;   // q has small parts
  constexpr bool SKV = std::is_same<TV, float>::value;  // K, V and p do
  constexpr int VEC = 16 / sizeof(TKV);
  constexpr int LQ = D + 4;    // q row stride in shared memory (floats)
  constexpr int LD = D + VEC;  // K/V row stride (elements, 16-byte pad)
  constexpr int NS = MR_TK / 8;   // score n-tiles (8 keys each)
  constexpr int NO = D / 8;       // output n-tiles (8 columns each)
  constexpr int D32 = D / 32 * 32;  // columns in whole 32-blocks
  constexpr int CPR = D / VEC;    // 16-byte chunks per K/V row
  // chunks per thread, the last pass guarded unless they split evenly
  constexpr int NCH = (MR_TK * CPR + MR_THREADS - 1) / MR_THREADS;
  constexpr bool COPY_WHOLE = NCH * MR_THREADS == MR_TK * CPR;
  static_assert(D % 16 == 0 && (D - D32 == 0 || D - D32 == 16),
                "head dim: 32-blocks and at most one 16-block");
  static_assert(!QUANT || PAGED, "quantized pools are paged");
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                // [64][LQ]
  TKV* kvs = reinterpret_cast<TKV*>(qs + MR_ROWS * LQ);     // [2][K|V][TK][LD]
  // quantized pools: the ring's scales, [2][K|V][TK]
  float* scs = reinterpret_cast<float*>(kvs + 2 * 2 * MR_TK * LD);

  const int ns = p.num_splits;
  const int j = blockIdx.x, b = blockIdx.z / ns, isp = blockIdx.z % ns;
  const int nb = gridDim.z / ns;
  const int G = p.H / p.KV, QT = MR_ROWS / G;
  // causal: the last query tiles see the most keys; issue them first
  const int t0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * QT;
  const int nt = min(QT, p.Sq - t0);  // query positions this CTA holds
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  const TQ* q = static_cast<const TQ*>(p.q) + b * p.q_sb;
  for (int idx = tid; idx < MR_ROWS * D; idx += MR_THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int t = r / G, gg = r - t * G;
    qs[r * LQ + d] =
        t < nt ? to_f(q[(t0 + t) * p.q_st + (j * G + gg) * p.q_sh + d]) : 0.f;
  }

  // keys this CTA may need: [lo, hi); causal: ending at its last row
  const int qfirst = p.q_offset + t0;
  const int hi = CAUSAL ? min(p.Sk, qfirst + nt) : p.Sk;
  const int lo = p.window ? max(0, qfirst - p.window + 1) : 0;
  int kbeg = lo < hi ? (lo / MR_TK) * MR_TK : hi;  // empty range: no tile
  int kend = hi;
  if (ns > 1) {  // this split's whole tiles of [kbeg, hi)
    const int ntiles = (hi - kbeg + MR_TK - 1) / MR_TK;
    const int per = (ntiles + ns - 1) / ns;
    kend = min(hi, kbeg + min(ntiles, (isp + 1) * per) * MR_TK);
    kbeg += min(ntiles, isp * per) * MR_TK;
  }

  KeyRows<TKV, PAGED> krows, vrows;
  krows.row = vrows.row = p.page_row;
  krows.page_size = vrows.page_size = p.page_size;
  krows.base = static_cast<const TKV*>(p.k) + j * p.k_sh +
               (PAGED ? 0 : b * p.k_sb);
  vrows.base = static_cast<const TKV*>(p.v) + j * p.v_sh +
               (PAGED ? 0 : b * p.v_sb);
  krows.s_page = p.k_sb;
  vrows.s_page = p.v_sb;
  krows.s_row = p.k_ss;
  vrows.s_row = p.v_ss;
  KeyRows<float, PAGED> ksrows, vsrows;  // quantized pools' scale rows
  ksrows.row = vsrows.row = p.page_row;
  ksrows.page_size = vsrows.page_size = p.page_size;
  ksrows.base = p.ks + j * p.ks_sh;
  vsrows.base = p.vs + j * p.vs_sh;
  ksrows.s_page = p.ks_sb;
  vsrows.s_page = p.vs_sb;
  ksrows.s_row = p.ks_ss;
  vsrows.s_row = p.vs_ss;

  // keys [k0, k0 + TK) into ring stage `st`; rows outside [lo, hi) are
  // zero-filled without a read.  Quantized: thread i < 2 TK also copies the
  // K (i < TK) or V scale of key i % TK.
  auto load_tile = [&](int k0, int st) {
    TKV* Ks = kvs + st * 2 * MR_TK * LD;
    TKV* Vs = Ks + MR_TK * LD;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int idx = tid + i * MR_THREADS;
      if (!COPY_WHOLE && idx >= MR_TK * CPR) break;  // the last pass's rest
      const int kk = idx / CPR, c = idx - kk * CPR;
      const int kpos = k0 + kk;
      const bool in = kpos >= lo && kpos < hi;
      cp_async16(Ks + kk * LD + c * VEC,
                 in ? krows(kpos) + c * VEC : krows.base, in);
      cp_async16(Vs + kk * LD + c * VEC,
                 in ? vrows(kpos) + c * VEC : vrows.base, in);
    }
    if (QUANT && tid < 2 * MR_TK) {
      const int kk = tid % MR_TK, isv = tid / MR_TK;
      const int kpos = k0 + kk;
      const bool in = kpos >= lo && kpos < hi;
      // (a reference to one of the two KeyRows would put both in local
      // memory; select the address instead)
      const float* src = isv ? (in ? vsrows(kpos) : vsrows.base)
                             : (in ? ksrows(kpos) : ksrows.base);
      cp_async4(scs + (st * 2 + isv) * MR_TK + kk, src, in);
    }
  };

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this lane's part
  const float scale = 1.0f / sqrtf((float)D);
  const float* qw = qs + (warp * 16 + g) * LQ;
  const int t_row[2] = {(warp * 16 + g) / G, (warp * 16 + g + 8) / G};

  if (kbeg < kend) load_tile(kbeg, 0);
  int st = 0;
  for (int k0 = kbeg; k0 < kend; k0 += MR_TK, st ^= 1) {
    // tile k0 has landed for every thread, and every warp is done with
    // the other stage: the next tile's copies go there and fly while this
    // tile's math runs
    cp_async_wait_all();
    __syncthreads();
    if (k0 + MR_TK < kend) load_tile(k0 + MR_TK, st ^ 1);
    const TKV* Ks = kvs + st * 2 * MR_TK * LD;
    const TKV* Vs = Ks + MR_TK * LD;
    // quantized: the scales of this lane's keys, K's of key 8 n + g (QK)
    // and V's of keys 8 n + 2 tq and 8 n + 2 tq + 1 (PV)
    float ksc[NS], vsc[NS][2];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float* sc = scs + st * 2 * MR_TK;
      ksc[n] = QUANT ? sc[n * 8 + g] : 1.f;
      vsc[n][0] = QUANT ? sc[MR_TK + n * 8 + 2 * tq] : 1.f;
      vsc[n][1] = QUANT ? sc[MR_TK + n * 8 + 2 * tq + 1] : 1.f;
    }

    // S = q K^T over D.  The sum over d may take d in any order, so each
    // lane reads 4 consecutive d of q and K at once: d0 = 32 kq + 8 tq +
    // 4 hh + {0..3} (16-d block bb = 2 kq + hh of a 32-block; a last
    // 16-block at D = 80: d0 = 64 + 4 tq) feed two k-steps, whose k index
    // tq is d0 + 2 u and k index tq + 4 is d0 + 2 u + 1 (u = 0, 1).
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int bb = 0; bb < D / 16; ++bb) {
      const int d0 = 16 * bb < D32
                         ? 32 * (bb / 2) + 8 * tq + 4 * (bb % 2)
                         : D32 + 4 * tq;
      float qa[4], qb[4];
      load4(qw + d0, qa);           // row g
      load4(qw + 8 * LQ + d0, qb);  // row g + 8
      Frag<4, SQ> a[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        a[u].set(0, qa[2 * u]);
        a[u].set(1, qb[2 * u]);
        a[u].set(2, qa[2 * u + 1]);
        a[u].set(3, qb[2 * u + 1]);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float kf[4];
        load4(Ks + (n * 8 + g) * LD + d0, kf);
        if (QUANT) {  // dequantized before the product, as the TPU does
#pragma unroll
          for (int i = 0; i < 4; ++i) kf[i] *= ksc[n];
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          Frag<2, SKV> bk;
          bk.set(0, kf[2 * u]);
          bk.set(1, kf[2 * u + 1]);
          mma_split<SQ, SKV>(s[n], a[u], bk);
        }
      }
    }

    // online softmax of rows g (h = 0) and g + 8 (h = 1): element e of
    // n-tile n is key k0 + 8 n + 2 tq + (e & 1); p overwrites s.  A
    // tile that every row of the CTA sees whole needs no mask.
    const bool whole = k0 >= lo && k0 + MR_TK <= hi &&
                       (!CAUSAL || k0 + MR_TK - 1 <= qfirst) &&
                       (p.window == 0 || qfirst + nt - 1 - k0 < p.window);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t_row[h];
      const int qpos = qfirst + t;
      float mx = NEG_INF;
      unsigned ok = 0;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * n + 2 * tq + e;
          const bool seen = whole ||
                            (t < nt && kpos >= lo &&
                             (CAUSAL ? kpos <= qpos : kpos < hi) &&
                             (p.window == 0 || qpos - kpos < p.window));
          const float x = s[n][2 * h + e] * scale;
          s[n][2 * h + e] = seen ? x : NEG_INF;
          ok |= (unsigned)seen << (2 * n + e);
          mx = fmaxf(mx, s[n][2 * h + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = __expf(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pr = (ok >> (2 * n + e)) & 1u
                               ? __expf(s[n][2 * h + e] - m_new)
                               : 0.f;
          sum += pr;
          s[n][2 * h + e] = to_f(from_f<TV>(pr));
        }
      l[h] = l[h] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }

    // O += P V: k-step n covers keys 8 n .. 8 n + 7, with the A operand's
    // k index tq holding key 2 tq and k index tq + 4 key 2 tq + 1.  Output
    // n-tile c = 4 j + i, column index x is column 32 j + 4 x + i of V and
    // O, so a lane reads 4 consecutive columns of a V row at once (the last
    // 16 columns at D = 80: n-tile 8 + i, column 64 + 2 x + i).  The
    // mma's f32 accumulation truncates, so the tile's product is summed in
    // fresh registers and added to O in f32: the truncation then scales
    // with one tile's sum, not with all the keys' (a smaller max error).
    float pv[NO][4];
#pragma unroll
    for (int c = 0; c < NO; ++c)
      pv[c][0] = pv[c][1] = pv[c][2] = pv[c][3] = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      Frag<4, SKV> a;
      a.set(0, s[n][0]);
      a.set(1, s[n][2]);
      a.set(2, s[n][1]);
      a.set(3, s[n][3]);
      const TKV* vr = Vs + (n * 8 + 2 * tq) * LD + 4 * g;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        float va[4], vb[4];
        load4(vr + 32 * j, va);       // key 2 tq
        load4(vr + LD + 32 * j, vb);  // key 2 tq + 1
        if (QUANT) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            va[i] *= vsc[n][0];
            vb[i] *= vsc[n][1];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          Frag<2, SKV> bv;
          bv.set(0, va[i]);
          bv.set(1, vb[i]);
          mma_split<SKV, SKV>(pv[4 * j + i], a, bv);
        }
      }
      if constexpr (D > D32) {  // the last 16 columns, 2 n-tiles
        const TKV* vt = Vs + (n * 8 + 2 * tq) * LD + D32 + 2 * g;
        float va[2], vb[2];
        load2(vt, va);       // key 2 tq
        load2(vt + LD, vb);  // key 2 tq + 1
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (QUANT) {
            va[i] *= vsc[n][0];
            vb[i] *= vsc[n][1];
          }
          Frag<2, SKV> bv;
          bv.set(0, va[i]);
          bv.set(1, vb[i]);
          mma_split<SKV, SKV>(pv[D32 / 8 + i], a, bv);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NO; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[c][i] += pv[c][i];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int r = warp * 16 + g + 8 * h;
    const int t = r / G, gg = r - t * G;
    if (t >= nt) continue;
    const long long row =
        ((long long)b * p.Sq + t0 + t) * p.H + j * G + gg;
    // this lane's columns of the row: 32 j + 8 tq + 4 e + i, held in
    // o[4 j + i][2 h + e]
    const float inv = ns > 1 ? 1.f : 1.0f / fmaxf(lr, 1e-30f);
    const long long prow = (long long)isp * nb * p.Sq * p.H + row;
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) y[i] = o[4 * j + i][2 * h + e] * inv;
        const int col = 32 * j + 8 * tq + 4 * e;
        if (ns > 1)
          store4(p.o_part + prow * D + col, y);
        else
          store4(static_cast<TQ*>(p.out) + row * D + col, y);
      }
    if constexpr (D > D32) {  // columns D32 + 4 tq + 2 e + i: o[8 + i][2h+e]
      const int c8 = D32 / 8;
      const float y[4] = {o[c8][2 * h] * inv, o[c8 + 1][2 * h] * inv,
                          o[c8][2 * h + 1] * inv, o[c8 + 1][2 * h + 1] * inv};
      if (ns > 1)
        store4(p.o_part + prow * D + D32 + 4 * tq, y);
      else
        store4(static_cast<TQ*>(p.out) + row * D + D32 + 4 * tq, y);
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
  const int qt = MR_ROWS / (p.H / p.KV);
  const dim3 grid(p.KV, (p.Sq + qt - 1) / qt, B * p.num_splits);
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
  // QT = floor(MR_ROWS / G) query positions per CTA: at least one
  if (p.KV < 1 || p.H % p.KV || p.H / p.KV > MR_ROWS)
    return cudaErrorInvalidValue;
  if (q_dtype == 0)
    return launch_many_row_kv<float, D, PAGED>(p, B, kv_dtype, st);
  if (q_dtype == 1)
    return launch_many_row_kv<__nv_bfloat16, D, PAGED>(p, B, kv_dtype, st);
  return cudaErrorInvalidValue;
}

}  // namespace
