// The chunked decode kernel's tensor-core route for Hopper (sm_90a): the
// dense and paged decode (and split-K decode) of chunked_decode.cuh at the
// groupings whose G * T query rows a KV head are many (granite's G = 48,
// qwen3-moe's G = 16: decode_attention.decode_route), with each key tile's
// scores and P V on Hopper's warpgroup products.  It replaces the same TPU
// kernels as chunked_decode.cuh (decode_attention_tpu, its split-K, and
// their paged twins) on those rows.
//
// What bounds it on an H100: operations.  A KV head's G * T rows read each
// key once (2 * D * 4 bytes in f32) and do 4 * G * T * D flops with it:
// 48 flops a byte at G * T = 192 (granite's T = 4 verify block), past the
// CUDA cores' balance (66.9 TFLOP/s over 3.35 TB/s = 20).  On the CUDA
// cores those rows ran at 5-8% of that bound (PERF.md); the tensor cores'
// TF32 rate is 495 TFLOP/s, 165 of f32-accurate 3xTF32 work.
//
// What the design does about it, keeping of the chunked design
// (chunked_decode.cuh) the grid (KV head and row tile, slot, chunk) from
// the shapes alone, the page table read first, a cp.async ring, the merge
// of the chunks' (acc, m, l) in chunk order and split-K as chunks clipped
// at the splits, but not its tickets (Merges, below):
//   * Rows on M.  A CTA is TC_WG = 2 consumer warpgroups; its row tile is
//     TC_ROWS = 128 of the KV head's G * T rows (row r = g * T + t, as the
//     CUDA-core kernel numbers them), 64 a warpgroup, so every row of the
//     tile shares one read of each K/V tile.  Rows past G * T take q = 0
//     and store nothing; a warpgroup all of whose rows lie past it
//     (granite's T = 1: 48 rows; qwen3-moe's 16 or 64) multiplies zeros
//     all the same: skipping them put every wgmma of the kernel behind a
//     wait (ptxas C7518, a dependence in a divergent path), 11-17% slower
//     on the card (PERF.md; scripts/wgmma_report.py shows the waits).
//     Granite's 192-row verify block is two row tiles.
//   * Products as many_row_attention.cuh's inner loop, one position a row:
//     S = q K^T m64n32k8 per 32-key tile (q's A fragments from q's rows in
//     shared memory, row-major with a 16-byte pad so that a warp's loads
//     hit 32 banks; K in the K-major core-matrix layout), P V
//     m64n128k8 with P from S's accumulator and V^T staged with the keys of
//     each 8-key step permuted.  f32 operands in 3xTF32 (a_small.b_big +
//     a_big.b_small + a_big.b_big, in that order); bf16 ones need no small
//     part.  A tile's P V is summed in fresh registers and added to O in
//     f32 (O as the accumulator over every tile put qwen3-moe's prefill
//     logits past their tolerance in the many-row kernel).
//   * Rows that do not depend on T, their tile or the other rows.  Key
//     tiles start at multiples of TC_TK from the chunk's start, so a row
//     meets its keys in the same tiles, lanes and order at any T, in any
//     row tile, beside any rows; the mask is the row's own (kpos <= its
//     position, inside the window, inside the chunk) and selects before
//     the exp, so a key past a row's position enters as e = 0 with alpha =
//     1 and a chunk with none of the row's keys merges as (0, NEG_INF, 0).
//     Each output element is one product lane's sum; the softmax's max and
//     sum take a row's quad of lanes.  So a row is bitwise the same in a
//     T-row block and in the T = 1 launch at pos + t, in a slot alone and
//     in the batch, and split-K at whole chunks is the single pass.
//   * The ring: two stages of four 32 x 128 f32 operand tiles (K big and
//     small, V^T big and small: 128 KB) beside q's 128 rows (66 KB in f32):
//     one CTA per SM.  q is copied by cp.async beside the first tile; tile
//     i + 1 is copied while tile i's products run and staged while its P V
//     runs.
//   * Merges.  A slot whose visible keys lie in one chunk writes its rows
//     there; otherwise each chunk writes its rows' (acc, m, l) to the f32
//     scratch, and a second kernel of the same launch merges them in chunk
//     order, a warp a row, over the whole card.  The CUDA-core kernel's
//     ticket, whose slot's last CTA merges its tile's rows, here left one
//     SM to stream every partial of up to 128 rows from L2: 24-60 us of a
//     94-119 us launch at granite's rows (PERF.md), against a few
//     us spread over the SMs.
#pragma once

#include <type_traits>

#include "chunked_decode.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int TC_WG = 2;  // consumer warpgroups per CTA
constexpr int TC_THREADS = 128 * TC_WG;
constexpr int TC_TK = 32;  // keys per tile
static_assert(TC_ROWS == 64 * TC_WG, "a warpgroup holds 64 rows");
static_assert(CD_TABLE == TC_THREADS, "one page-table entry a thread");

// q's rows (row-major, a 16-byte pad a row), the 2-stage ring of four 32 x
// D f32 operand tiles, each row's offset in q and its keys in the chunk,
// and (paged) the chunk's page-table entries.
template <typename TQ>
__host__ __device__ constexpr int tc_q_stride() {
  return TC_D + 16 / (int)sizeof(TQ);
}
template <typename TQ, bool PAGED>
constexpr int tc_smem_bytes() {
  return TC_ROWS * tc_q_stride<TQ>() * (int)sizeof(TQ) +
         2 * 4 * TC_TK * TC_D * (int)sizeof(float) +
         TC_ROWS * (int)(sizeof(long long) + sizeof(int2)) +
         (PAGED ? CD_TABLE * (int)sizeof(int) : 0);
}

// One CTA per (KV head j and row tile, slot b, chunk z); warp w holds the
// tile's rows 16 w .. 16 w + 15, lane (g = lane / 4, tq = lane % 4) rows
// 16 w + g and 16 w + g + 8 of every accumulator (wgmma_tf32.cuh's layout).
template <typename TQ, typename TKV, bool PAGED>
__global__ void __launch_bounds__(TC_THREADS, 1)
    tc_decode_kernel(DecodeParams p) {
  constexpr int D = TC_D;
  constexpr bool SQ = std::is_same<TQ, float>::value;    // q has small parts
  constexpr bool SKV = std::is_same<TKV, float>::value;  // K, V and p do
  constexpr int VEC = 16 / sizeof(TKV);  // values in a 16-byte chunk
  constexpr int CPR = D / VEC;           // chunks per K/V row
  constexpr int UNITS = TC_TK * CPR;     // chunks per K or V tile
  constexpr int NCH = UNITS / TC_THREADS;
  constexpr int VUNITS = TC_TK / 8 * D;  // V^T staging units (k-step, col)
  constexpr int NVU = VUNITS / TC_THREADS;
  constexpr int KS = D / 8;              // k-steps of QK
  constexpr int KG = 2;                  // k-steps per wgmma group of QK
  constexpr int TILE = TC_TK * D;        // floats of one operand tile
  constexpr int LR = D * (int)sizeof(TKV) + 16;  // raw K row bytes (bf16)
  static_assert(NCH * TC_THREADS == UNITS && NVU * TC_THREADS == VUNITS,
                "whole copy and staging passes");
  static_assert(SKV || TC_TK * LR <= TILE * (int)sizeof(float),
                "a raw K tile fits its landing slot");
  constexpr int QS = tc_q_stride<TQ>();  // q's row stride in shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* qs = reinterpret_cast<TQ*>(smem);  // [TC_ROWS][QS]
  float* ring = reinterpret_cast<float*>(qs + TC_ROWS * QS);
  long long* qoff = reinterpret_cast<long long*>(ring + 2 * 4 * TILE);
  int2* qwin = reinterpret_cast<int2*>(qoff + TC_ROWS);  // each row's keys
  int* tbl = reinterpret_cast<int*>(qwin + TC_ROWS);  // paged
#ifdef CD_TRACE
  const long long cd_slot =
      16LL * (blockIdx.x +
              gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z));
  const long long cd_c0 = clock64();
  const bool cd_rec = threadIdx.x == 0 && cd_slot + 16 <= CD_TRACE_WORDS;
  if (cd_rec) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    cd_trace[cd_slot] = cd_gtime();
    cd_trace[cd_slot + 8] = smid;
  }
#endif

  const int j = blockIdx.x / p.n_tiles, tile = blockIdx.x - j * p.n_tiles;
  const int b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.H / p.KV, T = p.T, R = G * T;
  // this tile's rows [r0, r0 + RT) of the KV head's R
  const int r0 = tile * TC_ROWS, RT = min(TC_ROWS, R - r0);
  const int ps = p.page_size;

  // the chunk's page-table entries (paged), then the slot's position
  const int2 ck = chunk_keys(p, z);
  const int pg0 = ck.x / ps;
  int ent = 0;
  if (PAGED && tid < (ck.y - ck.x + ps - 1) / ps)
    ent = p.page_idx[b * p.pt_sb + pg0 + tid];
  // keys the slot may see, [lo_b, hi_b) (row 0 has the lowest window
  // bound), and this CTA's share of them, [lo, hi)
  const int pos = p.pos[b];
  const int lo_b = p.window ? max(0, pos - p.window + 1) : 0;
  const int hi_b = p.active[b] ? min(p.S, pos + T) : 0;
  const int lo = max(ck.x, lo_b), hi = min(ck.y, hi_b);
  // the slot's working chunks; every CTA of the slot counts the same
  int n_work = 0;
  for (int z0 = 0; z0 < p.n_chunks; z0 += 32) {
    bool w = false;
    if (z0 + lane < p.n_chunks) {
      const int2 c = chunk_keys(p, z0 + lane);
      w = max(c.x, lo_b) < min(c.y, hi_b);
    }
    n_work += __popc(__ballot_sync(0xffffffffu, w));
  }
  TQ* out = static_cast<TQ*>(p.out);
  auto out_row = [&](int rr) {  // the output row of the tile's row rr
    const int r = r0 + rr, g = r / T, t = r - g * T;
    return out + (((long long)b * T + t) * p.H + j * G + g) * D;
  };
  if (lo >= hi) {
    if (n_work == 0 && z == 0)  // a slot that sees no key: zeros
      for (int i = tid; i < RT * D; i += TC_THREADS)
        out_row(i / D)[i % D] = from_f<TQ>(0.f);
    CD_END();
    return;
  }
  if (PAGED) tbl[tid] = ent;
  if (tid < TC_ROWS) {  // row tid's offset in q (rows past G * T: none)
    const int row = r0 + tid, g = row / T, t = row - g * T;
    qoff[tid] = tid < RT ? b * p.q_sb + (long long)t * p.q_st +
                               (long long)(j * G + g) * p.q_sh
                         : -1;
  }
  // row tid's window: keys [qlo, qhi] of the chunk's [lo, hi) (rows past
  // G * T: any finite range)
  if (tid < TC_ROWS) {
    const int qpos = pos + (r0 + tid) % T;
    qwin[tid] = make_int2(p.window ? max(lo, qpos - p.window + 1) : lo,
                          min(qpos, hi - 1));
  }
  __syncthreads();

  // tiles on the chunk's grid of TC_TK keys (a window moves lo, not the
  // grid)
  const int lo_t = ck.x + (lo - ck.x) / TC_TK * TC_TK;
  const int ntile = (hi - lo_t + TC_TK - 1) / TC_TK;

  // K chunk u of a tile: a warp's lanes take 8 keys x 4 chunks, so each
  // quarter-warp writes 8 keys' core-matrix rows (distinct bank groups)
  auto k_unit = [](int u, int& kk, int& c) {
    const int rest = u >> 3;
    kk = 8 * (rest / CPR) + (u & 7);
    c = rest - (rest / CPR) * CPR;
  };
  // where raw K chunk (kk, c) lands in its slot: f32 in place in the
  // core-matrix layout, bf16 row-major with a 16-byte pad
  auto k_raw = [](float* slot, int kk, int c) -> TKV* {
    if constexpr (SKV)
      return reinterpret_cast<TKV*>(slot + bt_offset(kk, c));
    else
      return reinterpret_cast<TKV*>(reinterpret_cast<unsigned char*>(slot) +
                                    kk * LR) + c * VEC;
  };
  // element offset of key kpos's row of KV head j: dense, the slot's
  // stripe; paged, its page from the chunk's table
  auto key_row = [&](int kpos, long long s0, long long ss) -> long long {
    if (!PAGED) return (long long)b * s0 + (long long)kpos * ss;
    const int pg = kpos / ps;
    return (long long)tbl[pg - pg0] * s0 + (long long)(kpos - pg * ps) * ss;
  };
  // keys [k0, k0 + TC_TK) into stage st's small slots (raw); rows outside
  // [lo, hi) are zero-filled without a read
  auto load_tile = [&](int k0, int st) {
    const int tid = thread_index();
    const TKV* kg = static_cast<const TKV*>(p.k) + j * p.k_sh;
    const TKV* vg = static_cast<const TKV*>(p.v) + j * p.v_sh;
    float* kl = ring + (st * 4 + 1) * TILE;
    TKV* vl = reinterpret_cast<TKV*>(ring + (st * 4 + 3) * TILE);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int u = tid + i * TC_THREADS;
      int kk, c;
      k_unit(u, kk, c);
      int kpos = k0 + kk;
      bool in = kpos >= lo && kpos < hi;
      cp_async16(k_raw(kl, kk, c),
                 kg + (in ? key_row(kpos, p.k_s0, p.k_ss) + c * VEC : 0), in);
      kk = u / CPR;  // V: row-major, the lanes along a row
      c = u - kk * CPR;
      kpos = k0 + kk;
      in = kpos >= lo && kpos < hi;
      cp_async16(vl + kk * D + c * VEC,
                 vg + (in ? key_row(kpos, p.v_s0, p.v_ss) + c * VEC : 0), in);
    }
  };
  // stage st's raw tile (landed) into its operand tiles: K big/small in
  // the core layout (a thread stages the chunks it copied; an f32 chunk is
  // read and rewritten in place), then V^T big/small, keys permuted within
  // each 8-key step (k index t = key 2t, k index t + 4 = key 2t + 1); an
  // f32 V's small parts overwrite the raw tile other threads still read,
  // so every thread reads its share first.  Last, a fence for wgmma.
  auto stage_tile = [&](int st) {
    const int tid = thread_index();
    float* kb = ring + st * 4 * TILE;
    float* ksm = kb + TILE;
    float* vb = kb + 2 * TILE;
    float* vsm = kb + 3 * TILE;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int u = tid + i * TC_THREADS;
      int kk, c;
      k_unit(u, kk, c);
      float kf[VEC];
      Chunk<TKV>::get(*reinterpret_cast<const uint4*>(k_raw(ksm, kk, c)), kf);
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
    const TKV* vl = reinterpret_cast<const TKV*>(vsm);
    float vf[NVU][8];
#pragma unroll
    for (int i = 0; i < NVU; ++i) {
      const int u = tid + i * TC_THREADS;
      const int ks = u / D, col = u - ks * D;
#pragma unroll
      for (int e = 0; e < 8; ++e) vf[i][e] = to_f(vl[(8 * ks + e) * D + col]);
    }
    if constexpr (SKV) __syncthreads();
#pragma unroll
    for (int i = 0; i < NVU; ++i) {
      const int u = tid + i * TC_THREADS;
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
    fence_proxy_async();  // the generic-proxy writes, seen by wgmma
  };

  // the first tile's copy and q's rows, row-major with a 16-byte pad (its
  // A fragments' loads then hit 32 distinct banks), by 16-byte cp.async
  // (the wrapper checks q's rows start on 16 bytes); rows past G * T are
  // zero-filled
  load_tile(lo_t, 0);
  CD_MARK(11);
  {
    constexpr int PER = 16 / (int)sizeof(TQ);  // elements a copy moves
    constexpr int CPQ = D / PER;               // copies a row
    const TQ* q = static_cast<const TQ*>(p.q);
#pragma unroll
    for (int it = 0; it < TC_ROWS * CPQ / TC_THREADS; ++it) {
      const int idx = tid + it * TC_THREADS;
      const int r = idx / CPQ, c = (idx - r * CPQ) * PER;
      const long long off = qoff[r];
      cp_async16(qs + r * QS + c, q + (off < 0 ? 0 : off + c), off >= 0);
    }
  }
  CD_MARK(2);
  cp_async_wait_all();
  __syncthreads();
  stage_tile(0);
  CD_MARK(3);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this lane's part
  const float scale = 1.0f / sqrtf((float)D);
  // this lane's rows of the tile, 16 warp + g + 8 h, from the thread's
  // index where used (held through the loop they would cost registers the
  // products use)
  auto cta_row = [](int h) {
    return (thread_index() >> 5) * 16 + ((thread_index() & 31) >> 2) + 8 * h;
  };
  int st = 0;
  for (int it = 0; it < ntile; ++it, st ^= 1) {
    const int k0 = lo_t + it * TC_TK;
    // tile it is staged by every thread, and every wgmma of the last tile
    // has completed: the next tile's copies go to the other stage and fly
    // while this tile's products run
    __syncthreads();
    if (it == 1) CD_MARK(10);
    if (it == ntile - 1) CD_MARK(4);
    const bool more = it + 1 < ntile;
    if (more) load_tile(k0 + TC_TK, st ^ 1);
    const float* kb = ring + st * 4 * TILE;
    const float* ksm = kb + TILE;
    const float* vb = kb + 2 * TILE;
    const float* vsm = kb + 3 * TILE;
    Frag<4, SKV> pa[TC_TK / 8];
    float pv[D / 2];
    {
      // S = q K^T over D, KG k-steps a group; the q fragments of two
      // groups stay alive (the last group's until its wgmma are done).
      // Every warpgroup multiplies, its rows past G * T on zeros: a
      // warpgroup that skipped its products would serialize every wgmma
      // (ptxas: a dependence in a divergent path)
      float s[16];
      Frag<4, SQ> qa[2][KG];
      // lane (g, t)'s values of a k-step: (row g, k t), (row g + 8, k t),
      // (row g, k t + 4), (row g + 8, k t + 4) of its warp's 16 rows
      const TQ* qf = qs + ((thread_index() >> 5) * 16 +
                           ((thread_index() & 31) >> 2)) * QS +
                     (thread_index() & 3);
#pragma unroll
      for (int kg = 0; kg < KS / KG; ++kg) {
#pragma unroll
        for (int u = 0; u < KG; ++u) {
          const TQ* x = qf + 8 * (kg * KG + u);
          qa[kg & 1][u].set(0, to_f(x[0]));
          qa[kg & 1][u].set(1, to_f(x[8 * QS]));
          qa[kg & 1][u].set(2, to_f(x[4]));
          qa[kg & 1][u].set(3, to_f(x[8 * QS + 4]));
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
      if (it == 1) CD_MARK(12);

      // online softmax of rows g (h = 0) and g + 8 (h = 1): element 4 n +
      // 2 h + e of S is key k0 + 8 n + 2 tq + e; p overwrites s.  Row r's
      // keys: kpos <= pos + r % T inside the window and the chunk's [lo,
      // hi), qwin[r]
      const int tq = thread_index() & 3;
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int2 win = qwin[cta_row(h)];
        float mx = NEG_INF;
        unsigned ok = 0;
#pragma unroll
        for (int n = 0; n < TC_TK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * n + 2 * tq + e;
            const bool seen = kpos >= win.x && kpos <= win.y;
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
        for (int n = 0; n < TC_TK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * n + 2 * h + e];
            const float pr =
                (ok >> (2 * n + e)) & 1u ? __expf(x - m_new) : 0.f;
            sum += pr;
            x = to_f(from_f<TKV>(pr));  // p rounded to v's dtype
          }
        l[h] = l[h] * alpha[h] + sum;  // l sums the unrounded p
      }
      // O's rows rescaled where their max moved (alpha = 1 is exact: a
      // warp whose 16 rows all kept theirs skips the multiplies)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[4 * c + i] *= alpha[i >> 1];
      }

      // P V: k-step n is keys 8 n .. 8 n + 7, A's k index tq holding key
      // 2 tq and k index tq + 4 key 2 tq + 1, as V^T was staged; summed in
      // fresh registers, added to O below
#pragma unroll
      for (int n = 0; n < TC_TK / 8; ++n) {
        pa[n].set(0, s[4 * n]);
        pa[n].set(1, s[4 * n + 2]);
        pa[n].set(2, s[4 * n + 1]);
        pa[n].set(3, s[4 * n + 3]);
      }
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < TC_TK / 8; ++n) {
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
      if (it == 1) CD_MARK(13);
    }
    if (more) {  // the next tile, staged while this tile's P V runs
      cp_async_wait_all();
      __syncthreads();
      stage_tile(st ^ 1);
    }
    if (it == 1) CD_MARK(14);
    {
      wgmma_wait<0>();
      fence_regs(pv);
#pragma unroll
      for (int n = 0; n < TC_TK / 8; ++n) {
        fence_regs(pa[n].big);
        if constexpr (SKV) fence_regs(pa[n].small);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] += pv[i];
    }
    if (it == 1) CD_MARK(15);
  }
  CD_MARK(5);
#ifdef CD_TRACE
  if (cd_rec) cd_trace[cd_slot + 9] = n_work | (ntile << 16);
#endif

  // each row's l: its quad's parts (every lane of the quad gets the same
  // sum); this lane's columns of a row are 8 c + 2 tq + e, held in
  // o[4 c + 2 h + e]
  const int tq = tid & 3;
  float lr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lr[h] = l[h];
    lr[h] += __shfl_xor_sync(0xffffffffu, lr[h], 1);
    lr[h] += __shfl_xor_sync(0xffffffffu, lr[h], 2);
  }
  const long long base = ((long long)b * p.KV + j) * p.n_chunks;
  if (n_work == 1) {  // the slot's only chunk: the output itself
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = cta_row(h);
      if (rr >= RT) continue;
      TQ* dst = out_row(rr);
      const float den = fmaxf(lr[h], 1e-30f);
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        store2(dst + 8 * c + 2 * tq, o[4 * c + 2 * h] / den,
               o[4 * c + 2 * h + 1] / den);
    }
    CD_END();
    return;
  }
  // scratch rows of (b, j): chunk z's row r0 + rr at (base + z) * R + r0 +
  // rr, merged by tc_decode_combine_kernel
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = cta_row(h);
    if (rr >= RT) continue;
    const long long row = (base + z) * R + r0 + rr;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      store2(p.o_part + row * D + 8 * c + 2 * tq, o[4 * c + 2 * h],
             o[4 * c + 2 * h + 1]);
    if (tq == 0) {
      p.ml_part[2 * row] = m[h];
      p.ml_part[2 * row + 1] = lr[h];
    }
  }
  CD_MARK(6);
  CD_END();
}

// The merge of the slots whose keys span more than one working chunk: a
// warp a row (row blockIdx.x * 8 + warp of KV head blockIdx.y, slot
// blockIdx.z), lane l its CPL = D / 32 columns CPL l .. CPL l + CPL - 1
// (4 at head dim 128, 2 at 64).  The row's max over the chunks, then each
// chunk's weight exp(m_i - max) and the sums in chunk order, 32 chunks'
// partials read at once.  A chunk that holds none of the row's keys has
// (0, NEG_INF, 0) and adds exactly 0.
template <typename TQ, int D>
__global__ void __launch_bounds__(TC_THREADS)
    tc_decode_combine_kernel(DecodeParams p) {
  constexpr int CPL = D / 32;
  static_assert(CPL == 4 || CPL == 2, "a lane's columns: 16 or 8 bytes");
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV, T = p.T, R = G * T;
  const int r = blockIdx.x * (TC_THREADS / 32) + (threadIdx.x >> 5);
  if (r >= R) return;
  const int pos = p.pos[b];
  const int lo_b = p.window ? max(0, pos - p.window + 1) : 0;
  const int hi_b = p.active[b] ? min(p.S, pos + T) : 0;
  auto working = [&](int z) {
    if (z >= p.n_chunks) return false;
    const int2 c = chunk_keys(p, z);
    return max(c.x, lo_b) < min(c.y, hi_b);
  };
  int n_work = 0;
  for (int z0 = 0; z0 < p.n_chunks; z0 += 32)
    n_work += __popc(__ballot_sync(0xffffffffu, working(z0 + lane)));
  if (n_work <= 1) return;  // the decode kernel wrote the row
  const long long base = ((long long)b * p.KV + j) * p.n_chunks;
  const float2* ml = reinterpret_cast<const float2*>(p.ml_part);
  float ms = NEG_INF;
  for (int z0 = 0; z0 < p.n_chunks; z0 += 32)
    if (working(z0 + lane))
      ms = fmaxf(ms, __ldcg(ml + (base + z0 + lane) * R + r).x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ms = fmaxf(ms, __shfl_xor_sync(0xffffffffu, ms, off));
  float num[CPL] = {}, den = 0.f;
  for (int z0 = 0; z0 < p.n_chunks; z0 += 32) {
    const bool w = working(z0 + lane);
    const unsigned mask = __ballot_sync(0xffffffffu, w);
    float e = 0.f, l = 0.f;
    if (w) {
      const float2 x = __ldcg(ml + (base + z0 + lane) * R + r);
      e = expf(x.x - ms);
      l = x.y;
    }
    float x[32][CPL];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (!(mask >> i & 1u)) continue;
      const float* src = p.o_part + ((base + z0 + i) * R + r) * D + CPL * lane;
      if constexpr (CPL == 4) {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(src));
        x[i][0] = a.x; x[i][1] = a.y; x[i][2] = a.z; x[i][3] = a.w;
      } else {
        const float2 a = __ldcg(reinterpret_cast<const float2*>(src));
        x[i][0] = a.x; x[i][1] = a.y;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float ei = __shfl_sync(0xffffffffu, e, i);
      const float li = __shfl_sync(0xffffffffu, l, i);
      if (mask >> i & 1u) {
        den += li * ei;
#pragma unroll
        for (int c = 0; c < CPL; ++c) num[c] += x[i][c] * ei;
      }
    }
  }
  const float dn = fmaxf(den, 1e-30f);
  float y[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) y[c] = num[c] / dn;
  const int g = r / T, t = r - g * T;
  TQ* dst = static_cast<TQ*>(p.out) +
            (((long long)b * T + t) * p.H + j * G + g) * D + CPL * lane;
  if constexpr (CPL == 4)
    store4(dst, y);
  else
    store2(dst, y[0], y[1]);
}

// The merge kernel of a launch on the tensor-core routes at head dim D, a
// CTA per 8 rows of a (KV head, slot).
template <typename TQ, int D>
cudaError_t launch_decode_merge(const DecodeParams& p, cudaStream_t st) {
  const int rows = p.H / p.KV * p.T;
  const dim3 merge((rows + TC_THREADS / 32 - 1) / (TC_THREADS / 32), p.KV,
                   p.B);
  tc_decode_combine_kernel<TQ, D><<<merge, TC_THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

// The route's launch: rows in n_tiles tiles of TC_ROWS (decode_attention
// .row_tiles on the "tensor_cores" route), grid (KV * n_tiles, B, chunks),
// then the merge.
template <typename TQ, typename TKV, bool PAGED>
cudaError_t launch_tc_decode(const DecodeParams& p, cudaStream_t st) {
  constexpr int smem = tc_smem_bytes<TQ, PAGED>();
  // above 48 KB dynamic shared memory must be allowed explicitly, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      tc_decode_kernel<TQ, TKV, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.KV * p.n_tiles, p.B, p.n_chunks);
  tc_decode_kernel<TQ, TKV, PAGED><<<grid, TC_THREADS, smem, st>>>(p);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : launch_decode_merge<TQ, TC_D>(p, st);
}

}  // namespace
