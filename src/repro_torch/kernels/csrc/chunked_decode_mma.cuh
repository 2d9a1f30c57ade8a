// The chunked decode kernel's warp-mma route for Hopper (sm_90a): the dense
// and paged decode (and split-K decode) of chunked_decode.cuh at the
// groupings whose G * T query rows a KV head are few (G = 2, 4, 5 at head
// dim 128, and every G at head dim 64 -- musicgen's G = 1 -- on f32 and
// bf16 pools: decode_attention.decode_route), with each key tile's scores
// and P V on warp-level tensor-core products (mma.sync m16n8k8 TF32).  It
// replaces the same TPU kernels as chunked_decode.cuh (decode_attention_tpu,
// its split-K, and their paged twins) on those rows.  Head dim 128 splits
// D over the warps (mma_decode_kernel, below); head dim 64 splits the keys
// (mma64_decode_kernel, at the end of the file).
//
// What bounds it on an H100: device-memory bytes, as the CUDA-core kernel.
// A KV head's 2-20 rows read each key once and do 4 D flops a row with it:
// 2-10 flops a byte, under the CUDA cores' balance (66.9 TFLOP/s over 3.35
// TB/s = 20).  But on the CUDA cores each row's share of a key tile is a
// q read, a shuffle tree to finish the dot, the row's max and sum and four
// FMAs a key in P V: 8 rows cost 1.8x 2 rows, 16 rows 3.8x 4 (PERF.md),
// and the verify blocks ran at 11-31% of their bytes.  The wgmma route's
// 128-row tiles lost at these groupings (2-5 live rows of 128).
//
// What the design does about it, keeping of the CUDA-core kernel the grid
// (KV head and row tile, slot, chunk) from the shapes alone, the page
// table read first, its 3-stage cp.async ring of TK-key tiles (16 keys in
// f32, 32 in bf16: four CTAs an SM at one block of rows) and the
// zero-fill, and merging the chunks' (acc, m, l) in chunk order as the wgmma route
// does, in its second kernel (tc_decode_combine_kernel, a warp a row over
// the card; tickets unused).  In the slot's last CTA that merge took 9.6k
// cycles at 2 rows, 17.7k at 8 and 36k at 20, the launch's tail
// (scripts/decode_trace.py); the second kernel made every row faster, the
// one-token ones too (PERF.md):
//   * Keys on M, rows on N.  S^T (keys x rows) = K q^T per 16-key m-tile,
//     the rows in blocks of 8 columns (NB blocks: the instances of 8, 16
//     and 32 columns; rows past G * T are zero columns and store nothing,
//     a block of them no product), so 2-8 rows cost one block's products.
//     Each warp owns a quarter of D, 32 d: its S^T over them (four
//     k-steps) and, in P V, O^T (D x rows) = V^T P^T on the same d (two
//     m16 tiles).  f32 operands in 3xTF32 (small.big + big.small +
//     big.big); bf16 K and V are exact in TF32 and need no small part, nor
//     does p once rounded to bf16.
//   * The four warps' S^T quarters meet in shared memory, summed in warp
//     order and read back transposed: lane (g, t) then holds row g's
//     scores of keys 2t, 2t + 1, 2t + 8, 2t + 9 of each m-tile, which are
//     both its online-softmax values (max over the row's quad of lanes,
//     two shuffles; l a lane's own part, summed over the quad at the end)
//     and its P^T B fragment, the k8 step's keys permuted (k index t is
//     key 2t, t + 4 is 2t + 1) as V^T's A fragment reads them.  Every warp
//     computes the same (m, l) from the same sums, so a chunk needs no
//     merge of its warps.  Each tile's P V is summed in fresh registers
//     and added to O in f32 (O as the accumulator across tiles put
//     qwen3-moe's logits past their tolerance in the many-row kernel).
//   * Bank-conflict-free operand reads: the ring's 16-byte chunk c of key
//     row kk lies at c ^ mma_swz(kk); a lane's K fragment is 8 contiguous
//     d of one key (the k-steps' k indices permuted alike in q's B
//     fragment), its V fragment 4 contiguous d of one key.
//   * Rows that do not depend on T, their column, block, instance or row
//     tile: a row's products, its quad's shuffles and the warp order of the
//     S sum see only its own q and the keys, tiles start at multiples of
//     TK from the chunk's start, and the row's own mask (kpos <= its
//     position, inside the window and the chunk) selects before the exp.
//     So a verify row t is bitwise the T = 1 launch at pos + t, and a
//     slot's rows are the same alone and in a batch; split-K at whole
//     chunks is the single pass.
#pragma once

#include <type_traits>

#include "chunked_decode.cuh"

namespace {

constexpr int MMA_COLS = 8;  // query rows of a block of N columns

// CTAs an SM should hold: four (as the CUDA-core decode) at one block of
// columns; more blocks keep more q fragments and accumulators.
__host__ __device__ constexpr int mma_min_ctas(int nb) {
  return nb > 2 ? 2 : nb > 1 ? 3 : 4;
}

// Where a ring tile's 16-byte chunk c of key row kk lies: c ^ mma_swz(kk).
// The K fragment reads (keys g, g + 1 of an even g a quarter-warp, 4 tq
// each) and the V fragment reads (4 keys 2t + c, the lanes' d) then hit
// distinct banks in each 128-byte wavefront, f32 and bf16.
__device__ __forceinline__ int mma_swz(int kk) {
  return (kk & 7) ^ ((kk & 1) << 2);
}

// D = A B + D: mma.m16n8k8 with TF32 operands and f32 accumulation.  A's
// lane (g, t) holds (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
// B's (k t, col g), (k t + 4, col g); D's (g, 2t), (g, 2t + 1), (g + 8,
// 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N operand values as TF32 registers: (SPLIT, f32 values) the big part x
// with its low 13 bits cleared and the remainder x - big (exact) as it is;
// a TF32 operand's low 13 bits are not read, so the product keeps the
// remainder's top 11 bits, within 2^-20 |x|.  Two operations a value, three
// fewer than attention_common.cuh's Frag (both parts rounded): at four CTAs
// an SM a tile's instructions take about the tile's whole period
// (scripts/decode_trace.py).  Values exact in TF32 (bf16) pass as they
// are.
template <int N, bool SPLIT>
struct MmaFrag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(int i, float x) {
    big[i] = __float_as_uint(x) & (SPLIT ? 0xffffe000u : 0xffffffffu);
    if (SPLIT) small[i] = __float_as_uint(x - __uint_as_float(big[i]));
  }
};

// 3xTF32 (or fewer products where an operand has no small part): d +=
// a_small.b_big + a_big.b_small + a_big.b_big, in that order.
template <bool SA, bool SB>
__device__ __forceinline__ void mma_x3(float* d, const MmaFrag<4, SA>& a,
                                       const uint32_t* bb,
                                       const uint32_t* bs) {
  if (SA) mma_tf32(d, a.small, bb[0], bb[1]);
  if (SB) mma_tf32(d, a.big, bs[0], bs[1]);
  mma_tf32(d, a.big, bb[0], bb[1]);
}

// Shared memory: the ring [stage][K | V][TK][D], the warps' S^T quarters
// [warp][block][m-tile][row][16 keys] and (paged) the chunk's table.
template <typename TKV, int NB>
__host__ __device__ constexpr int mma_exch_floats() {
  return CD_WARPS * NB * (cd_tile_keys<TKV>() / 16) * MMA_COLS * 16;
}
template <typename TKV, int NB, bool PAGED>
constexpr int mma_smem_bytes() {
  return CD_STAGES * 2 * cd_tile_keys<TKV>() * TC_D * (int)sizeof(TKV) +
         mma_exch_floats<TKV, NB>() * 4 + (PAGED ? CD_TABLE * 4 : 0);
}

// One CTA per (KV head j and row tile, slot b, chunk z), as the CUDA-core
// kernel's; block nb's column c is the tile's row 8 nb + c.  Warp w owns
// d in [WD w, WD w + WD), WD = D / 4 = 32; lane (g, t) holds row g of each
// block in the softmax, and rows 2t, 2t + 1 of each block in O^T at d
// WD w + VPL g .. + VPL - 1 (VPL = WD / 8 = 2 MI).
template <typename TQ, typename TKV, int NB, bool PAGED, bool TILED>
__global__ void __launch_bounds__(CD_THREADS, mma_min_ctas(NB))
    mma_decode_kernel(DecodeParams p) {
  constexpr int D = TC_D;
  constexpr int WD = D / CD_WARPS;          // a warp's d
  constexpr int KS = WD / 8;                // its k-steps of S^T
  constexpr int KPL = WD / 4;               // a lane's d of a K row, 2 KS
  constexpr int MI = WD / 16;               // its m16 tiles of O^T
  constexpr int VPL = 2 * MI;               // a lane's d of a V row
  constexpr int TK = cd_tile_keys<TKV>();   // keys a ring stage
  constexpr int MT = TK / 16;               // m16 key tiles a stage
  constexpr int VEC = 16 / sizeof(TKV);     // values in 16 bytes
  constexpr int VPR = D / VEC;              // 16-byte chunks a row
  constexpr int NCP = TK * VPR / CD_THREADS;  // cp.async a thread a tile
  constexpr bool SQ = std::is_same<TQ, float>::value;   // q has small parts
  constexpr bool SKV = std::is_same<TKV, float>::value;  // K, V and p do
  static_assert(NCP * CD_THREADS == TK * VPR && MT * 16 == TK &&
                    KPL % VEC == 0 && VPL == 4,
                "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ring = reinterpret_cast<TKV*>(smem);
  float* exch = reinterpret_cast<float*>(smem + CD_STAGES * 2 * TK * D *
                                                    (int)sizeof(TKV));
  int* tbl = reinterpret_cast<int*>(exch + mma_exch_floats<TKV, NB>());
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

  const int j = TILED ? blockIdx.x / p.n_tiles : blockIdx.x;
  const int tile = TILED ? blockIdx.x - j * p.n_tiles : 0;
  const int b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int G = p.H / p.KV, T = p.T, R = G * T;
  // this tile's rows [r0, r0 + RT) of the KV head's R
  const int r0 = TILED ? tile * p.row_tile : 0;
  const int RT = TILED ? min(p.row_tile, R - r0) : R;
  const int ps = p.page_size;

  // the chunk's page-table entries (paged) and the lane's q fragments,
  // issued before the slot's position is known: row 8 nb + g, d = WD warp
  // + KPL tq + i, k-step s's k index tq being i = 2 s and tq + 4 i = 2 s + 1
  const int2 ck = chunk_keys(p, z);
  const int pg0 = ck.x / ps;
  int ent[CD_TABLE / CD_THREADS];
  if (PAGED) {
    const int npg = (ck.y - ck.x + ps - 1) / ps;
    const int* trow = p.page_idx + b * p.pt_sb + pg0;
#pragma unroll
    for (int i = 0; i < CD_TABLE / CD_THREADS; ++i) {
      const int e = tid + i * CD_THREADS;
      ent[i] = e < npg ? trow[e] : 0;
    }
  }
  const TQ* q = static_cast<const TQ*>(p.q) + b * p.q_sb;
  uint32_t qb[NB][KPL], qsm[NB][KPL];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int rr = nb * MMA_COLS + g, r = r0 + rr;
    const int gh = r / T, t = r - gh * T;
    const TQ* qr = q + t * p.q_st + (j * G + gh) * p.q_sh + WD * warp +
                   KPL * tq;
    MmaFrag<KPL, SQ> f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) f.set(i, rr < RT ? to_f(qr[i]) : 0.f);
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      qb[nb][i] = f.big[i];
      qsm[nb][i] = SQ ? f.small[i] : 0u;
    }
  }

  // keys the slot may see, [lo_b, hi_b) (row 0 has the lowest window
  // bound), and this CTA's share of them, [lo, hi)
  const int pos = p.pos[b];
  const int lo_b = p.window ? max(0, pos - p.window + 1) : 0;
  const int hi_b = p.active[b] ? min(p.S, pos + T) : 0;
  const int lo = max(ck.x, lo_b), hi = min(ck.y, hi_b);
  const int n_work = cd_working_chunks(p, lo_b, hi_b);
  TQ* out = static_cast<TQ*>(p.out);
  auto out_row = [&](int rr) {  // the output row of the tile's row rr
    const int r = r0 + rr, gh = r / T, t = r - gh * T;
    return out + (((long long)b * T + t) * p.H + j * G + gh) * D;
  };
  if (lo >= hi) {
    if (n_work == 0 && z == 0)  // a slot that sees no key: zeros
      for (int rr = 0; rr < RT; ++rr) out_row(rr)[tid] = from_f<TQ>(0.f);
    CD_END();
    return;
  }
  if (PAGED) {
#pragma unroll
    for (int i = 0; i < CD_TABLE / CD_THREADS; ++i)
      tbl[tid + i * CD_THREADS] = ent[i];
    __syncthreads();
  }
  CD_MARK(2);

  // key rows of this (slot, KV head): (page, token) of key kpos, dense:
  // (0, kpos) from the slot's own base
  const long long slot = PAGED ? 0 : b;
  const TKV* kbase = static_cast<const TKV*>(p.k) + j * p.k_sh + slot * p.k_s0;
  const TKV* vbase = static_cast<const TKV*>(p.v) + j * p.v_sh + slot * p.v_s0;
  auto row_of = [&](int kpos) {
    if (!PAGED) return make_longlong2(0, kpos);
    const int pg = kpos / ps;
    return make_longlong2(tbl[pg - pg0], kpos - pg * ps);
  };
  // tiles on the chunk's grid of TK keys (a window moves lo, not the grid)
  const int lo_t = ck.x + (lo - ck.x) / TK * TK;
  const int ntile = (hi - lo_t + TK - 1) / TK;
  // keys [lo_t + t * TK, + TK) into stage t % CD_STAGES, swizzled; keys
  // outside [lo, hi) are zero-filled
  auto issue = [&](int t) {
    TKV* Ks = ring + (t % CD_STAGES) * 2 * TK * D;
    TKV* Vs = Ks + TK * D;
    const int k0 = lo_t + t * TK;
#pragma unroll
    for (int i = 0; i < NCP; ++i) {
      const int idx = tid + i * CD_THREADS;
      const int kk = idx / VPR, c = idx - kk * VPR;
      const int kpos = k0 + kk;
      const bool in = kpos >= lo && kpos < hi;
      long long ko = 0, vo = 0;
      if (in) {
        const longlong2 r = row_of(kpos);
        ko = r.x * p.k_s0 + r.y * p.k_ss + c * VEC;
        vo = r.x * p.v_s0 + r.y * p.v_ss + c * VEC;
      }
      const int at = kk * D + (c ^ mma_swz(kk)) * VEC;
      cp_async16(Ks + at, kbase + ko, in);
      cp_async16(Vs + at, vbase + vo, in);
    }
  };
#pragma unroll
  for (int t = 0; t < CD_STAGES - 1; ++t) {
    if (t < ntile) issue(t);
    cp_async_commit();
  }

  // the lane's scores of row g in an m-tile: keys 16 mt + kq[e] (the
  // exchange's transposed read, below)
  const int kq[4] = {2 * tq, 2 * tq + 8, 2 * tq + 1, 2 * tq + 9};
  // the keys [wlo, whi] the lane's row g of each block sees: kpos <= its
  // position, inside the window and before hi (keys below lo lie outside
  // every row's window); none for a row past the tile's
  int wlo[NB], whi[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int rr = nb * MMA_COLS + g, qpos = pos + (r0 + rr) % T;
    wlo[nb] = p.window ? qpos - p.window + 1 : 0;
    whi[nb] = rr < RT ? min(qpos, hi - 1) : -1;
  }
  float o[NB][MI][4], m[NB], l[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    m[nb] = NEG_INF;
    l[nb] = 0.f;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[nb][i][c] = 0.f;
  }
  const float scale = 1.0f / sqrtf((float)D);
  auto chunk_at = [](int kk, int d) {  // element d of key row kk, swizzled
    return kk * D + ((d / VEC) ^ mma_swz(kk)) * VEC + d % VEC;
  };
  for (int t = 0; t < ntile; ++t) {
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose stage the next copies refill, and with its scores
    cp_async_wait<CD_STAGES - 2>();
    __syncthreads();
    if (t == 0) CD_MARK(3);
    if (t == 1) CD_MARK(10);
    if (t == ntile - 1) CD_MARK(4);
    if (t + CD_STAGES - 1 < ntile) issue(t + CD_STAGES - 1);
    cp_async_commit();
    const TKV* Ks = ring + (t % CD_STAGES) * 2 * TK * D;
    const TKV* Vs = Ks + TK * D;
    const int k0 = lo_t + t * TK;

    // this warp's quarter of S^T: keys 16 mt + g (+ 8) of each m-tile
    // against each live block's rows, over d in [WD warp, + WD)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      MmaFrag<4, SKV> ka[KS];  // k-step ks: keys g, g + 8; i 2 ks, 2 ks + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x[KPL];  // key 16 mt + g + 8 h, d WD warp + KPL tq + i
#pragma unroll
        for (int c = 0; c < KPL / VEC; ++c)
          Chunk<TKV>::get(*reinterpret_cast<const uint4*>(
                              Ks + chunk_at(16 * mt + g + 8 * h,
                                            WD * warp + KPL * tq + c * VEC)),
                          x + c * VEC);
#pragma unroll
        for (int e = 0; e < KPL; ++e) ka[e >> 1].set(h + 2 * (e & 1), x[e]);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb * MMA_COLS >= RT) continue;  // a block of padding only
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          mma_x3<SKV, SQ>(acc, ka[ks], &qb[nb][2 * ks], &qsm[nb][2 * ks]);
        // to the exchange, key k of row r at r * 16 + 4 ((k & 7) >> 1) +
        // 2 (k & 1) + (k >> 3): (key g, key g + 8) side by side
        float* e = exch + ((warp * NB + nb) * MT + mt) * MMA_COLS * 16;
        *reinterpret_cast<float2*>(e + 2 * tq * 16 + 2 * g) =
            make_float2(acc[0], acc[2]);
        *reinterpret_cast<float2*>(e + (2 * tq + 1) * 16 + 2 * g) =
            make_float2(acc[1], acc[3]);
      }
    }
    if (t == 1) CD_MARK(12);
    __syncthreads();
    if (t == 1) CD_MARK(13);

    // row g's scores (the warps' quarters summed in warp order) of keys
    // 16 mt + kq[e], the online softmax over them, p for P V
    float pr[NB][MT][4], alpha[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      if (nb * MMA_COLS >= RT) continue;
      float mx = NEG_INF;
      unsigned ok = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float x[4];
#pragma unroll
        for (int w = 0; w < CD_WARPS; ++w) {
          const float4 v = *reinterpret_cast<const float4*>(
              exch + ((w * NB + nb) * MT + mt) * MMA_COLS * 16 + g * 16 +
              4 * tq);
          if (w == 0) {
            x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
          } else {
            x[0] += v.x; x[1] += v.y; x[2] += v.z; x[3] += v.w;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 16 * mt + kq[e];
          const bool seen = kpos >= wlo[nb] && kpos <= whi[nb];
          pr[nb][mt][e] = seen ? x[e] * scale : NEG_INF;
          ok |= (unsigned)seen << (4 * mt + e);
          mx = fmaxf(mx, pr[nb][mt][e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[nb], mx);
      const float a = __expf(m[nb] - m_new);  // exactly 1 where m holds
      float sum = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex =
              (ok >> (4 * mt + e)) & 1u ? __expf(pr[nb][mt][e] - m_new)
                                        : 0.f;
          sum += ex;
          pr[nb][mt][e] = to_f(from_f<TKV>(ex));  // p rounded to v's dtype
        }
      l[nb] = l[nb] * a + sum;  // this lane's keys; l sums the unrounded p
      m[nb] = m_new;
      // O's rows 2 tq and 2 tq + 1 take the alpha of rows g = 2 tq, 2 tq + 1
      alpha[nb][0] = __shfl_sync(0xffffffffu, a, 8 * tq);
      alpha[nb][1] = __shfl_sync(0xffffffffu, a, 8 * tq + 4);
    }
    if (t == 1) CD_MARK(14);

    // P V on this warp's d: k-step u of m-tile mt is keys 16 mt + 8 u +
    // 2 tq (k index tq) and + 1 (tq + 4); D m-tile i's row g is d WD warp
    // + VPL g + 2 i and its row g + 8 d + 1; summed in fresh registers,
    // added to O
    float pv[NB][MI][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) pv[nb][i][c] = 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        MmaFrag<4, SKV> va[MI];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float vf[VPL];
          load4(Vs + chunk_at(16 * mt + 8 * u + 2 * tq + c,
                              WD * warp + VPL * g), vf);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            va[i].set(2 * c, vf[2 * i]);
            va[i].set(2 * c + 1, vf[2 * i + 1]);
          }
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if (nb * MMA_COLS >= RT) continue;
          // B: (key 2 tq, row g), (key 2 tq + 1, row g) of the k-step
          MmaFrag<2, SKV> pb;
          pb.set(0, pr[nb][mt][u]);
          pb.set(1, pr[nb][mt][u + 2]);
#pragma unroll
          for (int i = 0; i < MI; ++i)
            mma_x3<SKV, SKV>(pv[nb][i], va[i], pb.big, pb.small);
        }
      }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[nb][i][c] = o[nb][i][c] * alpha[nb][c & 1] + pv[nb][i][c];
    if (t == 1) CD_MARK(15);
  }
  CD_MARK(5);
#ifdef CD_TRACE
  if (cd_rec) cd_trace[cd_slot + 9] = n_work | (ntile << 16);
#endif

  // each row's l: its quad's parts; then the rows 2 tq + h of O's layout,
  // d WD warp + VPL g + 2 i + e: o[.][i][h + 2 e]
  const long long base = ((long long)b * p.KV + j) * p.n_chunks;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    l[nb] += __shfl_xor_sync(0xffffffffu, l[nb], 1);
    l[nb] += __shfl_xor_sync(0xffffffffu, l[nb], 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = nb * MMA_COLS + 2 * tq + h;
      const float lr = __shfl_sync(0xffffffffu, l[nb], 8 * tq + 4 * h);
      float y[VPL];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        y[2 * i] = o[nb][i][h];
        y[2 * i + 1] = o[nb][i][h + 2];
      }
      if (rr >= RT) continue;
      const int d0 = WD * warp + VPL * g;
      if (n_work == 1) {  // the slot's only chunk: the output itself
        const float den = fmaxf(lr, 1e-30f);
#pragma unroll
        for (int c = 0; c < VPL; ++c) y[c] /= den;
        store4(out_row(rr) + d0, y);
      } else {  // scratch: chunk z's row r0 + rr at (base + z) * R + r0 + rr
        store4(p.o_part + ((base + z) * R + r0 + rr) * D + d0, y);
      }
    }
    const int rr = nb * MMA_COLS + g;
    if (n_work > 1 && warp == 0 && tq == 0 && rr < RT) {
      const long long row = (base + z) * R + r0 + rr;
      p.ml_part[2 * row] = m[nb];
      p.ml_part[2 * row + 1] = l[nb];
    }
  }
  CD_MARK(6);
  CD_END();
}

template <typename TQ, typename TKV, int NB, bool PAGED, bool TILED>
cudaError_t launch_mma_rows(const DecodeParams& p, cudaStream_t st) {
  constexpr int smem = mma_smem_bytes<TKV, NB, PAGED>();
  // above 48 KB dynamic shared memory must be allowed explicitly, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      mma_decode_kernel<TQ, TKV, NB, PAGED, TILED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.KV * p.n_tiles, p.B, p.n_chunks);
  mma_decode_kernel<TQ, TKV, NB, PAGED, TILED>
      <<<grid, CD_THREADS, smem, st>>>(p);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : launch_decode_merge<TQ, TC_D>(p, st);
}

// The route's launch at head dim 128 (decode_attention.row_tiles on the
// "warp_mma" route): one tile of 8 or 16 columns, or tiles of MMA_ROWS =
// 32 (the TILED instance, one tile or more); any other plan is refused.
template <typename TQ, typename TKV, bool PAGED>
cudaError_t launch_mma128_decode(const DecodeParams& p, cudaStream_t st) {
  if (p.row_tile == MMA_COLS && p.n_tiles == 1)
    return launch_mma_rows<TQ, TKV, 1, PAGED, false>(p, st);
  if (p.row_tile == 2 * MMA_COLS && p.n_tiles == 1)
    return launch_mma_rows<TQ, TKV, 2, PAGED, false>(p, st);
  if (p.row_tile == MMA_ROWS)
    return launch_mma_rows<TQ, TKV, MMA_ROWS / MMA_COLS, PAGED, true>(p, st);
  return cudaErrorInvalidValue;
}

// ------------------------------------------- head dim 64: keys over warps
// At D = 64 a warp holds a whole key's dot: 8 k-steps of 8.  So each warp
// owns KW keys of every tile (16 in f32, one m-tile; 32 in bf16, two) over
// all of D, and no score crosses a warp:
//   * S^T (keys x rows) = K q^T from the warp's own registers, 3xTF32 as
//     above.  Lane (g, t)'s K fragment is 16 d of keys g and g + 8, its
//     16-byte chunks t, t + 4, t + 8, t + 12 (f32; t, t + 4 in bf16), the
//     k-steps' k indices permuted alike in q's B fragment.
//   * S^T -> P^T through the warp's own slice of shared memory, an m-tile
//     at a time behind __syncwarp only: the same transposed read as above,
//     which gives the softmax layout and P^T's B fragment.
//   * Each warp its own online softmax over its keys: (m, l) a row, and
//     O^T (64 d x rows) = V^T P^T over 4 m16 tiles of d and the 2 k8 steps
//     of each m-tile of keys, summed in fresh registers and added to O.
//   * At the chunk's end the four warps' (acc, m, l) merge in warp order in
//     shared memory, as the CUDA-core kernel's warps do; the chunks then
//     merge in the second kernel (tc_decode_combine_kernel at D = 64).
// A tile is 64 f32 keys or 128 bf16 ones (16 KiB of K and of V), the one
// CTA barrier a tile the ring's.  What bounds a one-token launch here is a
// CTA's fixed waits, not its tiles, which stream at the memory rate: the
// page table's and the first tile's round trips and the chunk's merge took
// 10-12k of a CTA's ~30k cycles (scripts/decode_trace.py).  Measured on an
// H100 80GB HBM3 at 700 W (scripts/route_ab.py, PERF.md): two stages (three
// CTAs an SM) beat three (two CTAs), and fewer warps a CTA in more CTAs,
// a K and a V slot a tile, two chunks a CTA and the slot's last CTA's merge
// all ran slower; what took the paged one-token rows from 5% behind the
// CUDA cores to within 1% was launching the chunks last-first, as the
// 1-byte branch does (the last chunks, which most slots do not reach, leave
// their SMs first), beside a shift for a power-of-two page.  Against the
// CUDA cores (scripts/many_row_ab.py, same card): musicgen's T = 9 block
// 0.3099 -> 0.1162 ms, its one-token and split rows within 1.4% (dense
// 0.0944 -> 0.0942 ms, paged 0.1004 -> 0.1015).  A row's bits
// see only its own q, its keys and the fixed warp of each key index (tiles
// start at multiples of TK from the chunk's start; the merge's warp order
// is fixed), so the T-, instance-, tile- and split-invariance above hold
// here too.

// Keys a warp takes of a tile: a stage holds 16 KiB of K and of V.
template <typename TKV>
__host__ __device__ constexpr int mma64_warp_keys() {
  return 64 / (int)sizeof(TKV);
}

// Where a ring tile's 16-byte chunk c of key row kk lies: c ^
// mma64_swz(kk).  The K fragment reads (keys g, g + 1 of an even g a
// quarter-warp, chunks t + 4 c) and the V fragment reads (keys 2 t + c of
// a k-step, lane g's chunks of d 8 g .. 8 g + 7) then hit distinct banks in
// each 128-byte wavefront, f32 (16 chunks a row) and bf16 (8).
template <typename TKV>
__device__ __forceinline__ int mma64_swz(int kk) {
  return (((kk ^ (kk >> 2)) & 1) << 2) |
         (((kk >> 1) & 1) << (sizeof(TKV) == 2 ? 1 : 0));
}

// Shared memory: the ring [stage][K | V][TK][D], each warp's S^T of an
// m-tile [warp][block][8 rows][16 keys] and (paged) the chunk's table; the
// warps' merge at the chunk's end reuses the ring.
template <int NB>
__host__ __device__ constexpr int mma64_exch_floats() {
  return MMA64_WARPS * NB * MMA_COLS * 16;
}
template <typename TKV>
__host__ __device__ constexpr int mma64_ring_bytes() {
  return MMA64_STAGES * 2 * MMA64_WARPS * mma64_warp_keys<TKV>() * MMA64_D *
         (int)sizeof(TKV);
}
template <typename TKV, int NB, bool PAGED>
__host__ __device__ constexpr int mma64_smem_bytes() {
  return mma64_ring_bytes<TKV>() + mma64_exch_floats<NB>() * 4 +
         (PAGED ? CD_TABLE * 4 : 0);
}
// CTAs an SM should hold: three at one block of columns (two stages of
// 32 KiB); two blocks keep twice the q fragments and accumulators, and
// take the registers of two.
__host__ __device__ constexpr int mma64_min_ctas(int nb) {
  return nb > 1 ? 2 : 3;
}

// One CTA per (KV head j and row tile, slot b, chunk z), the chunks
// launched last-first; block nb's column c is the tile's row 8 nb + c.
// Warp w owns keys [KW w, KW w + KW) of every tile; lane (g, t) holds row g
// of each block in the softmax, and rows 2 t, 2 t + 1 of each block in O^T
// at d 8 g .. 8 g + 7.
template <typename TQ, typename TKV, int NB, bool PAGED, bool TILED>
__global__ void __launch_bounds__(MMA64_THREADS, mma64_min_ctas(NB))
    mma64_decode_kernel(DecodeParams p) {
  constexpr int D = MMA64_D, NS = MMA64_STAGES;
  constexpr int W = MMA64_WARPS, THREADS = MMA64_THREADS;
  constexpr int KW = mma64_warp_keys<TKV>();  // keys a warp a tile
  constexpr int MT = KW / 16;                 // its m16 key tiles
  constexpr int TK = W * KW;                  // keys a ring stage
  constexpr int VEC = 16 / sizeof(TKV);       // values in 16 bytes
  constexpr int VPR = D / VEC;                // 16-byte chunks a row
  constexpr int NCP = TK * VPR / THREADS;     // cp.async a thread a tile
  constexpr int KPL = D / 4;                  // a lane's d of a K row
  constexpr int KC = KPL / VEC;               // its chunks, t + 4 c
  constexpr int MI = D / 16;                  // m16 tiles of O^T
  constexpr int VPL = 2 * MI;                 // a lane's d of a V row
  constexpr int MAXR = NB * MMA_COLS;
  constexpr int NE = CD_TABLE / THREADS;      // table entries a thread
  constexpr bool SQ = std::is_same<TQ, float>::value;   // q has small parts
  constexpr bool SKV = std::is_same<TKV, float>::value;  // K, V and p do
  static_assert(NCP * THREADS == TK * VPR && MT * 16 == KW &&
                    KPL % VEC == 0 && VPL % VEC == 0 && VPL % 4 == 0 &&
                    NE * THREADS == CD_TABLE && NS >= 2 &&
                    W * MAXR * (D + 2) * 4 <= mma64_ring_bytes<TKV>(),
                "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ring = reinterpret_cast<TKV*>(smem);
  float* exch = reinterpret_cast<float*>(smem + mma64_ring_bytes<TKV>());
  int* tbl = reinterpret_cast<int*>(exch + mma64_exch_floats<NB>());
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

  const int j = TILED ? blockIdx.x / p.n_tiles : blockIdx.x;
  const int tile = TILED ? blockIdx.x - j * p.n_tiles : 0;
  const int b = blockIdx.y, z = p.n_chunks - 1 - (int)blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int G = p.H / p.KV, T = p.T, R = G * T;
  // this tile's rows [r0, r0 + RT) of the KV head's R
  const int r0 = TILED ? tile * p.row_tile : 0;
  const int RT = TILED ? min(p.row_tile, R - r0) : R;
  const int ps = p.page_size;

  // the chunk's page-table entries (paged) and the lane's q fragments,
  // issued before the slot's position is known: row 8 nb + g, value i at d
  // (tq + 4 (i / VEC)) VEC + i % VEC, k-step s's k index tq being i = 2 s
  // and tq + 4 i = 2 s + 1
  const int2 ck = chunk_keys(p, z);
  const int pg0 = ck.x / ps;
  int ent[NE];
  if (PAGED) {
    const int npg = (ck.y - ck.x + ps - 1) / ps;
    const int* trow = p.page_idx + b * p.pt_sb + pg0;
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      const int e = tid + i * THREADS;
      ent[i] = e < npg ? trow[e] : 0;
    }
  }
  const TQ* q = static_cast<const TQ*>(p.q) + b * p.q_sb;
  uint32_t qb[NB][KPL], qsm[NB][KPL];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int rr = nb * MMA_COLS + g, r = r0 + rr;
    const int gh = r / T, t = r - gh * T;
    const TQ* qr = q + t * p.q_st + (j * G + gh) * p.q_sh;
    MmaFrag<KPL, SQ> f;
#pragma unroll
    for (int i = 0; i < KPL; ++i)
      f.set(i, rr < RT ? to_f(qr[(tq + 4 * (i / VEC)) * VEC + i % VEC])
                       : 0.f);
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      qb[nb][i] = f.big[i];
      qsm[nb][i] = SQ ? f.small[i] : 0u;
    }
  }

  // keys the slot may see, [lo_b, hi_b) (row 0 has the lowest window
  // bound), and this CTA's share of them, [lo, hi)
  const int pos = p.pos[b];
  const int lo_b = p.window ? max(0, pos - p.window + 1) : 0;
  const int hi_b = p.active[b] ? min(p.S, pos + T) : 0;
  const int lo = max(ck.x, lo_b), hi = min(ck.y, hi_b);
  const int n_work = cd_working_chunks(p, lo_b, hi_b);
  TQ* out = static_cast<TQ*>(p.out);
  auto out_row = [&](int rr) {  // the output row of the tile's row rr
    const int r = r0 + rr, gh = r / T, t = r - gh * T;
    return out + (((long long)b * T + t) * p.H + j * G + gh) * D;
  };
  if (lo >= hi) {
    if (n_work == 0 && z == 0)  // a slot that sees no key: zeros
      for (int i = tid; i < RT * D; i += THREADS)
        out_row(i / D)[i % D] = from_f<TQ>(0.f);
    CD_END();
    return;
  }
  if (PAGED) {
#pragma unroll
    for (int i = 0; i < NE; ++i) tbl[tid + i * THREADS] = ent[i];
    __syncthreads();
  }
  CD_MARK(2);

  // key rows of this (slot, KV head): (page, token) of key kpos, dense:
  // (0, kpos) from the slot's own base; a power-of-two page size divides
  // by a shift (8 copies a thread a tile, each a key's page)
  const long long slot = PAGED ? 0 : b;
  const TKV* kbase = static_cast<const TKV*>(p.k) + j * p.k_sh + slot * p.k_s0;
  const TKV* vbase = static_cast<const TKV*>(p.v) + j * p.v_sh + slot * p.v_s0;
  const int psh = ps & (ps - 1) ? -1 : __ffs(ps) - 1;
  auto row_of = [&](int kpos) {
    if (!PAGED) return make_longlong2(0, kpos);
    const int pg = psh >= 0 ? kpos >> psh : kpos / ps;
    return make_longlong2(tbl[pg - pg0], kpos - pg * ps);
  };
  auto chunk_at = [](int kk, int c) {  // chunk c of key row kk, swizzled
    return kk * D + (c ^ mma64_swz<TKV>(kk)) * VEC;
  };
  // tiles on the chunk's grid of TK keys (a window moves lo, not the grid)
  const int lo_t = ck.x + (lo - ck.x) / TK * TK;
  const int ntile = (hi - lo_t + TK - 1) / TK;
  // keys [lo_t + t * TK, + TK) into stage t % NS, swizzled; keys outside
  // [lo, hi) are zero-filled
  auto issue = [&](int t) {
    TKV* Ks = ring + (t % NS) * 2 * TK * D;
    TKV* Vs = Ks + TK * D;
    const int k0 = lo_t + t * TK;
#pragma unroll
    for (int i = 0; i < NCP; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx / VPR, c = idx - kk * VPR;
      const int kpos = k0 + kk;
      const bool in = kpos >= lo && kpos < hi;
      long long ko = 0, vo = 0;
      if (in) {
        const longlong2 r = row_of(kpos);
        ko = r.x * p.k_s0 + r.y * p.k_ss + c * VEC;
        vo = r.x * p.v_s0 + r.y * p.v_ss + c * VEC;
      }
      cp_async16(Ks + chunk_at(kk, c), kbase + ko, in);
      cp_async16(Vs + chunk_at(kk, c), vbase + vo, in);
    }
  };
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntile) issue(t);
    cp_async_commit();
  }

  // the lane's scores of row g in an m-tile: keys 16 mt + kq[e] (the
  // exchange's transposed read, below)
  const int kq[4] = {2 * tq, 2 * tq + 8, 2 * tq + 1, 2 * tq + 9};
  // the keys [wlo, whi] the lane's row g of each block sees: kpos <= its
  // position, inside the window and before hi (keys below lo lie outside
  // every row's window); none for a row past the tile's
  int wlo[NB], whi[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int rr = nb * MMA_COLS + g, qpos = pos + (r0 + rr) % T;
    wlo[nb] = p.window ? qpos - p.window + 1 : 0;
    whi[nb] = rr < RT ? min(qpos, hi - 1) : -1;
  }
  float o[NB][MI][4], m[NB], l[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    m[nb] = NEG_INF;
    l[nb] = 0.f;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[nb][i][c] = 0.f;
  }
  const float scale = 1.0f / sqrtf((float)D);
  // the warp's S^T slice; row r's chunk c of 4 keys at c ^ 2 ((r >> 1) & 1),
  // so that a half-warp's stores meet two words a bank at most and the
  // transposed reads none
  float* ex = exch + warp * NB * MMA_COLS * 16;
  auto exch_at = [](int r, int c) {
    return r * 16 + 4 * (c ^ (2 * ((r >> 1) & 1)));
  };
  for (int t = 0; t < ntile; ++t) {
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose stage the next copies refill
    if (t == 1) CD_MARK(10);
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (t == 0) CD_MARK(3);
    if (t == ntile - 1) CD_MARK(4);
    if (t + NS - 1 < ntile) issue(t + NS - 1);
    cp_async_commit();
    if (t == 1) CD_MARK(11);
    const TKV* Ks = ring + (t % NS) * 2 * TK * D;
    const TKV* Vs = Ks + TK * D;
    const int kw = KW * warp;            // the warp's first key in the tile
    const int k0 = lo_t + t * TK + kw;   // its position

    // S^T of the warp's keys: keys kw + 16 mt + g (+ 8) against each live
    // block's rows over all of D, chunk c's values giving k-steps
    // VEC / 2 c .. + VEC / 2 - 1; each m-tile through the warp's slice,
    // key k of row r at 4 ((k & 7) >> 1) + 2 (k & 1) + (k >> 3) of the
    // row, read back transposed: row g's scores of keys 16 mt + kq[e]
    float sc[NB][MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float acc[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[nb][c] = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        float x[2][VEC];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          Chunk<TKV>::get(*reinterpret_cast<const uint4*>(
                              Ks + chunk_at(kw + 16 * mt + g + 8 * h,
                                            tq + 4 * c)),
                          x[h]);
#pragma unroll
        for (int s = 0; s < VEC / 2; ++s) {
          MmaFrag<4, SKV> a;  // keys g, g + 8; values 2 s, 2 s + 1
          a.set(0, x[0][2 * s]);
          a.set(1, x[1][2 * s]);
          a.set(2, x[0][2 * s + 1]);
          a.set(3, x[1][2 * s + 1]);
          const int i = c * VEC + 2 * s;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            if (nb * MMA_COLS >= RT) continue;  // a block of padding only
            mma_x3<SKV, SQ>(acc[nb], a, &qb[nb][i], &qsm[nb][i]);
          }
        }
      }
      if (mt > 0) __syncwarp();  // every lane has read m-tile mt - 1
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb * MMA_COLS >= RT) continue;
        float* e = ex + nb * MMA_COLS * 16 + 2 * (g & 1);
        *reinterpret_cast<float2*>(e + exch_at(2 * tq, g >> 1)) =
            make_float2(acc[nb][0], acc[nb][2]);
        *reinterpret_cast<float2*>(e + exch_at(2 * tq + 1, g >> 1)) =
            make_float2(acc[nb][1], acc[nb][3]);
      }
      __syncwarp();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb * MMA_COLS >= RT) continue;
        const float4 v = *reinterpret_cast<const float4*>(
            ex + nb * MMA_COLS * 16 + exch_at(g, tq));
        sc[nb][mt][0] = v.x;
        sc[nb][mt][1] = v.y;
        sc[nb][mt][2] = v.z;
        sc[nb][mt][3] = v.w;
      }
    }
    if (t == 1) CD_MARK(12);

    // this warp's online softmax over its keys, p for P V
    float pr[NB][MT][4], alpha[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      if (nb * MMA_COLS >= RT) continue;
      float mx = NEG_INF;
      unsigned ok = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 16 * mt + kq[e];
          const bool seen = kpos >= wlo[nb] && kpos <= whi[nb];
          pr[nb][mt][e] = seen ? sc[nb][mt][e] * scale : NEG_INF;
          ok |= (unsigned)seen << (4 * mt + e);
          mx = fmaxf(mx, pr[nb][mt][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[nb], mx);
      const float a = __expf(m[nb] - m_new);  // exactly 1 where m holds
      float sum = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float exv =
              (ok >> (4 * mt + e)) & 1u ? __expf(pr[nb][mt][e] - m_new)
                                        : 0.f;
          sum += exv;
          pr[nb][mt][e] = to_f(from_f<TKV>(exv));  // p rounded to v's dtype
        }
      l[nb] = l[nb] * a + sum;  // this lane's keys; l sums the unrounded p
      m[nb] = m_new;
      // O's rows 2 tq and 2 tq + 1 take the alpha of rows g = 2 tq, 2 tq + 1
      alpha[nb][0] = __shfl_sync(0xffffffffu, a, 8 * tq);
      alpha[nb][1] = __shfl_sync(0xffffffffu, a, 8 * tq + 4);
    }
    if (t == 1) CD_MARK(14);

    // P V over the warp's keys: k-step u of m-tile mt is keys kw + 16 mt +
    // 8 u + 2 tq (k index tq) and + 1 (tq + 4); D m-tile i's row g is d
    // VPL g + 2 i and its row g + 8 d + 1; summed in fresh registers, added
    // to O
    float pv[NB][MI][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) pv[nb][i][c] = 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        MmaFrag<4, SKV> va[MI];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float vf[VPL];
          const int kk = kw + 16 * mt + 8 * u + 2 * tq + c;
#pragma unroll
          for (int cc = 0; cc < VPL / VEC; ++cc)
            Chunk<TKV>::get(*reinterpret_cast<const uint4*>(
                                Vs + chunk_at(kk, VPL * g / VEC + cc)),
                            vf + cc * VEC);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            va[i].set(2 * c, vf[2 * i]);
            va[i].set(2 * c + 1, vf[2 * i + 1]);
          }
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if (nb * MMA_COLS >= RT) continue;
          // B: (key 2 tq, row g), (key 2 tq + 1, row g) of the k-step
          MmaFrag<2, SKV> pb;
          pb.set(0, pr[nb][mt][u]);
          pb.set(1, pr[nb][mt][u + 2]);
#pragma unroll
          for (int i = 0; i < MI; ++i)
            mma_x3<SKV, SKV>(pv[nb][i], va[i], pb.big, pb.small);
        }
      }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[nb][i][c] = o[nb][i][c] * alpha[nb][c & 1] + pv[nb][i][c];
    if (t == 1) CD_MARK(15);
  }
  CD_MARK(5);
#ifdef CD_TRACE
  if (cd_rec) cd_trace[cd_slot + 9] = n_work | (ntile << 16);
#endif

  // the warps' merge in shared memory (the ring's space), in warp order:
  // warp w's row rr at wo[w][rr][D] and (m, l) at wml[w][rr]; each row's l
  // is its quad's parts, O's rows 2 tq + h at d VPL g + 2 i + e:
  // o[.][i][h + 2 e]
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* wo = reinterpret_cast<float*>(smem);
  float* wml = wo + W * MAXR * D;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    l[nb] += __shfl_xor_sync(0xffffffffu, l[nb], 1);
    l[nb] += __shfl_xor_sync(0xffffffffu, l[nb], 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = nb * MMA_COLS + 2 * tq + h;
      if (rr >= RT) continue;
      float y[VPL];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        y[2 * i] = o[nb][i][h];
        y[2 * i + 1] = o[nb][i][h + 2];
      }
#pragma unroll
      for (int c = 0; c < VPL; c += 4)
        store4(wo + (warp * MAXR + rr) * D + VPL * g + c, y + c);
    }
    const int rr = nb * MMA_COLS + g;
    if (tq == 0 && rr < RT) {
      wml[(warp * MAXR + rr) * 2] = m[nb];
      wml[(warp * MAXR + rr) * 2 + 1] = l[nb];
    }
  }
  __syncthreads();
  // scratch rows of (b, j): chunk z's row r0 + rr at (base + z) * R + r0 +
  // rr, merged by tc_decode_combine_kernel
  const long long base = ((long long)b * p.KV + j) * p.n_chunks;
  for (int i = tid; i < RT * (D / 4); i += THREADS) {
    const int rr = i / (D / 4), d0 = 4 * (i - rr * (D / 4));
    float ms = NEG_INF;
#pragma unroll
    for (int w = 0; w < W; ++w) ms = fmaxf(ms, wml[(w * MAXR + rr) * 2]);
    float a[4] = {0.f, 0.f, 0.f, 0.f}, ls = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float e = expf(wml[(w * MAXR + rr) * 2] - ms);
      const float4 x =
          *reinterpret_cast<const float4*>(wo + (w * MAXR + rr) * D + d0);
      a[0] += x.x * e;
      a[1] += x.y * e;
      a[2] += x.z * e;
      a[3] += x.w * e;
      ls += wml[(w * MAXR + rr) * 2 + 1] * e;
    }
    if (n_work == 1) {  // the slot's only chunk: the output itself
      const float den = fmaxf(ls, 1e-30f);
#pragma unroll
      for (int c = 0; c < 4; ++c) a[c] /= den;
      store4(out_row(rr) + d0, a);
      continue;
    }
    const long long row = (base + z) * R + r0 + rr;
    store4(p.o_part + row * D + d0, a);
    if (d0 == 0) {
      p.ml_part[2 * row] = ms;
      p.ml_part[2 * row + 1] = ls;
    }
  }
  CD_MARK(6);
  CD_END();
}

template <typename TQ, typename TKV, int NB, bool PAGED, bool TILED>
cudaError_t launch_mma64_rows(const DecodeParams& p, cudaStream_t st) {
  constexpr int smem = mma64_smem_bytes<TKV, NB, PAGED>();
  // above 48 KB dynamic shared memory must be allowed explicitly, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      mma64_decode_kernel<TQ, TKV, NB, PAGED, TILED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.KV * p.n_tiles, p.B, p.n_chunks);
  mma64_decode_kernel<TQ, TKV, NB, PAGED, TILED>
      <<<grid, MMA64_THREADS, smem, st>>>(p);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : launch_decode_merge<TQ, MMA64_D>(p, st);
}

// The route's launch (decode_attention.row_tiles on the "warp_mma"
// route): at head dim 128 launch_mma128_decode's plans; at head dim 64 one
// tile of 8 columns, or tiles of MMA64_ROWS = 16 (untiled in one, TILED in
// more); any other plan is refused.
template <typename TQ, typename TKV, int D, bool PAGED>
cudaError_t launch_mma_decode(const DecodeParams& p, cudaStream_t st) {
  if constexpr (D == TC_D) {
    return launch_mma128_decode<TQ, TKV, PAGED>(p, st);
  } else {
    static_assert(D == MMA64_D, "the warp-mma route's head dims");
    if (p.row_tile == MMA_COLS && p.n_tiles == 1)
      return launch_mma64_rows<TQ, TKV, 1, PAGED, false>(p, st);
    if (p.row_tile == MMA64_ROWS)
      return p.n_tiles == 1
                 ? launch_mma64_rows<TQ, TKV, 2, PAGED, false>(p, st)
                 : launch_mma64_rows<TQ, TKV, 2, PAGED, true>(p, st);
    return cudaErrorInvalidValue;
  }
}

}  // namespace
