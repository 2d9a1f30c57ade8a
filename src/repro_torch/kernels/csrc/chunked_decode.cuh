// The chunked decode kernel for Hopper (sm_90a): the dense decode and
// split-K decode over per-slot caches and the paged decode and split-K
// decode over the page pool are one kernel body, which cuts each slot's
// live prefix into fixed chunks of keys, spreads the chunks over the card
// and merges them in the same launch.  A template flag says how a key row
// is found: through the page table (PAGED) or the slot's dense stripe.
//
// Replaces
//   decode_attention_tpu
//     (src/repro/kernels/decode_attention.py:131, _decode_kernel)
//   decode_attention_splitk_tpu
//     (src/repro/kernels/decode_attention.py:236, _splitk_partial_kernel +
//     _splitk_combine_kernel)
//   paged_decode_attention_tpu
//     (src/repro/kernels/paged_attention.py:131, _paged_decode_kernel +
//     _accumulate_page)
//   paged_decode_attention_splitk_tpu
//     (src/repro/kernels/paged_attention.py:325, _paged_splitk_partial_kernel
//     + the shared _splitk_combine_kernel)
//
// Contract: attention_common.cuh's decode contract.  Key kpos of slot b is
// row kpos of the slot's stripe (dense: cache + b * sb + kpos * ss) or
// token kpos % page_size of physical page page_idx[b, kpos / page_size]
// (paged).  Split-K (T = 1) gives split i the keys [i * S / ns, (i + 1) *
// S / ns) of the S positions (paged: whole pages, max_pages % ns == 0, as
// the reference partitions the page table) and combines the splits' (acc,
// m, l) with exp(m_i - m*); ns = 1 is the single-pass decode, which also
// takes T > 1 (the verify block).  Any G * T: the rows of a KV head past
// the largest instance are spread over row tiles (below).
//
// What bounds it on an H100: device-memory bytes.  A tick reads the live
// K/V prefix once, 2 * D * bytes per live key and KV head (1 KiB in f32),
// against 4 * G * T * D flops: ~1 flop per byte, far below the card's
// balance point.  Reaching the memory rate takes ~3 MB in flight across the
// card (Little's law at ~1 us), which one CTA per (slot, KV head) walking
// its whole prefix tile by tile never had.
//
// What the design does about it:
//   * Chunks.  The key axis is cut at multiples of `chunk` keys (256; paged:
//     rounded up to whole pages) and at the split boundaries; one CTA takes
//     one (KV head, slot, chunk).  The grid (KV, B, chunks) follows from the
//     shapes alone, so the host needs no position and the launch could be
//     captured in a graph.  A 1-byte pool takes the same grid: 512- and
//     1024-key chunks (half or all of f32's chunk bytes) measured slower,
//     their CTAs too few to hide a CTA's fixed waits.  A CTA whose chunk
//     holds no key its slot may see (past pos + T - 1, wholly before the
//     window, an inactive slot) returns at once.  At 8 KV heads and pos
//     [-1, 1000, 4200, 8191] that is 424 working CTAs, 3.2 per SM, against
//     32 before.  Split-K needs no combine launch: its splits are chunks
//     clipped at S / ns.
//   * Paged: the page table first.  A CTA reads its chunk's page-table
//     entries (issued before it knows its slot's position) into shared
//     memory, so no K/V load waits on a table read.  Dense: no table; the
//     row is the slot's base plus kpos times the sequence stride.
//   * A ring of K/V tiles per CTA: 8 KiB of K and 8 KiB of V per stage (16
//     keys in f32, 32 in bf16, 64 in int8 or fp8), three stages, filled by
//     16-byte cp.async.cg; key rows outside the CTA's keys are zero-filled
//     without a read.  At 50 KiB of shared memory four CTAs share an SM, so
//     the 424 working CTAs above are all resident at once, each with two
//     stages in flight.  Four stages (three CTAs per SM), 32 KiB stages, and
//     128- or 512-key f32 chunks all measured slower (PERF.md).
//   * Quantized pools (paged only: int8, fp8 e4m3; the TPU kernel's quant
//     branch, _accumulate_page(quant=True) with _page_scale_spec): each
//     stage also holds the tile's 64 K and 64 V scales, one 4-byte
//     cp.async.ca per thread, found through the same table entry as the
//     row.  The bytes a tick moves are a quarter of f32's (plus 8 bytes of
//     scales per key and KV head), but a byte holds four times the values,
//     and the TPU kernel's order (each value dequantized, float(x) * scale,
//     before the dot and PV) spent an eighth-rate I2F or fp8 cvt and an
//     FMUL on every value: about as long as the whole byte bound at
//     phase 3's shape.  Here the dot and PV run on the codes, converted
//     exactly (attention_common.cuh: a PRMT and an FADD per int8 value on
//     the integer and FMA pipes; fp8 by cvt.rn.f16x2.e4m3x2), and the
//     scales join once per key and row: s = (q . k_code) * (k_scale *
//     D^-1/2), PV adds (p * v_scale) * v_code, and l sums the unscaled p.
//     Against dequantizing first this moves each product's rounding, not
//     its size: the score's error stays within D f32 roundings of
//     sum |q_i k_i| (plus one of the scale product), PV's within one of
//     p |v| per key; p stays f32.  A 16-byte K chunk then holds 16 values,
//     64 bytes of q, so q is swizzled in shared memory (below) to keep the
//     dot's q reads free of bank conflicts.
//   * Warps own keys.  Each warp takes its quarter of every tile: LPK lanes
//     share one key's score dot (each a slice of the row, in a rotated order
//     so that the 16-byte reads of a quarter-warp hit 8 distinct bank
//     groups), shuffles finish the dot and give the rows' max and sum over
//     the warp's keys, and in PV each lane owns 4 output columns.  Each warp
//     keeps its own (m, l, acc) per row; the ring's barrier is the only
//     CTA-wide one per tile.  f32 on the CUDA cores: at G * T = 2 rows per
//     KV head a tensor-core tile would be 7/8 empty, and the flops do not
//     bound this kernel.
//   * Row tiles.  A CTA serves up to MAXR query rows of its KV head (2, 8,
//     or at D = 128 16: the instances).  Where G * T rows are more than
//     the largest instance (granite's G = 48; a verify block of G = 5 or
//     16 at T = 4; G = 1 at T = 16 at D = 64/80), they are cut into
//     n_tiles row tiles of `row_tile` rows (the last one shorter), and the
//     tile index joins the KV head in the grid: blockIdx.x = j * n_tiles +
//     i.  Tiling is a template flag (TILED): the tiled 8-row instance is
//     built beside the untiled instances, which compile as they did
//     without tiles, so one tile costs nothing.  Each tile reads its
//     chunk's K/V again; the tiles of one (KV head, slot, chunk) are
//     neighbours in the grid, so the second read comes from L2.  Tickets are kept per (slot, KV head, tile), the scratch
//     keeps its (B, KV, chunks, G * T) rows (a tile writes its rows at
//     their row index), and the slot's last CTA of each tile merges that
//     tile's rows.  A row's sums never see row_tile or n_tiles, so a row
//     is bitwise the same in any tile of any instance.
//   * Head dims D in {64, 80, 128}, a template parameter (one library per
//     head dim; 64 and 80 built up to the 8-row instance, the archs that
//     have them have G = 1, and row-tiled past it).  A tile is TK rows
//     of D elements in shared memory and the kernel reads only a row's D
//     elements from device memory.  Threads
//     d < D own the merges' columns and lanes 4 l < D the PV columns; the
//     others do no column work.  At D = 80 a row is 20 (f32), 10 (bf16) or
//     5 (1-byte) 16-byte chunks, no multiple of a key's LPK lanes: lane
//     `part` dots chunks part, part + LPK, ... (the last pass guarded), and
//     the tile copy's last pass is guarded too.
//   * Rows that do not depend on T.  The verify block of speculative
//     decode runs T rows per slot, and row t must be bitwise the T = 1
//     launch at pos + t.  A key's tile, warp and lanes follow from its
//     position alone: tiles start at multiples of TK from the chunk's
//     start, even when the window cuts the chunk's first keys (those rows
//     are zero-filled, not read).  Keys past a row's position, which the
//     other rows of the block see, enter that row as e = 0 with alpha = 1:
//     m, l and acc come out unchanged, bit for bit; so does a chunk that
//     holds none of the row's keys, which merges as (0, NEG_INF, 0).
//   * Merges in a fixed order.  At the end of its chunk a CTA merges its
//     warps in shared memory, in warp order.  A slot whose visible keys lie
//     in one chunk writes its output there; otherwise each chunk writes its
//     (acc, m, l) to f32 scratch, and the slot's last CTA to finish (a
//     ticket counter per (slot, KV head, row tile), which that CTA resets)
//     merges every chunk's partial in chunk order.  Nothing depends on the
//     order in which CTAs finish or on the other slots, so a slot's output
//     is bitwise the same alone and in any batch, and split-K whose splits
//     are whole chunks is bitwise the single pass.
#pragma once

#include "attention_common.cuh"

namespace {

constexpr int CD_THREADS = 128;  // 4 warps; thread d < D owns column d
constexpr int CD_WARPS = CD_THREADS / 32;
constexpr int CD_STAGES = 3;     // ring depth
constexpr int CD_TABLE = 256;    // most page-table entries a chunk spans

#ifdef CD_TRACE
// A diagnostic build (scripts/decode_trace.py, -DCD_TRACE): thread 0 of
// each CTA records, 16 words a CTA by linear block index, its global start
// and end time (ns), its SM, its chunk's working chunks and tiles, and the
// SM clock at marks through its work (cycles since its start).  CTAs past
// the buffer's 8192 record nothing.
constexpr long long CD_TRACE_WORDS = 1 << 17;
__device__ unsigned long long cd_trace[CD_TRACE_WORDS];
__device__ __forceinline__ unsigned long long cd_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define CD_MARK(i)                                                   \
  do {                                                               \
    if (cd_rec) cd_trace[cd_slot + (i)] = clock64() - cd_c0;         \
  } while (0)
#define CD_END()                                                     \
  do {                                                               \
    if (cd_rec) cd_trace[cd_slot + 1] = cd_gtime();                  \
  } while (0)
#else
#define CD_MARK(i) do {} while (0)
#define CD_END() do {} while (0)
#endif

// CTAs an SM should hold: four fit the shared memory of the decode
// instances (2 or 8 rows); the 16-row instance needs more registers.
__host__ __device__ constexpr int cd_min_ctas(int max_rows) {
  return max_rows > 8 ? 2 : 4;
}

// Dense caches are (B, S, KV, D), paged pools (P, page_size, KV, D).  In
// the chunk arithmetic a dense slot is S pages of one token (page_size 1);
// its rows lie at the slot's base, b * s0, plus kpos * ss.
struct DecodeParams {
  const void* q;        // (B, T, H, D) through strides
  const void* k;        // caches or pools, through strides
  const void* v;
  const float* ks;      // quantized pools: scales (P, page_size, KV, 1)
  const float* vs;      // through strides; null otherwise
  void* out;            // contiguous (B, T, H, D), q's dtype
  const int* pos;       // (B,)
  const int* active;    // (B,) 0/1
  const int* page_idx;  // paged: (B, max_pages) int32, row stride pt_sb
  long long pt_sb;
  int B, T, H, KV, S, page_size, window;  // dense: page_size 1
  int chunk;             // keys per chunk, a multiple of page_size
  int split;             // S / num_splits, a multiple of page_size
  int chunks_per_split;  // chunk slots of one split (the last may be empty)
  int n_chunks;          // num_splits * chunks_per_split: the grid's z
  int row_tile;          // query rows per row tile: the instance's MAXR
  int n_tiles;           // row tiles per KV head, ceil(G * T / row_tile)
  long long q_sb, q_st, q_sh;
  long long k_s0, k_ss, k_sh;  // (page | slot, token, kv head) strides
  long long v_s0, v_ss, v_sh;
  long long ks_s0, ks_ss, ks_sh;  // scale strides, as the pools'
  long long vs_s0, vs_ss, vs_sh;
  float* o_part;   // (B, KV, n_chunks, G * T, D) chunk accumulators
  float* ml_part;  // (B, KV, n_chunks, G * T, 2) chunk (m, l)
  int* tickets;    // (B, KV, n_tiles) counters, 0 between launches
};

// Keys [x, y) of chunk z: chunk slot c of split i is the part of key cell
// i * split / chunk + c (cells of `chunk` keys) inside the split; empty
// (x >= y) past the split's end.
__device__ __forceinline__ int2 chunk_keys(const DecodeParams& p,
                                           int z) {
  const int i = z / p.chunks_per_split, c = z - i * p.chunks_per_split;
  const int s0 = i * p.split, cell = s0 / p.chunk + c;
  return make_int2(max(cell * p.chunk, s0),
                   min((cell + 1) * p.chunk, s0 + p.split));
}

// Keys per tile: 8 KiB of K (and of V) per ring stage at D = 128.
template <typename TKV>
__host__ __device__ constexpr int cd_tile_keys() {
  return 64 / (int)sizeof(TKV);
}

// Shared memory: the ring, whose space the warps' merge and the last
// CTA's list of chunks reuse, then q's rows as f32, the chunk's table
// (paged) and the ring's scales (quantized pools), [stage][K | V][TK] f32.
template <typename TKV, int MAXR, int D>
__host__ __device__ constexpr int cd_front_bytes() {
  const int ring = CD_STAGES * 2 * cd_tile_keys<TKV>() * D * (int)sizeof(TKV);
  const int merge = CD_WARPS * MAXR * (D + 2) * 4;
  return ring > merge ? ring : merge;
}
template <typename TKV, int MAXR, int D, bool PAGED>
constexpr int cd_smem_bytes() {
  return cd_front_bytes<TKV, MAXR, D>() + MAXR * D * 4 +
         (PAGED ? CD_TABLE * 4 : 0) +
         (KVValue<TKV>::quant ? CD_STAGES * 2 * cd_tile_keys<TKV>() * 4 : 0);
}

// One CTA per (KV head j and row tile i, slot b, chunk z); its row rr is
// query row r = i * row_tile + rr of KV head j, which is query head j * G
// + g at position pos[b] + t for r = g * T + t.
template <typename TQ, typename TKV, int MAXR, int D, bool PAGED, bool TILED>
__global__ void __launch_bounds__(CD_THREADS, cd_min_ctas(MAXR))
    chunked_decode_kernel(DecodeParams p) {
  constexpr int TK = cd_tile_keys<TKV>();
  constexpr int VEC = 16 / sizeof(TKV);        // elements per 16 bytes
  constexpr int VPR = D / VEC;                 // 16-byte chunks per row
  constexpr int KPW = TK / CD_WARPS;           // keys per warp per tile
  constexpr int LPK = 32 / KPW;                // lanes per key's score dot
  constexpr int CPL = (VPR + LPK - 1) / LPK;   // chunks each lane dots
  // a power-of-two CPL * LPK == VPR (D = 64, 128): each lane a block of
  // the row, rotated; otherwise (D = 80) chunks part + LPK * cc
  constexpr bool BLOCKED = CPL * LPK == VPR && (CPL & (CPL - 1)) == 0;
  constexpr int NCP = (TK * VPR + CD_THREADS - 1) / CD_THREADS;  // cp.async
  constexpr bool COPY_WHOLE = NCP * CD_THREADS == TK * VPR;  // per thread
  constexpr bool ALL_COLS = D == CD_THREADS;  // every thread owns a column
  constexpr bool QUANT = KVValue<TKV>::quant;
  using TV = typename KVValue<TKV>::type;      // a loaded K/V value's type
  static_assert(D % 16 == 0 && D <= CD_THREADS && KPW * CD_WARPS == TK &&
                    LPK * KPW == 32 && 2 * TK <= CD_THREADS,
                "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ring = reinterpret_cast<TKV*>(smem);  // [stage][K | V][TK][D]
  float* qs =
      reinterpret_cast<float*>(smem + cd_front_bytes<TKV, MAXR, D>());
  int* tbl = reinterpret_cast<int*>(qs + MAXR * D);  // paged: [CD_TABLE]
  float* scs = reinterpret_cast<float*>(tbl + (PAGED ? CD_TABLE : 0));
  __shared__ int last_s;
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
  // 1-byte pools: the chunks in reverse launch order, so that the last
  // chunks, which most slots do not reach, leave their SMs first and the
  // working CTAs start sooner
  const int b = blockIdx.y,
            z = QUANT ? p.n_chunks - 1 - (int)blockIdx.z : blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool col = ALL_COLS || tid < D;  // thread tid owns column tid
  const int G = p.H / p.KV, T = p.T, R = G * T;
  // this tile's rows [r0, r0 + RT) of the KV head's R
  const int r0 = TILED ? tile * p.row_tile : 0;
  const int RT = TILED ? min(p.row_tile, R - r0) : R;
  const int ps = p.page_size;

  // the chunk's page-table entries (paged) and the q rows, issued before
  // the slot's position is known
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
  float qv[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int g = (r0 + r) / T, t = r0 + r - g * T;
    qv[r] = r < RT && col ? to_f(q[t * p.q_st + (j * G + g) * p.q_sh + tid])
                          : 0.f;
  }

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
  auto out_at = [&](int r) {  // this thread's column of the tile's row r
    const int g = (r0 + r) / T, t = r0 + r - g * T;
    return out + (((long long)b * T + t) * p.H + j * G + g) * D + tid;
  };
  if (lo >= hi) {
    if (n_work == 0 && z == 0 && col)  // a slot that sees no key: zeros
      for (int r = 0; r < RT; ++r) *out_at(r) = from_f<TQ>(0.f);
    CD_END();
    return;
  }

  if (PAGED) {
#pragma unroll
    for (int i = 0; i < CD_TABLE / CD_THREADS; ++i)
      tbl[tid + i * CD_THREADS] = ent[i];
  }
  // 1-byte pools: q's 16-byte groups are swizzled in shared memory, group
  // g at g ^ ((g >> 3) & 3).  A lane's 16-byte K chunk holds 16 values, 64
  // bytes of q, so the eight lanes of a quarter-warp, reading the q of eight
  // distinct chunks at one word, hit two bank groups unswizzled (a 4-way
  // conflict); swizzled, eight.
  const int qcol = QUANT ? 4 * ((tid >> 2) ^ ((tid >> 5) & 3)) + (tid & 3)
                         : tid;
#pragma unroll
  for (int r = 0; r < MAXR; ++r)
    if (r < RT && col) qs[r * D + qcol] = qv[r];
  __syncthreads();
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
  // keys [lo_t + t * TK, + TK) into stage t % CD_STAGES; a warp (f32), a
  // half-warp (bf16) or a quarter-warp (int8, fp8) copies one whole key
  // row, and (quantized) thread i < 2 TK the K (i < TK) or V scale of key
  // i % TK; keys outside [lo, hi) are zero-filled
  auto issue = [&](int t) {
    TKV* Ks = ring + (t % CD_STAGES) * 2 * TK * D;
    TKV* Vs = Ks + TK * D;
    const int k0 = lo_t + t * TK;
#pragma unroll
    for (int i = 0; i < NCP; ++i) {
      const int idx = tid + i * CD_THREADS;
      if (!COPY_WHOLE && idx >= TK * VPR) break;  // the last pass's rest
      const int kk = idx / VPR, c = idx - kk * VPR;
      const int kpos = k0 + kk;
      const bool in = kpos >= lo && kpos < hi;
      long long ko = 0, vo = 0;
      if (in) {
        const longlong2 r = row_of(kpos);
        ko = r.x * p.k_s0 + r.y * p.k_ss + c * VEC;
        vo = r.x * p.v_s0 + r.y * p.v_ss + c * VEC;
      }
      cp_async16(Ks + kk * D + c * VEC, kbase + ko, in);
      cp_async16(Vs + kk * D + c * VEC, vbase + vo, in);
    }
    if (QUANT && tid < 2 * TK) {
      const int kk = tid % TK, isv = tid / TK;
      const int kpos = k0 + kk;
      const bool in = kpos >= lo && kpos < hi;
      const float* src = isv ? p.vs + j * p.vs_sh + slot * p.vs_s0
                             : p.ks + j * p.ks_sh + slot * p.ks_s0;
      if (in) {
        const longlong2 r = row_of(kpos);
        src += isv ? r.x * p.vs_s0 + r.y * p.vs_ss
                   : r.x * p.ks_s0 + r.y * p.ks_ss;
      }
      cp_async4(scs + ((t % CD_STAGES) * 2 + isv) * TK + kk, src, in);
    }
  };
#pragma unroll
  for (int t = 0; t < CD_STAGES - 1; ++t) {
    if (t < ntile) issue(t);
    cp_async_commit();
  }

  float m[MAXR], l[MAXR], acc[MAXR][4];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
  const float scale = 1.0f / sqrtf((float)D);
  const int kq = lane / LPK, part = lane - kq * LPK;
  const int key = warp * KPW + kq;  // this lane's key of a tile (scores)
  // chunk order of the score dot (BLOCKED): lane l of a quarter-warp
  // starts CPL * l / 8 (or l) chunks in, so the quarter-warp reads 8 bank
  // groups
  const int rot = CPL >= 8 ? (lane & 7) : ((lane & 7) * CPL) >> 3;
  // PV's output columns, 4 per lane; lanes past D read the last 4 columns
  // and keep their sums to themselves
  const bool pv_cols = ALL_COLS || 4 * lane < D;
  const int pv_col = ALL_COLS ? 4 * lane : min(4 * lane, D - 4);
  for (int t = 0; t < ntile; ++t) {
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose stage the next copies refill
    cp_async_wait<CD_STAGES - 2>();
    __syncthreads();
    if (t == 0) CD_MARK(3);
    if (t == ntile - 1) CD_MARK(4);
    if (t + CD_STAGES - 1 < ntile) issue(t + CD_STAGES - 1);
    cp_async_commit();
    const TKV* Ks = ring + (t % CD_STAGES) * 2 * TK * D;
    const TKV* Vs = Ks + TK * D;
    const float* Ksc = scs + (t % CD_STAGES) * 2 * TK;  // quantized only
    const float* Vsc = Ksc + TK;

    float s[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) s[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      const int ch = BLOCKED ? part * CPL + ((cc + rot) & (CPL - 1))
                             : part + LPK * cc;
      if (!BLOCKED && ch >= VPR) break;  // the last pass's rest
      if constexpr (QUANT) {
        // the codes, a 32-bit word (four of the key's values) at a time;
        // the scale joins after the dot.  q's group ch * 4 + w lies at
        // ch * 4 + (w ^ sw) (the swizzle above)
        const uint4 raw =
            *reinterpret_cast<const uint4*>(Ks + key * D + ch * VEC);
        const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
        const int sw = (ch >> 1) & 3;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          float kf[4];
          codes4<TKV>(wd[w], kf);
#pragma unroll
          for (int r = 0; r < MAXR; ++r) {
            if (r >= RT) break;
            const float4 a = *reinterpret_cast<const float4*>(
                qs + r * D + 4 * (ch * 4 + (w ^ sw)));
            s[r] = fmaf(a.x, kf[0], s[r]);
            s[r] = fmaf(a.y, kf[1], s[r]);
            s[r] = fmaf(a.z, kf[2], s[r]);
            s[r] = fmaf(a.w, kf[3], s[r]);
          }
        }
        continue;
      }
      float kf[VEC];
      Chunk<TKV>::get(
          *reinterpret_cast<const uint4*>(Ks + key * D + ch * VEC), kf);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r >= RT) break;
        const float* qr = qs + r * D + ch * VEC;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + e);
          s[r] = fmaf(a.x, kf[e], s[r]);
          s[r] = fmaf(a.y, kf[e + 1], s[r]);
          s[r] = fmaf(a.z, kf[e + 2], s[r]);
          s[r] = fmaf(a.w, kf[e + 3], s[r]);
        }
      }
    }

    // online softmax over the warp's KPW keys, each row's score held by
    // the LPK lanes of its key (keys below lo are outside every row's
    // window, so the window test masks them)
    const int kpos = lo_t + t * TK + key;
    // the score's factor, and p's for PV: (q . k_code) * (k_scale * D^-1/2)
    // and (p * v_scale) . v_code, each scale once per key and row; f32 and
    // bf16 take D^-1/2 and p as they are
    float kfac = scale, vfac = 1.f;
    if constexpr (QUANT) {
      kfac = Ksc[key] * scale;
      vfac = Vsc[key];
    }
    float pr[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      pr[r] = 0.f;
      if (r >= RT) break;
      float sr = s[r];
#pragma unroll
      for (int o = 1; o < LPK; o <<= 1)
        sr += __shfl_xor_sync(0xffffffffu, sr, o);
      const int qpos = pos + (r0 + r) % T;
      const bool ok = kpos < hi && kpos <= qpos &&
                      (p.window == 0 || qpos - kpos < p.window);
      const float sv = ok ? sr * kfac : NEG_INF;
      float mx = sv;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float e = ok ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      float sum = e;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = l[r] * alpha + sum;  // l sums the unrounded, unscaled p
      m[r] = m_new;
      if constexpr (QUANT)
        pr[r] = e * vfac;
      else
        pr[r] = to_f(from_f<TV>(e));  // p rounded to v's (loaded) dtype
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= alpha;
    }

    // PV: lane owns output columns 4 lane .. 4 lane + 3
#pragma unroll
    for (int kk = 0; kk < KPW; ++kk) {
      float vf[4];
      if constexpr (QUANT)
        codes4<TKV>(*reinterpret_cast<const uint32_t*>(
                        Vs + (warp * KPW + kk) * D + pv_col),
                    vf);
      else
        load4(Vs + (warp * KPW + kk) * D + pv_col, vf);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r >= RT) break;
        const float pk = __shfl_sync(0xffffffffu, pr[r], kk * LPK);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(pk, vf[c], acc[r][c]);
      }
    }
  }

  // merge the warps in shared memory (the ring's space), in warp order
  cp_async_wait<0>();
  __syncthreads();
  CD_MARK(5);
#ifdef CD_TRACE
  if (cd_rec) cd_trace[cd_slot + 9] = n_work | (ntile << 16);
#endif
  float* wacc = reinterpret_cast<float*>(smem);   // [warp][MAXR][D]
  float* wml = wacc + CD_WARPS * MAXR * D;        // [warp][MAXR][m, l]
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r >= RT) break;
    if (pv_cols)
      *reinterpret_cast<float4*>(wacc + (warp * MAXR + r) * D + pv_col) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    if (lane == 0) {
      wml[(warp * MAXR + r) * 2] = m[r];
      wml[(warp * MAXR + r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  // scratch rows of (b, j): chunk z's row r0 + r at (base + z) * R + r0 + r
  const long long base = ((long long)b * p.KV + j) * p.n_chunks;
  for (int r = 0; r < RT && col; ++r) {
    float ms = NEG_INF;
#pragma unroll
    for (int w = 0; w < CD_WARPS; ++w)
      ms = fmaxf(ms, wml[(w * MAXR + r) * 2]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < CD_WARPS; ++w) {
      const float e = expf(wml[(w * MAXR + r) * 2] - ms);
      a += wacc[(w * MAXR + r) * D + tid] * e;
      ls += wml[(w * MAXR + r) * 2 + 1] * e;
    }
    if (n_work == 1) {  // the slot's only chunk: the output itself
      *out_at(r) = from_f<TQ>(a / fmaxf(ls, 1e-30f));
      continue;
    }
    const long long row = (base + z) * R + r0 + r;
    p.o_part[row * D + tid] = a;
    if (tid == 0) {
      p.ml_part[2 * row] = ms;
      p.ml_part[2 * row + 1] = ls;
    }
  }
  CD_MARK(6);
  if (n_work == 1) {
    CD_END();
    return;
  }

  // the slot's last CTA of this tile to finish merges the tile's rows of
  // every working chunk, in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = p.tickets + (TILED ? ((long long)b * p.KV + j) * p.n_tiles
                                       + tile : b * p.KV + j);
    const bool last = atomicAdd(ticket, 1) == n_work - 1;
    if (last) *ticket = 0;  // every other CTA of (b, j, tile) has counted
    last_s = last;
  }
  __syncthreads();
  if (!last_s) {
    CD_END();
    return;
  }
  __threadfence();
  // the working chunks in order, then their (m, l) fetched all at once
  int* zl = reinterpret_cast<int*>(smem);
  float* mls = reinterpret_cast<float*>(zl + p.n_chunks);  // [i][row][m, l]
  if (warp == 0) {
    int n = 0;
    for (int z0 = 0; z0 < p.n_chunks; z0 += 32) {
      bool w = false;
      if (z0 + lane < p.n_chunks) {
        const int2 c = chunk_keys(p, z0 + lane);
        w = max(c.x, lo_b) < min(c.y, hi_b);
      }
      const unsigned ball = __ballot_sync(0xffffffffu, w);
      if (w) zl[n + __popc(ball & ((1u << lane) - 1))] = z0 + lane;
      n += __popc(ball);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < n_work * RT; idx += CD_THREADS) {
    const int i = idx / RT, r = idx - i * RT;
    const long long row = (base + zl[i]) * R + r0 + r;
    mls[2 * idx] = __ldcg(p.ml_part + 2 * row);
    mls[2 * idx + 1] = __ldcg(p.ml_part + 2 * row + 1);
  }
  __syncthreads();
  for (int r = 0; r < RT && col; ++r) {
    float ms = NEG_INF;
    for (int i = 0; i < n_work; ++i) ms = fmaxf(ms, mls[2 * (i * RT + r)]);
    float num = 0.f, den = 0.f;
#pragma unroll 16
    for (int i = 0; i < n_work; ++i) {
      const float e = expf(mls[2 * (i * RT + r)] - ms);
      den += mls[2 * (i * RT + r) + 1] * e;
      num += __ldcg(p.o_part + ((base + zl[i]) * R + r0 + r) * D + tid) * e;
    }
    *out_at(r) = from_f<TQ>(num / fmaxf(den, 1e-30f));
  }
  CD_MARK(7);
  CD_END();
}

template <typename TQ, typename TKV, int MAXR, int D, bool PAGED, bool TILED>
cudaError_t launch_chunked_decode_rows(const DecodeParams& p,
                                       cudaStream_t st) {
  constexpr int smem = cd_smem_bytes<TKV, MAXR, D, PAGED>();
  // the last CTA lists the working chunks and their (m, l) in the front
  if ((long long)p.n_chunks * (1 + 2 * MAXR) * 4 >
      cd_front_bytes<TKV, MAXR, D>())
    return cudaErrorInvalidValue;
  // above 48 KB dynamic shared memory must be allowed explicitly, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      chunked_decode_kernel<TQ, TKV, MAXR, D, PAGED, TILED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.KV * p.n_tiles, p.B, p.n_chunks);
  chunked_decode_kernel<TQ, TKV, MAXR, D, PAGED, TILED>
      <<<grid, CD_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// The instance of the wrapper's row-tile plan (decode_attention.row_tiles):
// row_tile = 2, 8 or (D = 128 only) MAX_ROWS rows per CTA, in n_tiles =
// ceil(G * T / row_tile) tiles per KV head; more than one tile takes the
// TILED 8-row instance (any other tiled plan is refused).
template <typename TQ, typename TKV, int D, bool PAGED>
cudaError_t launch_chunked_decode_typed(const DecodeParams& p,
                                        cudaStream_t st) {
  const int rows = p.H / p.KV * p.T;
  if (p.row_tile < 1 || p.n_tiles != (rows + p.row_tile - 1) / p.row_tile)
    return cudaErrorInvalidValue;
  const bool tiled = p.n_tiles > 1;
  if (p.row_tile == 2 && !tiled)
    return launch_chunked_decode_rows<TQ, TKV, 2, D, PAGED, false>(p, st);
  if (p.row_tile == 8)
    return tiled
        ? launch_chunked_decode_rows<TQ, TKV, 8, D, PAGED, true>(p, st)
        : launch_chunked_decode_rows<TQ, TKV, 8, D, PAGED, false>(p, st);
  if constexpr (D == CD_THREADS) {
    if (p.row_tile == MAX_ROWS && !tiled)
      return launch_chunked_decode_rows<TQ, TKV, MAX_ROWS, D, PAGED, false>(
          p, st);
  }
  return cudaErrorInvalidValue;
}

template <typename TQ, int D, bool PAGED>
cudaError_t launch_chunked_decode_kv(const DecodeParams& p, int kv_dtype,
                                     cudaStream_t st) {
  switch (kv_dtype) {
    case 0: return launch_chunked_decode_typed<TQ, float, D, PAGED>(p, st);
    case 1:
      return launch_chunked_decode_typed<TQ, __nv_bfloat16, D, PAGED>(p, st);
  }
  if constexpr (PAGED) {
    switch (kv_dtype) {
      case 2: return launch_chunked_decode_typed<TQ, int8_t, D, true>(p, st);
      case 3:
        return launch_chunked_decode_typed<TQ, __nv_fp8_e4m3, D, true>(p, st);
    }
  }
  return cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16; the paged pools also 2 = int8
// and 3 = float8_e4m3fn, the quantized pools, which need both scale pools
// (and only they take scales).  Each of decode_attention.cu (dense) and
// paged_attention.cu (paged) instantiates its own mode at its library's
// head dim D; a launch at another head dim `d` is refused.
template <bool PAGED, int D>
cudaError_t launch_chunked_decode(const DecodeParams& p, int d, int q_dtype,
                                  int kv_dtype, cudaStream_t st) {
  if (d != D || p.page_size < 1 || p.chunk % p.page_size ||
      p.split % p.page_size || p.n_chunks < 1 ||
      (PAGED && p.chunk / p.page_size > CD_TABLE))
    return cudaErrorInvalidValue;
  const bool quant = kv_dtype == 2 || kv_dtype == 3;
  if ((p.ks != nullptr) != quant || (p.vs != nullptr) != quant)
    return cudaErrorInvalidValue;
  if (q_dtype == 0)
    return launch_chunked_decode_kv<float, D, PAGED>(p, kv_dtype, st);
  if (q_dtype == 1)
    return launch_chunked_decode_kv<__nv_bfloat16, D, PAGED>(p, kv_dtype, st);
  return cudaErrorInvalidValue;
}

}  // namespace

#ifdef CD_TRACE
// The diagnostic build's records (``bytes`` of them) into host memory, and
// all of them zeroed.
extern "C" int cd_trace_read(void* host, long long bytes) {
  return (int)cudaMemcpyFromSymbol(host, cd_trace, bytes);
}
extern "C" int cd_trace_clear() {
  void* ptr = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&ptr, cd_trace);
  return e ? (int)e : (int)cudaMemset(ptr, 0, sizeof(cd_trace));
}
#endif
