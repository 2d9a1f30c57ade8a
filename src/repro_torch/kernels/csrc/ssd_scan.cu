// Mamba2 SSD intra-chunk compute for Hopper (sm_90a) on the tensor cores,
// forward only, with a plain C interface loaded via ctypes.
//
// Replaces
//   ssd_chunk_tpu (src/repro/kernels/ssd_scan.py:54, _ssd_kernel)
//
// For each (batch, chunk n, head h), with head h reading B/C group
// g = h / (NH / G), Q positions i, j in the chunk:
//   att[i, j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j      (j <= i)
//   y         = att @ x                                      (Q, hp)
//   state     = (B * exp(cum_{Q-1} - cum) * dt)^T @ x          (ds, hp), f32
// x (B, NC, NH, Q, hp), b/c (B, NC, G, Q, ds) and dt/cum (B, NC, NH, Q) f32
// are read in place through strides (the model hands in transposed views
// of its (B, S, ...) activations; nothing is copied).  y is written
// contiguous (B, NC, NH, Q, hp) in x's dtype, state contiguous
// (B, NC, NH, ds, hp) f32.  As the TPU kernel: C.B^T and the state product
// are f32-accurate, att is rounded to x's dtype before att @ x, and the
// mask selects before anything multiplies, so exp(cum_i - cum_j) of j > i,
// which overflows (cum decreases along the chunk), never reaches a product.
//
// What bounds it on an H100.  C.B^T takes 2 ds flops per (i, j <= i) pair
// per (chunk, group), att @ x 2 hp per pair and the state 2 Q ds hp per
// (chunk, head).  At mamba2-1.3b's prefill shapes (B = 2, NC = 16, NH = 64,
// G = 1, Q = 256, hp = 64, ds = 128) that is 17.48 GFLOP against 348 MB of
// x, B, C, dt, cum, y and state.  At the 3xTF32 rate (495 / 3 = 165
// TFLOP/s of f32-accurate tensor-core work) the operations take 0.106 ms,
// level with the bytes at 3.35 TB/s, 0.104 ms; on the CUDA cores (67
// TFLOP/s), where the PR 13 design ran, 0.261 ms.
//
// What the design does about it:
//   * All three products run on the tensor cores as Hopper's warpgroup
//     products, wgmma.mma_async m64nNk8 TF32 with f32 accumulation: the
//     CTA's 4 warps are one warpgroup of 64 rows, the A operand (C, att,
//     (B * w)^T) is in registers, laid out as mma.m16n8k8's A per warp, and
//     the B operand (B^T tiles, x^T tiles) is in shared memory in the
//     K-major layout TF32 requires (the helpers are wgmma_tf32.cuh's, shared
//     with the many-row attention kernel).  (mma.sync m16n8k8, the earlier
//     design, left this kernel issue-bound: each warp loaded and split all
//     of x for its 16 rows.)  An f32 operand is split into big and small
//     TF32 parts (3xTF32, attention_common.cuh's Frag); a.b is the three
//     products small.big + big.small + big.big, in that order.
//     bf16 C, B and x, and att rounded to bf16, are exact in TF32: one
//     product for C.B^T and att @ x, two for the state, whose B * w is f32.
//     The accumulation truncates, so each product is summed over 32 of its
//     depth (ds for C.B^T, keys for att @ x, positions for the state) in
//     fresh registers and added to the running sum in f32.
//   * One CTA per (work unit, block of hpc <= 8 heads of one group,
//     chunk).  Unit u holds row block NRB - 1 - u (64 rows; the heaviest
//     first) and state slice u (64 of the ds rows), where either exists:
//     NRB = ceil(Q / 64), ND = ceil(ds / 64), NX = max(NRB, ND).  At
//     mamba2's shapes units 0 and 1 hold row blocks 3 and 2 and the two
//     state slices, whose positions they load anyway; units 2 and 3 row
//     blocks 1 and 0.  The units of a (head block, chunk) run side by
//     side, so the x tiles they share come from L2: x is read from device
//     memory once.
//   * Phase 1, once per CTA: C.B^T of the row block for keys [0, i0 + 64),
//     32-key tiles of B in a 2-stage cp.async ring (cp.async writes each
//     16-byte row of a core matrix in place; f32 tiles are split in place,
//     the small parts beside them).  The C rows are split once into A
//     fragments.  Each warp stores its accumulator fragments for the keys
//     up to its last row in shared memory (59 KB at Q = 256), where only
//     the same lane reads them back: C.B^T is computed once per hpc heads.
//   * Phase 2, per head of the block: 32-position tiles of x, of the state
//     slice's 64 columns of B and of cum and dt, in a 2-stage cp.async
//     ring that runs on from one head into the next.  A pass transposes
//     the x tile into the K-major B layout and splits it once for all
//     warps: k index t (t + 4) of an 8-key step is key 2t (2t + 1), so the
//     C.B^T fragment's columns (2t, 2t + 1) are att's k indices (t, t + 4),
//     as many_row_attention.cuh feeds P to P V.  Per 8-key step each warp
//     forms att in registers from its C.B^T fragment (the mask, exp, dt
//     and the rounding per element) and (B * w)^T from the B tile (w of the
//     tile's positions is one exp per lane, shuffled to where it is used);
//     y and the state then take the same x^T tile.  A operands come in two
//     register sets, so one step's are formed while the last step's
//     products run.  The state is written straight from registers: one
//     launch, no partial states, no atomics (the same bits run to run, and
//     a chunk alone gives the bits it gives in a batch).
//   * The triangle: a row block loads and multiplies keys [0, i0 + 64)
//     only, so no 64 x 8 product lies wholly above its diagonal; within
//     the diagonal block a warp's att above its own rows is selected to 0.
//   * 128 threads, up to 109 KB of shared memory per CTA (f32; phase 1's
//     C staging and B ring share their space with phase 2's ring), two
//     CTAs per SM (__launch_bounds__(128, 2)).  Copies move 4 elements at a
//     time, 16 bytes of f32 (cp.async.cg) or 8 of bf16 (cp.async.ca), so
//     the wrapper's 4-element alignment of rows suffices for both.
// Not yet done (later work): a producer warp with TMA, more heads per
// C.B^T, and overlapping one tile's transpose with the last tile's
// products (it needs a second x^T buffer, past two CTAs per SM).

#include <type_traits>

#include "attention_common.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int NT = 128;   // threads per CTA: 4 warps
constexpr int RB = 64;    // query rows per row block (4 warps x 16)
constexpr int TK = 32;    // keys / positions per ring stage
constexpr int HP = 64;    // head dim (the built width)
constexpr int SL = 64;    // state rows (of ds) per slice: 4 warps x 16
constexpr int MAXKQ = 4;  // 32-wide blocks of ds, at most (ds <= 128)
constexpr int MAXKS = 4 * MAXKQ;  // 8-wide steps of ds, at most

struct SsdParams {
  const void* x;
  const void* b;
  const void* c;
  const float* dt;
  const float* cum;
  void* y;       // contiguous (B, NC, NH, Q, HP), x's dtype
  float* state;  // contiguous (B, NC, NH, ds, HP)
  int NC, NH, G, Q, ds, hpc;
  int NRB, ND, NX;  // row blocks, state slices, work units
  long long x_sb, x_sn, x_sh, x_sq;  // x: (batch, chunk, head, position)
  long long b_sb, b_sn, b_sg, b_sq;  // b: (batch, chunk, group, position)
  long long c_sb, c_sn, c_sg, c_sq;
  long long d_sb, d_sn, d_sh, d_sq;  // dt
  long long u_sb, u_sn, u_sh, u_sq;  // cum
};

// Shared-memory rows in elements: 16 bytes of padding (4 f32, 8 bf16).
template <typename T>
struct Lay {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LX = HP + PAD;  // x tile rows
  static constexpr int LS = SL + PAD;  // state slice rows of B
  __host__ __device__ static int lb(int ds) { return ds + PAD; }  // C
};

// exp(x) as 2^(x log2 e) with ex2.approx.ftz (relative error ~2^-22; a
// result below the smallest normal f32 is 0, as it is to the sums here).
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Four consecutive elements, global to shared: 16 bytes of f32, 8 of bf16.
__device__ __forceinline__ void cp_async_4el(float* dst, const float* src) {
  cp_async16(dst, src, true);
}
__device__ __forceinline__ void cp_async_4el(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src) {
  cp_async8(dst, src, true);
}

// Warp w of a row block at i0: its 16 rows see keys [0, i0 + 16 w + 16),
// 2 (i0 / 16 + w + 1) n-tiles of 8 keys; its C.B^T fragments start at
// 128 floats (32 lanes x 4) per n-tile of the warps before it.
__host__ __device__ inline int cb_base(int i0, int w) {
  return 128 * w * (i0 / 8 + w + 1);
}

// Floats of C.B^T fragments a row block at i0 keeps: its warps with rows.
__host__ __device__ inline int cb_floats(int i0, int Q) {
  int w = 0;
  while (w < 4 && i0 + 16 * w < Q) ++w;
  return cb_base(i0, w);
}

// The most any row block of a chunk of Q positions keeps (the region's
// size, the same for every CTA of a launch).
__host__ __device__ inline int cb_floats_max(int Q) {
  int most = 0;
  for (int i0 = 0; i0 < Q; i0 += RB) {
    const int f = cb_floats(i0, Q);
    most = f > most ? f : most;
  }
  return most;
}

template <typename T>
size_t ssd_smem_bytes(int Q, int ds) {
  const size_t es = sizeof(T);
  // C rows, then 2 B tiles and their split (f32: small parts; bf16: f32)
  const size_t c_rows = (size_t)RB * Lay<T>::lb(ds) * es;
  const size_t b_ring = 2 * (size_t)TK * ds * es + (size_t)TK * ds * 4;
  const size_t phase1 = c_rows > b_ring ? c_rows : b_ring;
  const size_t phase2 =
      2 * ((size_t)TK * (Lay<T>::LX + Lay<T>::LS) * es + 2 * TK * 4) +
      (sizeof(T) == 4 ? 2 : 1) * (size_t)(TK / 8) * XT_KSTEP * 4;  // x^T
  return 4 * (size_t)cb_floats_max(Q) + (phase1 > phase2 ? phase1 : phase2);
}

// Grid (NX, NH / hpc, B * NC).  Lane (g = lane / 4, t = lane % 4) holds
// rows g and g + 8 of every fragment, as in many_row_attention.cuh.
template <typename T>
__global__ void __launch_bounds__(NT, 2) ssd_chunk_kernel(SsdParams p) {
  constexpr bool SX = std::is_same<T, float>::value;  // f32: split x, C, B
  using L = Lay<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = p.Q, ds = p.ds, nkq = ds / 32;
  const int ux = blockIdx.x;
  const int rb = p.NRB - 1 - ux;  // row block, heaviest first (< 0: none)
  const int slice = ux < p.ND ? ux : -1;  // state slice (< 0: none)
  const bool has_rows = rb >= 0, has_state = slice >= 0;
  const int i0 = has_rows ? rb * RB : 0;
  const int kend = has_rows ? min(Q, i0 + RB) : 0;  // keys the rows see
  const int h0 = blockIdx.y * p.hpc;
  const int grp = h0 / (p.NH / p.G);
  const int bn = blockIdx.z, bb = bn / p.NC, n = bn - bb * p.NC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool active = has_rows && i0 + 16 * warp < Q;  // the warp has rows
  const int r0 = i0 + 16 * warp + g, rlast = i0 + 16 * warp + 15;
  const int ntw = active ? (rlast + 1) / 8 : 0;  // the warp's key n-tiles

  float* cbs = reinterpret_cast<float*>(smem);  // C.B^T fragments
  float* cbw = cbs + cb_base(i0, warp) + lane * 4;  // this lane's, n-tile 0
  // phase 1's C staging and B ring, then phase 2's ring
  T* us = reinterpret_cast<T*>(smem + 4 * (size_t)cb_floats_max(Q));

  const T* bbase = static_cast<const T*>(p.b) + bb * p.b_sb + n * p.b_sn +
                   grp * p.b_sg;

  // ---- phase 1: C.B^T of this row block, into cbs ----------------------
  if (has_rows) {
    const int LB = L::lb(ds), D4 = ds / 4;
    const T* cbase = static_cast<const T*>(p.c) + bb * p.c_sb +
                     n * p.c_sn + grp * p.c_sg;
    for (int idx = tid; idx < RB * D4; idx += NT) {
      const int r = idx / D4, c4 = idx - r * D4;
      if (i0 + r < Q)  // the rows of a partial block's idle warps stay
        cp_async_4el(us + r * LB + 4 * c4, cbase + (i0 + r) * p.c_sq + 4 * c4);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    // this warp's C rows as wgmma A fragments, split once: k-step ks of
    // ds (8 wide), k index t is d = 8 ks + t, k index t + 4 is d + 4 (a
    // warp without rows multiplies zeros)
    Frag<4, SX> ac[MAXKS];
#pragma unroll
    for (int ks = 0; ks < MAXKS; ++ks) {
      if (ks >= 4 * nkq) continue;
      const T* cr = us + (16 * warp + g) * LB + 8 * ks + t;
      ac[ks].set(0, active ? to_f(cr[0]) : 0.f);
      ac[ks].set(1, active ? to_f(cr[8 * LB]) : 0.f);
      ac[ks].set(2, active ? to_f(cr[4]) : 0.f);
      ac[ks].set(3, active ? to_f(cr[8 * LB + 4]) : 0.f);
    }
    __syncthreads();  // C consumed: the B ring takes its space

    // B tiles of TK keys in wgmma's K-major layout (as x^T in phase 2):
    // 4 elements of ds of one key are a 16-byte core-matrix row, so
    // cp.async writes them in place.  A 2-stage ring of the raw values;
    // f32: split in place into big parts, the small parts beside them;
    // bf16: converted to f32 beside them.
    const int BT = TK * ds;  // elements of a tile
    float* bsplit = reinterpret_cast<float*>(us + 2 * BT);
    auto load_b = [&](int k0, int st) {
      T* bs = us + st * BT;
      for (int idx = tid; idx < TK * D4; idx += NT) {
        const int k = idx / D4, c4 = idx - k * D4;
        cp_async_4el(bs + bt_offset(k, c4),
                     bbase + (k0 + k) * p.b_sq + 4 * c4);
      }
    };
    load_b(0, 0);
    cp_async_commit();
    int st = 0;
    for (int k0 = 0; k0 < kend; k0 += TK, st ^= 1) {
      // tile k0 has landed, and the last tile's wgmma have completed
      cp_async_wait_all();
      __syncthreads();
      if (k0 + TK < kend) load_b(k0 + TK, st ^ 1);
      cp_async_commit();
      T* bs = us + st * BT;
      for (int i = 4 * tid; i < BT; i += 4 * NT) {
        float v[4], big[4], small[4];
        load4(bs + i, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          big[e] = SX ? __uint_as_float(tf32_rna(v[e])) : v[e];
          small[e] = __uint_as_float(tf32_rna(v[e] - big[e]));
        }
        if constexpr (SX) {
          store4(reinterpret_cast<float*>(bs) + i, big);
          store4(bsplit + i, small);
        } else {
          store4(bsplit + i, big);
        }
      }
      fence_proxy_async();
      __syncthreads();
      const float* bbig = SX ? reinterpret_cast<const float*>(bs) : bsplit;
      const float* bsml = bsplit;
      float s[16], f[16];  // keys k0 + 8 c + 2 t (+ 1) in wgmma's layout
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = 0.f;
#pragma unroll
      for (int kq = 0; kq < MAXKQ; ++kq) {
        if (kq >= nkq) continue;
        // 32 of ds in fresh registers
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ks = 4 * kq + k;
          const uint64_t db = smem_desc(bbig + ks * BT_KSTEP);
          const uint64_t dsm = smem_desc(bsml + ks * BT_KSTEP);
          if constexpr (SX) {
            wgmma_tf32(f, ac[ks].small, db, k > 0);
            wgmma_tf32(f, ac[ks].big, dsm, 1);
            wgmma_tf32(f, ac[ks].big, db, 1);
          } else {
            wgmma_tf32(f, ac[ks].big, db, k > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(f);
#pragma unroll
        for (int i = 0; i < 16; ++i) s[i] += f[i];
      }
      const int nt0 = k0 / 8;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (nt0 + c < ntw)
          *reinterpret_cast<float4*>(cbw + (nt0 + c) * 128) =
              make_float4(s[4 * c], s[4 * c + 1], s[4 * c + 2], s[4 * c + 3]);
    }
    // every A fragment stayed live through the last wgmma
#pragma unroll
    for (int ks = 0; ks < MAXKS; ++ks) {
      fence_regs(ac[ks].big);
      fence_regs(ac[ks].small);
    }
    __syncthreads();  // the ring consumed: phase 2 takes its space
  }

  // ---- phase 2: per head, y = att @ x and the state slice --------------
  const int npt = (has_state ? Q : kend) / TK;  // tiles per head
  const int total = p.hpc * npt;
  const int s0 = SL * slice;
  const bool sw = has_state && s0 + 16 * warp < ds;  // the warp's state rows
  constexpr int STAGE = TK * (L::LX + L::LS);
  float* cds = reinterpret_cast<float*>(us + 2 * STAGE);  // [2][cum|dt][TK]
  // x^T of the current tile as wgmma's B operand: TF32 big parts, then
  // (f32) small parts, each TK / 8 k-steps of 8 x 64 (XT_KSTEP floats)
  float* xtb = cds + 2 * 2 * TK;
  float* xts = xtb + (TK / 8) * XT_KSTEP;

  // tile (head hh, positions q0 ..) into ring stage st.  A thread copies
  // the same 4 columns of rows kb, kb + 8, .. of x and of the B slice in
  // every tile, and (tid < 2 TK) cum or dt of position q0 + tid % TK.
  static_assert(TK * HP / 4 == 4 * NT && TK * SL / 4 == 4 * NT,
                "each thread copies 4 chunks of x and of the B slice");
  const int kb = tid / (HP / 4), c4 = tid % (HP / 4);
  const T* xcol = static_cast<const T*>(p.x) + bb * p.x_sb + n * p.x_sn +
                  h0 * p.x_sh + kb * p.x_sq + 4 * c4;
  const T* bcol = bbase + kb * p.b_sq + s0 + 4 * c4;
  const bool bcopy = has_state && s0 + 4 * c4 < ds;  // a partial last slice
  const float* cdcol =
      tid < TK ? p.cum + bb * p.u_sb + n * p.u_sn + h0 * p.u_sh +
                     tid * p.u_sq
               : p.dt + bb * p.d_sb + n * p.d_sn + h0 * p.d_sh +
                     (tid - TK) * p.d_sq;
  const long long cd_sh = tid < TK ? p.u_sh : p.d_sh;
  const long long cd_sq = tid < TK ? p.u_sq : p.d_sq;
  auto load_p = [&](int hh, int q0, int st) {
    T* xs = us + st * STAGE;
    const T* xsrc = xcol + hh * p.x_sh + q0 * p.x_sq;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cp_async_4el(xs + (kb + 8 * r) * L::LX + 4 * c4,
                   xsrc + 8 * r * p.x_sq);
    if (bcopy) {
      T* bsl = xs + TK * L::LX;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cp_async_4el(bsl + (kb + 8 * r) * L::LS + 4 * c4,
                     bcol + (q0 + 8 * r) * p.b_sq);
    }
    if (tid < 2 * TK)
      cp_async4(cds + st * 2 * TK + tid, cdcol + hh * cd_sh + q0 * cd_sq,
                true);
  };

  // cum of this lane's two rows and of the chunk's last position, for
  // head hh, read ahead of the head's first tile
  float nxt[3];
  auto head_cum = [&](int hh) {
    const float* cu = p.cum + bb * p.u_sb + n * p.u_sn + (h0 + hh) * p.u_sh;
    nxt[0] = active ? cu[r0 * p.u_sq] : 0.f;
    nxt[1] = active ? cu[(r0 + 8) * p.u_sq] : 0.f;
    nxt[2] = cu[(Q - 1) * p.u_sq];
  };
  head_cum(0);

  // accumulators in wgmma's layout: element 4 c + e is row (g + 8 (e >> 1))
  // of the warp's 16, column 8 c + 2 t + (e & 1)
  float yacc[32], sacc[32];
  float dy[32], dsn[32];  // this tile's sums, in fresh registers
  float cum_r[2] = {0.f, 0.f}, cum_last = 0.f;
  T* y = static_cast<T*>(p.y);
  if (total > 0) load_p(0, 0, 0);
  cp_async_commit();
  int st = 0, hh = 0, tt = 0;  // tile T_ is tile tt of head hh
  for (int T_ = 0; T_ < total; ++T_, st ^= 1) {
    const int q0 = tt * TK;
    if (tt == 0) {
      cum_r[0] = nxt[0];
      cum_r[1] = nxt[1];
      cum_last = nxt[2];
      if (hh + 1 < p.hpc) head_cum(hh + 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[i] = sacc[i] = 0.f;
    }
    // tile T_ has landed; every warp is done with tile T_ - 1, and its
    // wgmma have completed (waited for at its end)
    cp_async_wait_all();
    __syncthreads();
    if (tt + 1 < npt)
      load_p(hh, q0 + TK, st ^ 1);
    else if (hh + 1 < p.hpc)
      load_p(hh + 1, 0, st ^ 1);
    cp_async_commit();
    const T* xs = us + st * STAGE;
    const T* bsl = xs + TK * L::LX;
    const float* cums = cds + st * 2 * TK;
    const float* dts = cums + TK;
    // x^T into wgmma's K-major layout, split once for all warps: k-step
    // ks, column n: k index t (t + 4) is key 8 ks + 2 t (+ 1), so the
    // C.B^T fragment's columns (2t, 2t + 1) are att's k indices (t, t + 4)
    for (int it = tid; it < (TK / 8) * HP; it += NT) {
      const int ks = it / HP, col = it - ks * HP;
      float v[8];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        v[kk] = to_f(xs[(8 * ks + kk) * L::LX + col]);
      const int off = ks * XT_KSTEP + xt_offset(col);
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        float big[4], small[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = v[2 * i + kc];
          big[i] = SX ? __uint_as_float(tf32_rna(x)) : x;
          small[i] = __uint_as_float(tf32_rna(x - big[i]));
        }
        store4(xtb + off + kc * KCORE, big);
        if (SX) store4(xts + off + kc * KCORE, small);
      }
    }
    fence_proxy_async();  // the generic-proxy writes, seen by wgmma
    __syncthreads();

    const bool yt = q0 < kend;  // CTA-uniform: the tile feeds y
    // w of position q0 + lane: one exp per lane, shuffled where used
    const float wl = has_state ? exp_approx(cum_last - cums[lane]) * dts[lane]
                               : 0.f;
    // A operands in two sets: k-step ks + 1's are formed while k-step
    // ks's wgmma run
    Frag<4, SX> ays[2];
    Frag<4, true> ass[2];
#pragma unroll
    for (int ks = 0; ks < TK / 8; ++ks) {
      const int kk = 8 * ks + 2 * t;  // keys kk, kk + 1 of the tile
      Frag<4, SX>& ay = ays[ks & 1];
      Frag<4, true>& as = ass[ks & 1];
      if (yt) {
        // att of rows (r0, r0 + 8) x keys (q0 + kk, + 1): element e of the
        // C.B^T fragment is row r0 + 8 (e >> 1), key q0 + kk + (e & 1)
        float at[4] = {0.f, 0.f, 0.f, 0.f};
        if (active && q0 + 8 * ks <= rlast) {
          const float4 cb = *reinterpret_cast<const float4*>(
              cbw + ((q0 + 8 * ks) / 8) * 128);
          const float cbv[4] = {cb.x, cb.y, cb.z, cb.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + 8 * (e >> 1), j = q0 + kk + (e & 1);
            const float v = cbv[e] *
                            exp_approx(cum_r[e >> 1] - cums[kk + (e & 1)]) *
                            dts[kk + (e & 1)];
            at[e] = j <= r ? to_f(from_f<T>(v)) : 0.f;  // select first
          }
        }
        ay.set(0, at[0]);
        ay.set(1, at[2]);
        ay.set(2, at[1]);
        ay.set(3, at[3]);
      }
      if (has_state) {
        // (B * w)^T of state rows s0 + 16 warp + (g, g + 8) x positions
        // kk, kk + 1
        const float w0 = __shfl_sync(0xffffffffu, wl, kk);
        const float w1 = __shfl_sync(0xffffffffu, wl, kk + 1);
        float bw[4] = {0.f, 0.f, 0.f, 0.f};
        if (sw) {
          const T* br = bsl + kk * L::LS + 16 * warp + g;
          bw[0] = to_f(br[0]) * w0;
          bw[1] = to_f(br[8]) * w0;
          bw[2] = to_f(br[L::LS]) * w1;
          bw[3] = to_f(br[L::LS + 8]) * w1;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) as.set(i, bw[i]);
      }
      // the split's products, each m64 n64 k8 over the warpgroup
      const uint64_t db = smem_desc(xtb + ks * XT_KSTEP);
      const uint64_t dsm = smem_desc(xts + ks * XT_KSTEP);
      const int acc = ks > 0;  // the tile's first product starts fresh
      wgmma_fence();
      if (yt) {
        if constexpr (SX) {
          wgmma_tf32(dy, ay.small, db, acc);
          wgmma_tf32(dy, ay.big, dsm, 1);
        }
        wgmma_tf32(dy, ay.big, db, SX ? 1 : acc);
      }
      if (has_state) {
        wgmma_tf32(dsn, as.small, db, acc);
        if constexpr (SX) wgmma_tf32(dsn, as.big, dsm, 1);
        wgmma_tf32(dsn, as.big, db, 1);
      }
      wgmma_commit();
      // k-step ks - 1's wgmma are done: its A registers, kept until here,
      // may be formed anew
      wgmma_wait<1>();
      fence_regs(ays[(ks + 1) & 1].big);
      fence_regs(ays[(ks + 1) & 1].small);
      fence_regs(ass[(ks + 1) & 1].big);
      fence_regs(ass[(ks + 1) & 1].small);
    }
    // all done: the accumulators are read only from here on
    wgmma_wait<0>();
    fence_regs(ays[1].big);
    fence_regs(ays[1].small);
    fence_regs(ass[1].big);
    fence_regs(ass[1].small);
    fence_regs(dy);
    fence_regs(dsn);
    if (yt) {
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[i] += dy[i];
    }
    if (has_state) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] += dsn[i];
    }

    if (tt == npt - 1) {  // the head's last tile: write y and the state
      const long long bh = (long long)bn * p.NH + h0 + hh;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = 8 * c + 2 * t;
          if (active)
            store2(y + (bh * Q + r0 + 8 * h2) * HP + col,
                   yacc[4 * c + 2 * h2], yacc[4 * c + 2 * h2 + 1]);
          if (sw)
            store2(p.state + (bh * ds + s0 + 16 * warp + g + 8 * h2) * HP +
                       col,
                   sacc[4 * c + 2 * h2], sacc[4 * c + 2 * h2 + 1]);
        }
    }
    if (++tt == npt) {
      tt = 0;
      ++hh;
    }
  }
}

template <typename T>
cudaError_t launch_ssd(const SsdParams& p, int B, cudaStream_t st) {
  // the largest layout the wrapper admits (Q = 256, ds = 128) is past the
  // 48 KB static limit, so it is allowed explicitly, once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ssd_smem_bytes<T>(256, 128));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.NX, p.NH / p.hpc, B * p.NC);
  ssd_chunk_kernel<T><<<grid, NT, ssd_smem_bytes<T>(p.Q, p.ds), st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements, four per tensor: x (batch, chunk, head,
// position), b/c (batch, chunk, group, position), dt/cum (batch, chunk,
// head, position); x's and b/c's last dimension must be contiguous and
// their rows aligned to 4 elements.  x, b and c share one dtype (0 =
// float32, 1 = bfloat16); dt and cum are f32.  Needs hp = 64, ds % 32 == 0
// with 32 <= ds <= 128, Q % 32 == 0 with 32 <= Q <= 256, and hpc dividing
// NH / G.  One launch.  Returns its cudaError_t (0 = success).
extern "C" int ssd_chunk_fwd(
    const void* x, const void* b, const void* c, const float* dt,
    const float* cum, void* y, float* state, int B, int NC, int NH, int G,
    int Q, int ds, int hp, int hpc, const long long* x_strides,
    const long long* b_strides, const long long* c_strides,
    const long long* dt_strides, const long long* cum_strides, int dtype,
    void* stream) {
  if (hp != HP || ds % 32 || ds < 32 || ds > 32 * MAXKQ || Q % TK ||
      Q < TK || Q > 4 * RB || G < 1 || NH % G || hpc < 1 || (NH / G) % hpc)
    return (int)cudaErrorInvalidValue;
  SsdParams p{};
  p.x = x; p.b = b; p.c = c; p.dt = dt; p.cum = cum; p.y = y;
  p.state = state;
  p.NC = NC; p.NH = NH; p.G = G; p.Q = Q; p.ds = ds; p.hpc = hpc;
  p.NRB = (Q + RB - 1) / RB;
  p.ND = (ds + SL - 1) / SL;
  p.NX = p.NRB > p.ND ? p.NRB : p.ND;
  p.x_sb = x_strides[0]; p.x_sn = x_strides[1];
  p.x_sh = x_strides[2]; p.x_sq = x_strides[3];
  p.b_sb = b_strides[0]; p.b_sn = b_strides[1];
  p.b_sg = b_strides[2]; p.b_sq = b_strides[3];
  p.c_sb = c_strides[0]; p.c_sn = c_strides[1];
  p.c_sg = c_strides[2]; p.c_sq = c_strides[3];
  p.d_sb = dt_strides[0]; p.d_sn = dt_strides[1];
  p.d_sh = dt_strides[2]; p.d_sq = dt_strides[3];
  p.u_sb = cum_strides[0]; p.u_sn = cum_strides[1];
  p.u_sh = cum_strides[2]; p.u_sq = cum_strides[3];
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_ssd<float>(p, B, st);
  if (dtype == 1) return (int)launch_ssd<__nv_bfloat16>(p, B, st);
  return (int)cudaErrorInvalidValue;
}
