// Mamba2 SSD intra-chunk compute for Hopper (sm_90a), forward only, with a
// plain C interface loaded via ctypes.
//
// Replaces
//   ssd_chunk_tpu (src/repro/kernels/ssd_scan.py, _ssd_kernel)
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
// accumulate in f32, att is rounded to x's dtype before att @ x, and the
// mask selects before anything multiplies, so exp(cum_i - cum_j) of j > i,
// which overflows (cum decreases along the chunk), is never evaluated.
//
// What bounds it on an H100: operations.  Per (chunk, group) C.B^T takes
// 2 * ds flops per (i, j <= i) pair; per (chunk, head) att @ x takes
// 2 * hp per pair and the state 2 * Q * ds * hp.  At mamba2-1.3b's shapes
// (Q = 256, hp = 64, ds = 128, NH = 64, G = 1) that is 545 MFLOP per chunk
// against ~11 MB of x, y and state: ~50 flops per byte, above the card's
// non-tensor f32 balance (67 TFLOP/s over 3.35 TB/s = 20).
//
// What the design does about it:
//   * the TPU grid (B * NC, NH) recomputes the (Q x Q x ds) product C.B^T
//     for every head although all heads of a group share it (with G = 1,
//     all 64), and it is the largest product per head (ds = 128 against
//     hp = 64).  Here one CTA computes C.B^T once for a block of RB = 64
//     query rows of one (chunk, group) and then loops over HPC (<= 8)
//     heads of that group, applying each head's decay and dt and
//     accumulating att @ x: C.B^T is recomputed once per 8 heads, not per
//     head;
//   * key tiles above the diagonal are skipped: the row block at i0 loads
//     and multiplies only keys [0, i0 + RB) (the TPU kernel multiplies the
//     full Q x Q tile and masks);
//   * a full (Q, Q) f32 tile at Q = 256 is 256 KB, above the 227 KB a CTA
//     may use, so the query rows are tiled: a CTA keeps its (RB, Q) slice
//     of C.B^T (64 KB) in shared memory, with the C rows and a 32-key B
//     tile (swizzled so that 8 lanes reading 8 key rows hit distinct
//     banks) in a region that the head loop then reuses for the x tile,
//     the att tile and the head's cum/dt; 112 KB in all, two CTAs per SM;
//   * row blocks are issued heaviest first (the last block has 4x the keys
//     of the first);
//   * the state, a (ds, hp) product over all Q positions per head, is a
//     second kernel, one CTA per (chunk, head), each thread accumulating
//     an 8 x 4 block of it in registers.
// Not yet done (later work): mma.sync / wgmma for the three products (the
// f32 CUDA-core FMA rate is the ceiling of this version), cp.async/TMA
// rings, and sharing one CTA's B tiles between the state of several heads.

#include "attention_common.cuh"

namespace {

constexpr int RB = 64;     // query rows per intra CTA
constexpr int KT = 32;     // keys per tile
constexpr int HP = 64;     // head dim (the built width)
constexpr int NT = 256;    // threads per CTA
constexpr int ATLD = RB + 4;  // att tile row stride (float4-aligned)

struct SsdParams {
  const void* x;
  const void* b;
  const void* c;
  const float* dt;
  const float* cum;
  void* y;       // contiguous (B, NC, NH, Q, HP), x's dtype
  float* state;  // contiguous (B, NC, NH, ds, HP)
  int NC, NH, G, Q, ds, hpc;
  long long x_sb, x_sn, x_sh, x_sq;  // x: (batch, chunk, head, position)
  long long b_sb, b_sn, b_sg, b_sq;  // b: (batch, chunk, group, position)
  long long c_sb, c_sn, c_sg, c_sq;
  long long d_sb, d_sn, d_sh, d_sq;  // dt
  long long u_sb, u_sn, u_sh, u_sq;  // cum
};

// Four consecutive elements as f32 into shared memory (16-byte store).
template <typename T>
__device__ __forceinline__ void stage4(const T* src, float* dst) {
  float f[4];
  load4(src, f);
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

size_t intra_smem_bytes(int Q, int ds) {
  const int phase1 = RB * ds + KT * ds;
  const int phase2 = KT * HP + KT * ATLD + 2 * Q;
  return sizeof(float) * (RB * Q + (phase1 > phase2 ? phase1 : phase2));
}

// Grid (Q / RB row blocks, NH / hpc head chunks, B * NC).  8 warps.  Its
// 112 KB of shared memory allows two CTAs per SM, so a thread may use up
// to 128 registers (without the bound ptxas kept fewer and spilled).
template <typename T>
__global__ void __launch_bounds__(NT, 2) ssd_intra_kernel(SsdParams p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, ds = p.ds, D4 = ds / 4;
  float* cb_s = sm;             // [RB][Q]: C_i . B_j of this row block
  float* un = sm + RB * Q;      // phase 1 / phase 2 union
  float* C_s = un;              // [RB][ds]
  float* B_s = un + RB * ds;    // [KT][ds], 16-byte chunks swizzled
  float* x_s = un;              // [KT][HP]
  float* at_s = un + KT * HP;   // [KT][ATLD]: att[i0 + r, kt + k]
  float* cum_s = at_s + KT * ATLD;  // [Q]
  float* dt_s = cum_s + Q;          // [Q]

  const int rb = gridDim.x - 1 - blockIdx.x;  // heaviest row block first
  const int i0 = rb * RB;
  const int h0 = blockIdx.y * p.hpc;
  const int g = h0 / (p.NH / p.G);
  const int bn = blockIdx.z, bb = bn / p.NC, n = bn - bb * p.NC;
  const int kend = min(Q, i0 + RB);  // keys [0, kend): none above the block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // ---- phase 1: cb_s = C[i0 : i0 + RB] . B[0 : kend]^T -----------------
  const T* cbase = static_cast<const T*>(p.c) + bb * p.c_sb + n * p.c_sn +
                   g * p.c_sg;
  const T* bbase = static_cast<const T*>(p.b) + bb * p.b_sb + n * p.b_sn +
                   g * p.b_sg;
  for (int idx = tid; idx < RB * D4; idx += NT) {
    const int r = idx / D4, c4 = idx - r * D4, i = i0 + r;
    if (i < Q) {
      stage4(cbase + i * p.c_sq + 4 * c4, C_s + r * ds + 4 * c4);
    } else {
      *reinterpret_cast<float4*>(C_s + r * ds + 4 * c4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int kt = 0; kt < kend; kt += KT) {
    __syncthreads();  // C_s staged / the previous B tile consumed
    for (int idx = tid; idx < KT * D4; idx += NT) {
      const int k = idx / D4, c4 = idx - k * D4;
      stage4(bbase + (kt + k) * p.b_sq + 4 * c4,
             B_s + k * ds + 4 * (c4 ^ (k & 7)));
    }
    __syncthreads();
    // lane = key kt + lane against the warp's 8 rows
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    const float* brow = B_s + lane * ds;
    for (int c4 = 0; c4 < D4; ++c4) {
      const float4 bv =
          *reinterpret_cast<const float4*>(brow + 4 * (c4 ^ (lane & 7)));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 cv = *reinterpret_cast<const float4*>(
            C_s + (warp * 8 + i) * ds + 4 * c4);
        s[i] = dot4(cv, bv, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) cb_s[(warp * 8 + i) * Q + kt + lane] = s[i];
  }

  // ---- phase 2: per head, att tiles and y = att @ x --------------------
  const int r0 = 4 * (tid / 16), c0 = 4 * (tid % 16);
  T* y = static_cast<T*>(p.y);
  for (int hh = 0; hh < p.hpc; ++hh) {
    const int h = h0 + hh;
    const float* cum = p.cum + bb * p.u_sb + n * p.u_sn + h * p.u_sh;
    const float* dt = p.dt + bb * p.d_sb + n * p.d_sn + h * p.d_sh;
    const T* xbase = static_cast<const T*>(p.x) + bb * p.x_sb +
                     n * p.x_sn + h * p.x_sh;
    __syncthreads();  // cb_s complete / the previous head's tiles consumed
    for (int j = tid; j < kend; j += NT) {
      cum_s[j] = cum[j * p.u_sq];
      dt_s[j] = dt[j * p.d_sq];
    }
    float acc[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[e][f] = 0.f;
    for (int kt = 0; kt < kend; kt += KT) {
      __syncthreads();  // cum_s/dt_s staged / the previous tile consumed
      for (int idx = tid; idx < KT * HP / 4; idx += NT) {
        const int k = idx / (HP / 4), c4 = idx - k * (HP / 4);
        stage4(xbase + (kt + k) * p.x_sq + 4 * c4, x_s + k * HP + 4 * c4);
      }
      for (int idx = tid; idx < KT * RB; idx += NT) {
        const int k = idx % KT, r = idx / KT;
        const int i = i0 + r, j = kt + k;
        float a = 0.f;
        if (j <= i && i < Q)  // select first: exp of j > i overflows
          a = cb_s[r * Q + j] * expf(cum_s[i] - cum_s[j]) * dt_s[j];
        at_s[k * ATLD + r] = to_f(from_f<T>(a));  // rounded to x's dtype
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KT; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(at_s + k * ATLD +
                                                           r0);
        const float4 xv = *reinterpret_cast<const float4*>(x_s + k * HP +
                                                           c0);
        const float a[4] = {av.x, av.y, av.z, av.w};
        const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[e][f] = fmaf(a[e], xx[f], acc[e][f]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + r0 + e;
      if (i >= Q) continue;
      T* o = y + (((long long)bn * p.NH + h) * Q + i) * HP + c0;
#pragma unroll
      for (int f = 0; f < 4; ++f) o[f] = from_f<T>(acc[e][f]);
    }
  }
}

// Grid (NH, B * NC).  Thread (s-group tid / 16, p-group tid % 16) owns
// state rows 8 * (tid / 16) .. + 7 and columns 4 * (tid % 16) .. + 3.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_state_kernel(SsdParams p) {
  __shared__ __align__(16) float B_s[KT * 128];
  __shared__ __align__(16) float x_s[KT * HP];
  __shared__ float w_s[KT];
  const int Q = p.Q, ds = p.ds, D4 = ds / 4;
  const int h = blockIdx.x, bn = blockIdx.y;
  const int bb = bn / p.NC, n = bn - bb * p.NC;
  const int g = h / (p.NH / p.G);
  const int tid = threadIdx.x;
  const int s0 = 8 * (tid / 16), p0 = 4 * (tid % 16);
  const float* cum = p.cum + bb * p.u_sb + n * p.u_sn + h * p.u_sh;
  const float* dt = p.dt + bb * p.d_sb + n * p.d_sn + h * p.d_sh;
  const T* xbase = static_cast<const T*>(p.x) + bb * p.x_sb + n * p.x_sn +
                   h * p.x_sh;
  const T* bbase = static_cast<const T*>(p.b) + bb * p.b_sb + n * p.b_sn +
                   g * p.b_sg;
  const float cum_last = cum[(Q - 1) * p.u_sq];

  float acc[8][4];
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int f = 0; f < 4; ++f) acc[e][f] = 0.f;
  for (int kt = 0; kt < Q; kt += KT) {
    __syncthreads();  // the previous tile consumed
    for (int idx = tid; idx < KT * D4; idx += NT) {
      const int k = idx / D4, c4 = idx - k * D4;
      stage4(bbase + (kt + k) * p.b_sq + 4 * c4, B_s + k * ds + 4 * c4);
    }
    for (int idx = tid; idx < KT * HP / 4; idx += NT) {
      const int k = idx / (HP / 4), c4 = idx - k * (HP / 4);
      stage4(xbase + (kt + k) * p.x_sq + 4 * c4, x_s + k * HP + 4 * c4);
    }
    if (tid < KT) {
      const int j = kt + tid;
      w_s[tid] = expf(cum_last - cum[j * p.u_sq]) * dt[j * p.d_sq];
    }
    __syncthreads();
    if (s0 < ds) {
#pragma unroll 4
      for (int k = 0; k < KT; ++k) {
        const float w = w_s[k];
        const float4 b0 = *reinterpret_cast<const float4*>(B_s + k * ds +
                                                           s0);
        const float4 b1 = *reinterpret_cast<const float4*>(B_s + k * ds +
                                                           s0 + 4);
        const float4 xv = *reinterpret_cast<const float4*>(x_s + k * HP +
                                                           p0);
        const float bw[8] = {b0.x * w, b0.y * w, b0.z * w, b0.w * w,
                             b1.x * w, b1.y * w, b1.z * w, b1.w * w};
        const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[e][f] = fmaf(bw[e], xx[f], acc[e][f]);
      }
    }
  }
  if (s0 >= ds) return;
  float* st = p.state + (((long long)bn * p.NH + h) * ds + s0) * HP + p0;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    *reinterpret_cast<float4*>(st + e * HP) =
        make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
}

template <typename T>
cudaError_t launch_ssd(const SsdParams& p, int B, cudaStream_t st) {
  // the largest layout the wrapper admits (Q = 256, ds = 128): 112 KB,
  // past the 48 KB static limit, so allowed explicitly, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_intra_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)intra_smem_bytes(256, 128));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Q + RB - 1) / RB, p.NH / p.hpc, B * p.NC);
  ssd_intra_kernel<T><<<grid, NT, intra_smem_bytes(p.Q, p.ds), st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_state_kernel<T><<<dim3(p.NH, B * p.NC), NT, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements, four per tensor: x (batch, chunk, head,
// position), b/c (batch, chunk, group, position), dt/cum (batch, chunk,
// head, position); x's and b/c's last dimension must be contiguous.  x, b
// and c share one dtype (0 = float32, 1 = bfloat16); dt and cum are f32.
// Needs hp = 64, ds % 32 == 0 with ds <= 128, Q % 32 == 0 with Q <= 256,
// and hpc dividing NH / G.  Returns the first launch's cudaError_t (0 =
// success).
extern "C" int ssd_chunk_fwd(
    const void* x, const void* b, const void* c, const float* dt,
    const float* cum, void* y, float* state, int B, int NC, int NH, int G,
    int Q, int ds, int hp, int hpc, const long long* x_strides,
    const long long* b_strides, const long long* c_strides,
    const long long* dt_strides, const long long* cum_strides, int dtype,
    void* stream) {
  if (hp != HP || ds % 32 || ds > 128 || Q % KT || Q > 256 || hpc < 1 ||
      (NH / G) % hpc)
    return (int)cudaErrorInvalidValue;
  SsdParams p{};
  p.x = x; p.b = b; p.c = c; p.dt = dt; p.cum = cum; p.y = y;
  p.state = state;
  p.NC = NC; p.NH = NH; p.G = G; p.Q = Q; p.ds = ds; p.hpc = hpc;
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
