// Full-sequence GQA flash attention for Hopper (sm_90a), forward only, with
// a plain C interface loaded via ctypes.  The kernel itself is the many-row
// kernel of attention_common.cuh (prefill_kernel), instantiated here for
// the dense layout; the paged chunked prefill (paged_attention.cu) is the
// same kernel with a page-table row lookup.
//
// Replaces
//   flash_attention_tpu (src/repro/kernels/flash_attention.py,
//                        _flash_kernel)
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, KV, D) -- the MODEL layout, read in
// place through strides, so nothing is transposed or copied (the TPU
// wrapper swaps to (B, H, S, D)).  Query row i attends key j when j <= i
// (causal) and i - j < window (window > 0); causal = 0 drops the first
// test.  Query head h reads KV head h / G.  q and k are upcast to f32, the
// scale is applied after the dot, the online softmax (m, l, acc) is f32, p
// is rounded to v's dtype before the PV product (as the TPU kernel's
// p.astype(v.dtype)), masked keys add exactly 0, and the output is
// acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100: operations.  A causal pass does
// 4 * D flops per attended (query row, key) pair -- 2 * B * H * D * S^2
// flops at S = 4096 (137 GFLOP for B = 2, H = 16, D = 128) -- against
// 2 * B * S * (H + KV) * D * bytes of q, K, V and the output (50 MB in
// f32): ~2,700 flops per byte, far above the card's non-tensor f32
// balance (67 TFLOP/s over 3.35 TB/s = 20).  So the time is the FMA rate
// of the score and PV tiles.
//
// What the design does about it:
//   * one CTA per (batch, KV head, 64 / G query positions) covers all G
//     query heads of that KV head: each K/V tile is loaded once per 64
//     query rows (the TPU grid (b, h, q block, k block) reads K/V once per
//     query head);
//   * K/V tiles of 32 keys in shared memory, the next tile's 16-byte loads
//     issued into registers before this tile's math;
//   * the online softmax in registers, across the warp with shuffles;
//   * the key loop starts at the window's first tile and, causal, ends at
//     the tile's last row: fully masked tiles are never loaded (the TPU's
//     pl.when skip of masked blocks becomes loop bounds).
// Not yet done (later work): mma.sync / wgmma for the 64 x 32 score and PV
// tiles (the f32 CUDA-core FMA rate is the ceiling of this version), TMA
// rings, a bf16/TF32 tensor-core variant.

#include "attention_common.cuh"

// Strides are in elements: q_strides = (batch, token, head), k/v strides =
// (batch, seq, kv head); the last dimension must be contiguous.  `out` is a
// contiguous (B, Sq, H, D) tensor of q's dtype.  (H / KV) must divide 64.
// Returns the launch's cudaError_t (0 = success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int H, int KV, int D, int causal, int window,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, int q_dtype, int kv_dtype, void* stream) {
  PrefillParams p{};
  p.q = q; p.k = k; p.v = v; p.out = out; p.page_row = nullptr;
  p.Sq = Sq; p.Sk = Sk; p.H = H; p.KV = KV; p.q_offset = 0;
  p.window = window; p.causal = causal; p.page_size = 1;
  p.q_sb = q_strides[0]; p.q_st = q_strides[1]; p.q_sh = q_strides[2];
  p.k_sb = k_strides[0]; p.k_ss = k_strides[1]; p.k_sh = k_strides[2];
  p.v_sb = v_strides[0]; p.v_ss = v_strides[1]; p.v_sh = v_strides[2];
  return (int)launch_prefill<false>(p, B, D, q_dtype, kv_dtype,
                                    (cudaStream_t)stream);
}
