// Ragged flash-decode over a dense per-slot cache for Hopper (sm_90a): a
// single-pass kernel and a two-phase split-K kernel, with a plain C
// interface loaded via ctypes.  The kernels themselves live in
// attention_common.cuh; this file instantiates them.
//
// Replaces
//   decode_attention_tpu        (src/repro/kernels/decode_attention.py,
//                                _decode_kernel)
//   decode_attention_splitk_tpu (src/repro/kernels/decode_attention.py,
//                                _splitk_partial_kernel +
//                                _splitk_combine_kernel)
//
// Layout: q (B, T, H, D), caches (B, S, KV, D) -- the MODEL layout, read in
// place through strides, so no cache is transposed or copied.  The
// contract is in attention_common.cuh.
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

#include "attention_common.cuh"

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
  return (int)launch_decode<false>(p, D, q_dtype, kv_dtype,
                                   (cudaStream_t)stream);
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
  return (int)launch_decode<true>(p, D, q_dtype, kv_dtype,
                                  (cudaStream_t)stream);
}
