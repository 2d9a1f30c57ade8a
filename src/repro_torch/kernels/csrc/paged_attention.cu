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
// Built once per head dim D (-DHEAD_DIM=64, 80 or 128, the library
// paged_attention_d<D>); the entry points refuse any other D.
//
// Layout: the pools stay in the MODEL layout (P, page_size, KV, D) and are
// read in place through strides (the TPU wrapper's swap to
// (P, KV, page_size, D) would copy the whole pool per layer per tick).
// Logical key kpos of a slot lives in physical page
// page_idx[b, kpos / page_size] at token offset kpos % page_size; masks
// use the logical position only.  Unmapped table entries are the null
// page 0: a kernel loads K/V only for keys at or before the slot's last
// query position (pos + T - 1, or the chunk's last row) and inside the
// window, so it never computes on an unmapped entry (the decode kernel
// reads its chunk's table entries whole, before it knows the position).
//
// Quantized pools (int8 or fp8 e4m3, the TPU kernels' scale branch:
// _accumulate_page(quant=True) with _page_scale_spec) come with f32 scale
// pools (P, page_size, KV, 1) read through strides and the same page
// table; the kernels dequantize each row as it arrives.
//
// Decode and split-K decode: the chunked decode kernel (chunked_decode.cuh,
// shared with the dense decode of decode_attention.cu) in its paged mode,
// which cuts each slot's live prefix into chunks of 256 keys, one CTA per
// (KV head, slot, chunk), each with a cp.async ring of K/V tiles, merged in
// chunk order in the same launch.  Bound on an H100: device-memory bytes
// of the live prefix (2 * KV * (D * bytes + scale bytes) per live key).
//
// Prefill: one slot's chunk of C query rows at absolute q_offset, causal
// against its own page chain (the chunk's K/V already written).
//   Bound on an H100: operations.  A chunk at q_offset does
//   4 * C * H * D * (q_offset + C / 2) flops (QK and PV) against
//   2 * KV * D * bytes * (q_offset + C) bytes of K/V: C * G / 8 to
//   C * G / 4 flops per f32 byte (64-128 at C = 256, G = 2), above the
//   card's balance even for f32-accurate TF32 work (165 TFLOP/s over
//   3.35 TB/s = 49).
//   Design: the tensor-core many-row kernel of many_row_attention.cuh
//   (shared with the dense flash attention) with the page-table row lookup
//   in its cp.async tile loader.  One 256-row chunk at G = 2 is only 32
//   CTAs (8 KV heads x 4 blocks of 128 flattened rows) on 132 SMs, so the
//   wrapper splits each CTA's key range (4 splits at offset 3840: 128
//   CTAs, one per SM) and a combine kernel merges the splits' (acc, m, l).

#include "many_row_attention.cuh"
#include "chunked_decode.cuh"

// Paged decode, single pass (num_splits = 1, T >= 1) or split-K
// (num_splits > 1, T = 1, max_pages % num_splits == 0).  Strides are in
// elements: q_strides = (batch, token, head), pool strides = (page, token,
// kv head); the last dimension must be contiguous.  page_idx is (B,
// max_pages) int32 with row stride pt_stride.  k_scale / v_scale are the
// f32 scale pools (P, page_size, KV, 1) of an int8 (kv_dtype 2) or fp8 (3)
// pool, with strides (page, token, kv head) like the pools', and null for
// an f32 (0) or bf16 (1) pool.  `chunk` keys per chunk (a
// multiple of page_size) and `chunks_per_split` chunk slots per split give
// the grid's num_splits * chunks_per_split chunks, and the G * T rows of
// a KV head go in `n_tiles` row tiles of `row_tile` rows on `route` (the
// wrapper's row_tiles and decode_route, coded as decode_attention.cu's).
// `out` is a contiguous (B, T, H, D) tensor of q's dtype; o_part (B, KV,
// chunks, G * T, D) and ml_part (B, KV, chunks, G * T, 2) are f32 scratch
// and tickets (B * KV * n_tiles) int32 zeros, all allocated by the caller.
// Returns the launch's cudaError_t (0 = success).
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k, const void* v, void* out, const int* pos,
    const int* active, const int* page_idx, long long pt_stride, int B,
    int T, int H, int KV, int max_pages, int page_size, int D, int window,
    int num_splits, int chunk, int chunks_per_split, int row_tile,
    int n_tiles, int route, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const float* k_scale, const float* v_scale,
    const long long* ks_strides, const long long* vs_strides, float* o_part,
    float* ml_part, int* tickets, int q_dtype, int kv_dtype, void* stream) {
  if (num_splits < 1 || max_pages % num_splits || KV < 1 || H % KV)
    return (int)cudaErrorInvalidValue;
  DecodeParams p{};
  p.q = q; p.k = k; p.v = v; p.out = out; p.pos = pos; p.active = active;
  p.page_idx = page_idx; p.pt_sb = pt_stride;
  p.B = B; p.T = T; p.H = H; p.KV = KV; p.S = max_pages * page_size;
  p.page_size = page_size; p.window = window;
  p.chunk = chunk; p.split = p.S / num_splits;
  p.chunks_per_split = chunks_per_split;
  p.n_chunks = num_splits * chunks_per_split;
  p.row_tile = row_tile; p.n_tiles = n_tiles; p.route = route;
  p.q_sb = q_strides[0]; p.q_st = q_strides[1]; p.q_sh = q_strides[2];
  p.k_s0 = k_strides[0]; p.k_ss = k_strides[1]; p.k_sh = k_strides[2];
  p.v_s0 = v_strides[0]; p.v_ss = v_strides[1]; p.v_sh = v_strides[2];
  p.ks = k_scale; p.vs = v_scale;
  p.ks_s0 = ks_strides[0]; p.ks_ss = ks_strides[1]; p.ks_sh = ks_strides[2];
  p.vs_s0 = vs_strides[0]; p.vs_ss = vs_strides[1]; p.vs_sh = vs_strides[2];
  p.o_part = o_part; p.ml_part = ml_part; p.tickets = tickets;
  return (int)launch_chunked_decode<true, HEAD_DIM>(
      p, D, q_dtype, kv_dtype, (cudaStream_t)stream);
}

// Fused paged prefill of one slot's chunk: q (1, C, H, D) with strides
// (token, head) = q_strides[0..1]; pools as above; page_row the slot's
// contiguous int32 page-table row; scale pools as for the decode.  `out`
// is a contiguous (1, C, H, D) tensor of q's dtype; H / KV is at most
// 64.  num_splits and the f32
// scratch o_part (ns, 1, C, H, D), m_part and l_part (ns, 1, C, H) as for
// flash_attention_fwd.
extern "C" int paged_prefill_attention_fwd(
    const void* q, const void* k, const void* v, void* out,
    const int* page_row, int C, int H, int KV, int page_size, int D,
    int q_offset, int window, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const float* k_scale, const float* v_scale, const long long* ks_strides,
    const long long* vs_strides, int num_splits, float* o_part,
    float* m_part, float* l_part, int q_dtype, int kv_dtype, void* stream) {
  PrefillParams p{};
  p.q = q; p.k = k; p.v = v; p.out = out; p.page_row = page_row;
  p.Sq = C; p.Sk = q_offset + C; p.H = H; p.KV = KV; p.q_offset = q_offset;
  p.window = window; p.causal = 1; p.page_size = page_size;
  p.q_st = q_strides[0]; p.q_sh = q_strides[1];
  p.k_sb = k_strides[0]; p.k_ss = k_strides[1]; p.k_sh = k_strides[2];
  p.v_sb = v_strides[0]; p.v_ss = v_strides[1]; p.v_sh = v_strides[2];
  p.ks = k_scale; p.vs = v_scale;
  p.ks_sb = ks_strides[0]; p.ks_ss = ks_strides[1]; p.ks_sh = ks_strides[2];
  p.vs_sb = vs_strides[0]; p.vs_ss = vs_strides[1]; p.vs_sh = vs_strides[2];
  p.num_splits = num_splits;
  p.o_part = o_part; p.m_part = m_part; p.l_part = l_part;
  return (int)launch_many_row<true, HEAD_DIM>(
      p, 1, D, q_dtype, kv_dtype, (cudaStream_t)stream);
}
