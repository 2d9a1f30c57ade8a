// Ragged decode over a dense per-slot cache for Hopper (sm_90a): the
// single-pass decode and the split-K decode, with a plain C interface
// loaded via ctypes.  Both launch the chunked decode kernel of
// chunked_decode.cuh (shared with the paged decode) in its dense mode,
// once per call; this file instantiates that mode.
//
// Replaces
//   decode_attention_tpu        (src/repro/kernels/decode_attention.py:131,
//                                _decode_kernel)
//   decode_attention_splitk_tpu (src/repro/kernels/decode_attention.py:236,
//                                _splitk_partial_kernel +
//                                _splitk_combine_kernel)
//
// Built once per head dim D (-DHEAD_DIM=64, 80 or 128, the library
// decode_attention_d<D>); the entry points refuse any other D.
//
// Layout: q (B, T, H, D), caches (B, S, KV, D) -- the MODEL layout, read in
// place through strides, so no cache is transposed or copied (a layer's
// slice of the engine's stacked (L, B, S, KV, D) cache is passed as it
// is).  The contract is in attention_common.cuh.
//
// Bound on an H100: device-memory bytes of the live prefix, 2 * KV * D *
// bytes per live key, at ~1 flop per byte.  Design: chunked_decode.cuh --
// 256-key chunks over the card, one CTA per (KV head, slot, chunk) with a
// cp.async ring, merged in chunk order by the slot's last CTA in the same
// launch.  Split-K's splits are the chunks clipped at S / num_splits, so
// it needs no combine launch, and with (S / num_splits) % 256 == 0 it is
// the single pass, bitwise.

#include "chunked_decode.cuh"

namespace {

DecodeParams dense_params(const void* q, const void* k, const void* v,
                          void* out, const int* pos, const int* active, int B,
                          int T, int H, int KV, int S, int window,
                          int num_splits, int chunk, int chunks_per_split,
                          int row_tile, int n_tiles, int route,
                          const long long* qs,
                          const long long* ks, const long long* vs,
                          float* o_part, float* ml_part, int* tickets) {
  DecodeParams p{};
  p.q = q; p.k = k; p.v = v; p.out = out; p.pos = pos; p.active = active;
  p.B = B; p.T = T; p.H = H; p.KV = KV; p.S = S; p.window = window;
  p.page_size = 1;
  p.chunk = chunk; p.split = S / num_splits;
  p.chunks_per_split = chunks_per_split;
  p.n_chunks = num_splits * chunks_per_split;
  p.row_tile = row_tile; p.n_tiles = n_tiles; p.route = route;
  p.q_sb = qs[0]; p.q_st = qs[1]; p.q_sh = qs[2];
  p.k_s0 = ks[0]; p.k_ss = ks[1]; p.k_sh = ks[2];
  p.v_s0 = vs[0]; p.v_ss = vs[1]; p.v_sh = vs[2];
  p.o_part = o_part; p.ml_part = ml_part; p.tickets = tickets;
  return p;
}

}  // namespace

// Strides are in elements: q_strides = (batch, token, head), cache strides
// = (batch, seq, kv head); the last dimension must be contiguous.  `out`
// is a contiguous (B, T, H, D) tensor of q's dtype.  `chunk` keys per
// chunk and `chunks` chunks (the wrapper's decode_chunks(S, 1, 1)), and
// the G * T rows of a KV head in `n_tiles` tiles of `row_tile` rows on
// `route` (the wrapper's row_tiles and decode_route: 0 the CUDA cores, 1
// the tensor cores, 2 warp mma), give the grid (KV * n_tiles, B, chunks);
// o_part
// (B, KV, chunks, G * T, D) and ml_part (B, KV, chunks, G * T, 2) are f32
// scratch and tickets (B * KV * n_tiles) int32 zeros, all allocated by the
// caller.  dtype codes: 0 = float32,
// 1 = bfloat16.  Returns the launch's cudaError_t (0 = success).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, void* out, const int* pos,
    const int* active, int B, int T, int H, int KV, int S, int D, int window,
    int chunk, int chunks, int row_tile, int n_tiles, int route,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, float* o_part, float* ml_part, int* tickets,
    int q_dtype, int kv_dtype, void* stream) {
  if (KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  const DecodeParams p = dense_params(
      q, k, v, out, pos, active, B, T, H, KV, S, window, 1, chunk, chunks,
      row_tile, n_tiles, route, q_strides, k_strides, v_strides, o_part,
      ml_part, tickets);
  return (int)launch_chunked_decode<false, HEAD_DIM>(
      p, D, q_dtype, kv_dtype, (cudaStream_t)stream);
}

// Split-K (T = 1, S % num_splits == 0): split i owns keys [i * S / ns,
// (i + 1) * S / ns), cut into `chunks_per_split` chunk slots of `chunk`
// keys (decode_chunks(S, 1, num_splits)), all merged in the same launch.
// The rest as for decode_attention_fwd.
extern "C" int decode_attention_splitk_fwd(
    const void* q, const void* k, const void* v, void* out, const int* pos,
    const int* active, int B, int H, int KV, int S, int D, int window,
    int num_splits, int chunk, int chunks_per_split, int row_tile,
    int n_tiles, int route, const long long* q_strides,
    const long long* k_strides,
    const long long* v_strides, float* o_part, float* ml_part, int* tickets,
    int q_dtype, int kv_dtype, void* stream) {
  if (num_splits < 1 || S % num_splits || KV < 1 || H % KV)
    return (int)cudaErrorInvalidValue;
  const DecodeParams p = dense_params(
      q, k, v, out, pos, active, B, 1, H, KV, S, window, num_splits, chunk,
      chunks_per_split, row_tile, n_tiles, route, q_strides, k_strides,
      v_strides, o_part, ml_part, tickets);
  return (int)launch_chunked_decode<false, HEAD_DIM>(
      p, D, q_dtype, kv_dtype, (cudaStream_t)stream);
}
