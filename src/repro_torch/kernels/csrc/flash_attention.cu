// Full-sequence GQA flash attention for Hopper (sm_90a), forward only, with
// a plain C interface loaded via ctypes.  The kernel itself is the many-row
// kernel of many_row_attention.cuh, instantiated here for the dense layout;
// the paged chunked prefill (paged_attention.cu) is the same kernel with a
// page-table row lookup.
//
// Replaces
//   flash_attention_tpu (src/repro/kernels/flash_attention.py:83,
//                        _flash_kernel)
//
// Built once per head dim D (-DHEAD_DIM=64, 80 or 128, the library
// flash_attention_d<D>); the entry point refuses any other D.
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
// What bounds it on an H100, and the design: many_row_attention.cuh (the
// tensor-core many-row kernel, 3xTF32 for f32 operands; its bound is the
// operations at 165 TFLOP/s of f32-accurate TF32 work, 0.833 ms for
// B = 2, S = 4096, causal).

#include "many_row_attention.cuh"

// Strides are in elements: q_strides = (batch, token, head), k/v strides =
// (batch, seq, kv head); the last dimension must be contiguous.  `out` is a
// contiguous (B, Sq, H, D) tensor of q's dtype.  H / KV is at most 64.
// num_splits > 1 splits each CTA's key range; o_part (ns, B, Sq, H, D),
// m_part and l_part (ns, B, Sq, H) are then f32 scratch allocated by the
// caller (unused, may be null, when num_splits == 1).  Returns the
// launch's cudaError_t (0 = success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int H, int KV, int D, int causal, int window,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, int num_splits, float* o_part,
    float* m_part, float* l_part, int q_dtype, int kv_dtype, void* stream) {
  PrefillParams p{};
  p.q = q; p.k = k; p.v = v; p.out = out; p.page_row = nullptr;
  p.Sq = Sq; p.Sk = Sk; p.H = H; p.KV = KV; p.q_offset = 0;
  p.window = window; p.causal = causal; p.page_size = 1;
  p.q_sb = q_strides[0]; p.q_st = q_strides[1]; p.q_sh = q_strides[2];
  p.k_sb = k_strides[0]; p.k_ss = k_strides[1]; p.k_sh = k_strides[2];
  p.v_sb = v_strides[0]; p.v_ss = v_strides[1]; p.v_sh = v_strides[2];
  p.num_splits = num_splits;
  p.o_part = o_part; p.m_part = m_part; p.l_part = l_part;
  return (int)launch_many_row<false, HEAD_DIM>(
      p, B, D, q_dtype, kv_dtype, (cudaStream_t)stream);
}
