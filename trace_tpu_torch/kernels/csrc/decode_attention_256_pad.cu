// One decode step of GQA attention over one layer's bf16 KV-cache stripe, for
// Hopper (sm_90a): the instances at the head dims between 128 and 256, each a
// multiple of 4, run at width 256 with the rows zero-padded in shared memory
// (bf16 alone). A library of its own beside decode_attention_256.cu, so that
// the two compile in parallel. The kernel and its design: decode_bf16.cuh.

#include "decode_bf16.cuh"

// q, o [B, nkv * G, hd]; k, v [B, nkv, S, hd]; bias [B, S] fp32; all
// contiguous, in bf16; hd a multiple of 4 from 132 to 252 (k and v aligned
// to the largest of 16 and 8 bytes that divides a row)
extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v,
                                const float* bias, void* o, int B, int nkv, int G, int S,
                                int hd, float scale, void* stream) {
  return dispatch<bf16, true, true>(q, k, v, bias, o, B, nkv, G, S, hd, scale, stream);
}
