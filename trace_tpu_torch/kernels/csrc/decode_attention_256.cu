// One decode step of GQA attention over one layer's bf16 KV-cache stripe, for
// Hopper (sm_90a): the instances at head dim 256 (bf16 alone). A library of
// its own beside decode_attention.cu, so that the two compile in parallel.
// The kernel and its design: decode_bf16.cuh.

#include "decode_bf16.cuh"

// q, o [B, nkv * G, 256]; k, v [B, nkv, S, 256]; bias [B, S] fp32; all
// contiguous, in bf16
extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v,
                                const float* bias, void* o, int B, int nkv, int G, int S,
                                int hd, float scale, void* stream) {
  return dispatch<bf16, false, true>(q, k, v, bias, o, B, nkv, G, S, hd, scale, stream);
}
