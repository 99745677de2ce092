// One decode step of GQA attention over one layer's bf16 (or fp32) KV-cache
// stripe, for Hopper (sm_90a): the instances at the head dims other than 64
// and 128, each a multiple of 4 up to 128, run at width 64 or 128 with the
// rows zero-padded in shared memory. A library of its own beside
// decode_attention.cu, so that the two compile in parallel.
// The kernel and its design: decode_bf16.cuh.

#include "decode_bf16.cuh"

// q, o [B, nkv * G, hd]; k, v [B, nkv, S, hd]; bias [B, S] fp32; all
// contiguous, in bf16, or all in fp32 for decode_attn_f32; hd a multiple of
// 4 up to 128, not 64 or 128 (k and v aligned to the largest of 16, 8 and 4
// bytes that divides a row)
extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v,
                                const float* bias, void* o, int B, int nkv, int G, int S,
                                int hd, float scale, void* stream) {
  return dispatch<bf16, true>(q, k, v, bias, o, B, nkv, G, S, hd, scale, stream);
}

extern "C" int decode_attn_f32(const void* q, const void* k, const void* v, const float* bias,
                               void* o, int B, int nkv, int G, int S, int hd, float scale,
                               void* stream) {
  return dispatch<float, true>(q, k, v, bias, o, B, nkv, G, S, hd, scale, stream);
}
