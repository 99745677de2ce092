// One decode step of GQA attention over one layer's int8 KV-cache stripe, for
// Hopper (sm_90a): the instances at the head dims between 128 and 256, each a
// multiple of 4, run at width 256 with the rows zero-padded in shared memory
// (kq and vq aligned to the largest of 16, 8 and 4 bytes that divides a row),
// bf16 q alone (both modes). A library of its own beside
// decode_attention_int8_256.cu, so that the two compile in parallel. The
// kernel and its design: decode_int8.cuh.

#include "decode_int8.cuh"

#define DECODE_INT8_PAD true
#define DECODE_INT8_WIDE true
DECODE_ATTN_INT8_BF16_ENTRIES
