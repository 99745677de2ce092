// One decode step of GQA attention over one layer's int8 KV-cache stripe, for
// Hopper (sm_90a): the instances at head dim 256, bf16 q alone (both modes).
// A library of its own beside decode_attention_int8.cu, so that the two
// compile in parallel. The kernel and its design: decode_int8.cuh.

#include "decode_int8.cuh"

#define DECODE_INT8_PAD false
#define DECODE_INT8_WIDE true
DECODE_ATTN_INT8_BF16_ENTRIES
