// One decode step of GQA attention over one layer's int8 KV-cache stripe, for
// Hopper (sm_90a): the instances at head dims 64 and 128 (hd 64 or 128;
// decode_attention_int8_pad.cu takes the others). The kernel and its design:
// decode_int8.cuh.

#include "decode_int8.cuh"

#define DECODE_INT8_PAD false
#define DECODE_INT8_WIDE false
DECODE_ATTN_INT8_ENTRIES
