// Pieces the attention kernels share (attention.cu's forward, attention_bwd.cu's
// backward; attention_bwd_f32.cu takes ex2 and the masks' constants): tensor
// maps of [B, H, T, hd] operands and the TMA loads of their
// rows into 64-column boxes in the 128-byte swizzle, the wgmma products of
// one warpgroup (m64n64 and m64n128, A from shared memory or from registers;
// m64n256 with A from registers, the P V of the forward at hd 256),
// and the packing of an accumulator into the A fragments of the next product.

#pragma once

#include "hopper_common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROW_BYTES = 128;  // a 64-column box row in shared memory
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void consumer_sync(int wg) {  // consumer warpgroup wg alone
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// rows x HD of an operand (tokens token.., head, batch row b) into its
// 64-column boxes at dst, `rows` rows a box
template <int HD>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, int fold,
                                          uint32_t bar, int token, int head, int b, int rows) {
#pragma unroll
  for (int cb = 0; cb < HD / 64; ++cb) {
    const uint32_t box = dst + cb * rows * ROW_BYTES;
    if (fold)
      tma_load_3d(box, map, bar, head * HD + cb * 64, token, b);
    else
      tma_load_4d(box, map, bar, cb * 64, token, head, b);
  }
}

// d [64 x 64] (+)= A [64 x 16] B [16 x 64], A and B K-major in shared memory;
// accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d [64 x 128] (+)= A [64 x 16] B [16 x 128], A and B K-major in shared memory;
// accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d [64 x 64] += A [64 x 16] B [16 x 64], A from registers (the fragment of
// mma.m16n8k16 per warp), B MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d [64 x 128] += A [64 x 16] B [16 x 128], A from registers (the fragment of
// mma.m16n8k16 per warp), B MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d [64 x 256] += A [64 x 16] B [16 x 256], A from registers (the fragment of
// mma.m16n8k16 per warp), B MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N> struct Wgmma;
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    wgmma_ss_n64(d, a, b, acc);
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    wgmma_rs_n64(d, a, b);
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    wgmma_ss_n128(d, a, b, acc);
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    wgmma_rs_n128(d, a, b);
  }
};
// at N = 256 only the P V product (the forward at hd 256: S runs at N = 64 keys)
template <> struct Wgmma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    wgmma_rs_n256(d, a, b);
  }
};

// D [64 x N] = A [64 x HD] B^T, B [N x HD]: a the warpgroup's rows of a tile
// whose boxes hold a_rows rows, b a tile of N rows; both K-major (the shape
// of Q K^T)
template <int HD, int N>
__device__ __forceinline__ void nt_product(float (&d)[N / 2], uint32_t a, int a_rows, uint32_t b) {
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc)
    Wgmma<N>::ss(d, sw128_desc(a + (kc / 4) * a_rows * ROW_BYTES + (kc % 4) * 32),
                 sw128_desc(b + (kc / 4) * N * ROW_BYTES + (kc % 4) * 32), kc > 0);
}

// D [64 x HD] += A [64 x K] B, B [K x HD]: A the fragments of the K / 16
// slices in registers, b a tile of K rows read MN-major (its HD / 64 boxes
// K rows apart; the shape of P V)
template <int HD, int K>
__device__ __forceinline__ void pn_product(float (&d)[HD / 2], const uint32_t (&a)[K / 16][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    Wgmma<HD>::rs(d, a[kk], sw128_desc_mn(b + kk * 16 * ROW_BYTES, K * ROW_BYTES));
}

// An accumulator [64 x K] as the A fragments of its K / 16 column slices in
// bf16: slice kk is columns 16 kk .. 16 kk + 15, registers s[8 kk .. 8 kk + 7]
// (the accumulator layout of wgmma is the A-fragment layout)
template <int K>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[K / 16][4], const float (&s)[K / 2]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// An operand [batch, heads, tokens, hd] at element strides (sb, sh, st) as a
// tensor map with boxes of 64 columns x `rows` tokens in the 128-byte
// swizzle; tokens past `tokens` read as zero. Heads that are neighbouring
// column blocks of a row (sh == hd, the ViT's [B, P, D] slices) fold into
// the column: a 3-D map (h*hd + column, token, batch); otherwise 4-D
// (column, token, head, batch).
int make_map(CUtensorMap* map, int* fold, const void* ptr, int hd, int heads, int tokens,
             int batch, long long sb, long long sh, long long st, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r;
  *fold = sh == hd ? 1 : 0;
  if (*fold) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(heads) * hd,
                                static_cast<cuuint64_t>(tokens), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(st) * 2,
                                   static_cast<cuuint64_t>(sb) * 2};
    const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
    r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
               box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(tokens),
                                static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2,
                                   static_cast<cuuint64_t>(sh) * 2,
                                   static_cast<cuuint64_t>(sb) * 2};
    const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
    r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
               box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
