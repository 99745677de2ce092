// Pieces of the attention backward kernels (attention_bwd.cu): 64-row bf16
// tiles in shared memory, cp.async copies, and the mma.sync m16n8k16 products
// a warp builds its 16 x 64 score tile and its 16 x hd accumulators from.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NWARPS = 4;       // each warp owns 16 rows of its block's tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

// smem row pitch in bf16: rows stay 16-byte aligned, and the 8-element pad
// puts the 8 rows a fragment load touches on distinct banks
template <int HD>
__host__ __device__ constexpr int pitch() { return HD + 8; }

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// the same copy started asynchronously (cp.async, 16 bytes per thread and
// step, zero-fill past ``valid``), left in the thread's open group
template <int HD>
__device__ __forceinline__ void copy_tile_async(bf16* dst, const bf16* src,
                                                long long stride, int valid) {
  constexpr int VPR = HD / 8;
  for (int i = threadIdx.x; i < BQ * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const unsigned saddr = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + r * pitch<HD>() + c));
    const bf16* gaddr = src + (r < valid ? r * stride + c : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(saddr), "l"(gaddr), "r"(r < valid ? 16 : 0));
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one 16x8x16 tile. Fragment layout (PTX ISA, mma.m16n8k16):
// with g = lane / 4 and t = lane % 4, a holds A[g][2t..], A[g+8][2t..],
// A[g][2t+8..], A[g+8][2t+8..]; b holds B[2t..][g], B[2t+8..][g]; d holds
// D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc [16 x 64] += A [16 x HD] * Bm [64 x HD]^T, both row-major tiles in
// shared memory (A already offset to the warp's first row), contracted over
// HD: the shape of Q K^T
template <int HD>
__device__ __forceinline__ void mma_nt(float (*acc)[4], const bf16* A,
                                       const bf16* Bm, int g, int t) {
  constexpr int LD = pitch<HD>();
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    const bf16* r0 = A + g * LD + kc * 16 + 2 * t;
    const bf16* r1 = r0 + 8 * LD;
    uint32_t a[4] = {ld32(r0), ld32(r1), ld32(r0 + 8), ld32(r1 + 8)};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const bf16* br = Bm + (n * 8 + g) * LD + kc * 16 + 2 * t;
      mma(acc[n], a, ld32(br), ld32(br + 8));
    }
  }
}

// acc [16 x HD] += P [16 x 64] * Bm [64 x HD]: P is a warp's score tile in
// its accumulator registers, rounded to bf16 here; Bm a row-major tile in
// shared memory, contracted over its 64 rows: the shape of P V
template <int HD>
__device__ __forceinline__ void mma_pn(float (*acc)[4], const float (*s)[4],
                                       const bf16* Bm, int g, int t) {
  constexpr int LD = pitch<HD>();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const bf16* vr = Bm + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const bf16* vc = vr + n * 8;
      mma(acc[n], a, pack(vc[0], vc[LD]), pack(vc[8 * LD], vc[9 * LD]));
    }
  }
}

}  // namespace
