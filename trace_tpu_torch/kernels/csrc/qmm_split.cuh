// The weight products of a decode step for Hopper (sm_90a), one launch per
// product: y[M, N] = x[M, K] @ W[K, N] for a few rows of bf16 or fp32 x and
// a quantized W, an fp32 sum, bf16 or fp32 y. Three weight forms share this
// skeleton (quant_matmul.cu the first, quant_matmul_p4.cu the other two):
//   I8:  int8 q [K, N], a per-column scale s [N] applied once on the sum;
//   P4:  nibble-packed qp [K/2, N] (byte k holds rows k and k + K/2), a
//        per-column scale on the sum;
//   P4G: the same bytes, W[k, n] = nibble * s[k / (K / G), n] in x's type:
//        rounded to bf16 before the product (that rounding is part of the
//        function; bf16 x takes groups of 128 rows), exact in fp32 (fp32 x:
//        any even G dividing K).
//
// Bound by bytes: the weight is streamed once (K N or K N / 2 bytes) for at
// most 8 rows of x (the int8 form: 32), a few operations per byte. What the
// design does:
//   * One launch, no workspace. A cluster of C <= 8 blocks (the portable
//     size) owns a strip of 128 columns of y; rank r takes a contiguous
//     share of the weight rows. The ranks' partial sums meet in distributed
//     shared memory: every rank writes its sums for rank o's slice of the
//     strip into o's shared memory before a cluster barrier, and o adds them
//     in rank order, scales, casts and writes y. No atomics on the sums: a
//     repeat gives the same bits.
//   * Long blocks, one wave. The host (kernels/quant_matmul.py split_plan)
//     takes the largest C for which all clusters of the launch are resident
//     at once (cudaOccupancyMaxActiveClusters; two blocks an SM fit), so
//     the four layer shapes of a 7B decode step and the lm_head launch
//     192-250 blocks on 132 SMs, each streaming 100-512 KB.
//   * Bytes in flight. Each block streams its share through a ring of
//     NSTAGE = 5 stages (the wide tile: 3) of 128 weight rows x 128 columns
//     (16 KB), each with its slice of x (and, for P4G, the rows of scales it
//     touches), all by TMA onto the stage's mbarrier: up to 80 KB a block,
//     160 KB an SM (wide: 72 and 144, a third of it x). No
//     block barrier paces the ring: a warp that is done with a stage counts
//     itself out on the stage's counter, and the last of the 8 refills the
//     slot with the stage NSTAGE further on, while the others go on.
//   * Few operations per byte. The products run on the tensor cores:
//     mma.sync m16n8k16 with the weight as A (16 columns of the strip x 16
//     k) and x as B (16 k x 8 rows). A block takes a tile of MT rows of x:
//     8, or for the int8 form at M > 8 the wide tile of 32, where each A
//     fragment, built once from the bytes, meets the four 8-row B fragments
//     in turn; so up to 32 rows read the weight once, and a larger M takes
//     tiles of 32 rows, each re-reading it. A k pair of the A
//     fragment is built from the bytes in bf16x2 integer arithmetic, each
//     step exact: int8 rows k, k+1 of a column as 128 + (b & 127) minus
//     128 or 256 by b's sign bit; packed, the byte's low and high nibbles
//     (rows k and k + K/2, so that pair of A meets x[k] and x[k + K/2] in B)
//     as 136 + nibble minus 136, and for P4G times the scale pair, rounded
//     once as the plain version's fp32 product rounded to bf16. About 2
//     (int8), 3.4 (P4) and 4.4 (P4G) lane operations a weight byte against
//     the 4.5-12 of FMAs on fp32 values. The products are exact; to keep
//     the tensor core's truncating accumulation off long chains, each
//     stage's at most 4 mma per warp and tile start from zero and are added
//     into the fp32 sums with round-to-nearest adds.
// Layout, MT = 8: 8 warps = 2 column halves (64 columns: lane group g reads
// 8 neighbouring bytes, A rows g and g + 8 of m-tile j are columns 8 g + 2 j
// and + 1) x 4 bands (the stage's k-steps in turn). The wide tile, MT = 32:
// 4 column quarters (32 columns: lane group g reads 4 bytes, m-tile j = 0, 1
// its columns 4 g + 2 j and + 1) x 2 bands, so a warp holds 2 x 4 tiles of
// 4 sums and as many of a stage's, 64 registers (32 at MT = 8; the halves'
// layout would need 128), and a band's 4 k-steps keep the chains at 4 mma;
// the four B fragments of a k-step come by two ldmatrix.x4. A lane reads
// rows 2 tq and 2 tq + 1 of a k-step (int8: and + 8, + 9;
// packed: its k pairs tq and tq + 4); weight rows and x rows sit in the
// 128-byte swizzle, so both reads spread over all 32 banks. Rows of x past
// M read zeros and are not written. A k-step past the share is skipped (TMA
// fetches whole boxes, so the rows there are another rank's); past K the
// copies read zeros. Shapes a tensor map cannot take (N not a multiple of
// 16 or an unaligned weight; K or K / 2 not a multiple of 8 or an unaligned
// x; N not a multiple of 8 for the scales) are loaded by the refilling warp
// into the same layout. ptxas (CUDA 12.8, sm_90a): 70 / 105 / 67 / 90
// registers (I8 / I8 wide / P4 / P4G), no spills.
// fp32 x (the fp32 instances, X = float; a model served in fp32): the same
// launch, cluster, strip, ring and tile of 8 rows of x, x fp32 in the ring
// (boxes of 32 k). Every weight is exact in TF32, which keeps 11
// significant bits (an int8 needs 7, a nibble 3, a nibble times a bf16
// scale 11), so only x is split: x_hi = rna_tf32(x), x_lo = rna_tf32(x -
// x_hi), within 2^-22 of x, in registers once a B fragment; each k-step of
// 8 k is two mma.sync m16n8k8 TF32 products on one A fragment, W x_hi + W
// x_lo. A is built from the bytes without a conversion instruction: the
// byte or nibble, its sign bit flipped, or'ed into the mantissa of a power
// of two where its lowest bit weighs 1, less that power and the bias (one
// lop3 and one fadd a weight, exact), for P4G times the group's scale
// (exact). Packed, a byte's low nibble is A's k index tq and its high
// nibble tq + 4, so B carries x[k] and x[k + K/2] and one byte feeds both
// halves. Up to 4 rows of x (FOLD) B carries x_hi of rows 0-3 in its
// columns 0-3 and x_lo in 4-7, so one mma takes both products and a k-step
// costs the bf16 form's mma count; their sums meet in the epilogue. The
// int8 form keeps 5 stages (107,740 bytes a block); the packed
// forms take 4 (fp32 x doubles a stage's x: 5 would not fit twice an SM).
// P4G's scales: groups of at least a stage's 128 rows ride in the ring as
// for bf16 x (a stage touches two a half); smaller groups each lane reads
// from device memory when its row enters a new group. ptxas: 74 / 80 / 118
// registers (I8 / P4 / P4G; folded 70 / 71 / 103), no spills.
// Where the time goes (PERF.md, qmm_turns): the stream alone, with the
// arithmetic cut out, runs at the card's read rate; the arithmetic adds
// ~19 % at 8 rows, 45-50 % in the wide tile at 32, and a launch takes about
// as long as its busiest SM's blocks, so the 224 blocks of w_gateup (two on
// 92 SMs, one on 40) pay for the imbalance. In the wide tile the weight's
// loads and conversions hide under the stream and the products do not:
// cut out, the launch runs at the stream's time. x's B fragments by
// ldmatrix, not 8 lds32 a k-step, took off 2-3 %; a 4-stage ring was
// slower, and the same products as wgmma (x read from the ring) were no
// faster.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "decode_common.cuh"
#include "hopper_common.cuh"

namespace {
namespace qsplit {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

enum class Form { I8, P4, P4G };

constexpr int NT = 256;         // threads a block: 8 warps
constexpr int WARPS = NT / 32;
constexpr int STRIP = 128;      // columns of y a cluster: one 128-byte swizzle row
constexpr int BOX_ROWS = 32;    // rows of one weight box: a stage takes up to 4
constexpr int RED_STRIDE = STRIP + 4;

// floats of the receive buffer: C ranks x mt rows x a slice of ceil(STRIP / C)
constexpr int rx_floats(int mt) {
  int most = 0;
  for (int c = 1; c <= MAX_CLUSTER; ++c) {
    const int n = c * mt * ((STRIP + c - 1) / c);
    most = n > most ? n : most;
  }
  return (most + 3) / 4 * 4;
}

// A block's tile of MT rows of x (8, or the int8 form's wide 32), how its
// warps share the strip and the stage, and its shared memory: the weight
// ring, the x ring (both 1024-byte aligned, as the swizzle wants), the scale
// ring (P4G), the receive buffer, the stages' barriers and counters. X is
// x's type: bf16, or fp32 (the fp32 instances: tiles of 8 rows)
template <Form F, int MT_ = 8, typename X = bf16>
struct Layout {
  static constexpr bool F32 = sizeof(X) == 4;     // fp32 x: TF32 products
  static constexpr int MT = MT_;                  // rows of x a block
  static constexpr int NTI = MT / 8;              // n-tiles of the mma: 8 rows of x each
  static constexpr int COLS = MT == 8 ? 64 : 32;  // columns of the strip a warp
  static constexpr int MTI = COLS / 16;           // m-tiles of the mma a warp
  static constexpr int WORDS = COLS / 32;         // 4-byte words of a weight row a lane reads
  static constexpr int GROUPS = STRIP / COLS;     // column groups of the strip
  static constexpr int BANDS = WARPS / GROUPS;    // warps of a group, taking k-steps in turn
  static constexpr bool PACKED = F != Form::I8;
  static constexpr int ROWS = 128;                // weight rows (packed rows) a stage
  // stages of the ring; fp32 x packed: 4 (5 do not fit twice an SM)
  static constexpr int NSTAGE = MT == 8 ? (F32 && PACKED ? 4 : 5) : 3;
  static constexpr int W_STAGE = ROWS * STRIP;    // weight bytes a stage, 128-byte swizzled rows
  static constexpr int XBOX = 128 / sizeof(X);    // k of one x box (128 bytes): 64 or 32
  // weight rows (packed rows) a k-step: bf16 x 16 k of m16n8k16 (packed: 8
  // rows, both nibbles); fp32 x 8 rows, one m16n8k8 (packed: two, 4 rows each)
  static constexpr int STEP = PACKED || F32 ? 8 : 16;
  static constexpr int HALVES = PACKED ? 2 : 1;  // x's halves a stage: k, k + K/2
  static constexpr int X_STAGE = HALVES * (ROWS / XBOX) * MT * 128;
  static constexpr int S_STAGE = F == Form::P4G ? 4 * STRIP * 2 : 0;  // 2 groups x lo, hi
  static constexpr int X_OFF = NSTAGE * W_STAGE;
  static constexpr int S_OFF = X_OFF + NSTAGE * X_STAGE;
  static constexpr int RX_OFF = S_OFF + NSTAGE * S_STAGE;
  static constexpr int BAR_OFF = RX_OFF + rx_floats(MT) * 4;
  static constexpr int CNT_OFF = BAR_OFF + 8 * NSTAGE;
  static constexpr int SMEM = CNT_OFF + 4 * NSTAGE + 1024;  // + alignment
  static_assert(MT == 8 || (MT == 32 && !PACKED && !F32),
                "tiles of 8 rows; the int8 form with bf16 x also 32");
  static_assert(ROWS / STEP % BANDS == 0 && ROWS / STEP / BANDS <= 4,
                "a band's k-steps a stage: at most 4 chained from zero");
  static_assert(BANDS * MT * RED_STRIDE * 4 <= NSTAGE * W_STAGE, "reduction buffer");
  static_assert(2 * (SMEM + 1024) <= 233472, "two blocks an SM");
};

struct Params {
  const void* x;     // [M, K] bf16 or fp32
  const int8_t* w;   // the layer's weight bytes
  const bf16* s;     // [N] (I8, P4) or [groups, N] (P4G)
  void* y;
  int M, K, N;       // K: columns of x
  int rows;          // weight rows: K, or K / 2 packed
  int groups, gsize;  // P4G: groups of scales (even; bf16 x: K / 128), K / groups rows each
  int share;         // rows a rank, a multiple of the k-step
  int wtma, xtma, stma;  // weight, x, scales by TMA; else loaded by a warp
  int sring;         // P4G: a stage's scale rows ride in the ring (groups of >= ROWS
                     // rows: a stage touches two a half); else each lane reads its own
  int out_f32;
};

// byte `col` of row r of a tile of 128-byte rows in the 128-byte swizzle
// (16-byte chunk c of row r at chunk c ^ (r % 8)), as TMA writes it
__device__ __forceinline__ int sw(int r, int col) {
  return r * 128 + (((col >> 4) ^ (r & 7)) << 4) + (col & 15);
}

// byte of x's element k (0 .. ROWS) of row m (and half h) in a stage
template <typename L>
__device__ __forceinline__ int xsw(int h, int m, int k) {
  return (h * (L::ROWS / L::XBOX) + k / L::XBOX) * L::MT * 128 +
         sw(m, (k % L::XBOX) * (128 / L::XBOX));
}

template <typename X>
__device__ __forceinline__ X x_zero() { return 0.f; }
template <>
__device__ __forceinline__ bf16 x_zero<bf16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// N neighbouring 4-byte words of shared memory (one 8-byte load for two)
template <int N>
__device__ __forceinline__ void ldw(const unsigned char* p, uint32_t (&w)[N]) {
  if constexpr (N == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = lds32(p);
  }
}

__device__ __forceinline__ uint32_t hsub2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t hmul2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// bytes 0 and 2 of p, int8 weights of rows k and k + 1: bf16x2 (exact)
__device__ __forceinline__ uint32_t i8_pair(uint32_t p) {
  const uint32_t v = (p & 0x007F007Fu) | 0x43004300u;  // 128 + (b & 127)
  const uint32_t c = (p & 0x00800080u) | 0x43004300u;  // 128, or 256 where b < 0
  return hsub2(v, c);
}

// the low nibbles of bytes 0 and 2 of q, a packed byte's two weights (low:
// row k, high: row k + K/2): bf16x2 (exact)
__device__ __forceinline__ uint32_t p4_pair(uint32_t q) {
  // nibble ^ 8 = nibble + 8 (signed) into the mantissa of 128: 136 + nibble
  const uint32_t v = ((q ^ 0x00080008u) & 0x000F000Fu) | 0x43004300u;
  return hsub2(v, 0x43084308u);
}

// four 8x8 bf16 matrices of shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; a lane gets elements 2 (l % 4) and + 1 of row
// l / 4 of each: the B fragment of m16n8k16 for matrices of 8 rows of x
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// d += A B, m16n8k16, bf16 in, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A B, m16n8k8, TF32 in (each operand's low 13 bits dropped), fp32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// v = hi + lo to within 2^-22 of v, each rounded to TF32 to nearest, ties
// away from zero (what cvt.rna.tf32.f32 gives), in two integer operations
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// the BITS-bit field at bit P of w, stored biased by 2^(BITS - 1) (an int8
// with its sign bit flipped, a nibble with its top bit flipped), as the fp32
// weight it holds: or'ed into the mantissa of 2^(23 - P), where its lowest
// bit weighs 1, less 2^(23 - P) and the bias. One lop3 and one fadd, exact
template <int P, int BITS>
__device__ __forceinline__ float field(uint32_t w) {
  static_assert(P + BITS <= 23, "a field of the mantissa");
  constexpr uint32_t mask = ((1u << BITS) - 1) << P, one = (127u + 23 - P) << 23;
  constexpr float base = static_cast<float>(1u << (23 - P)) + static_cast<float>(1u << (BITS - 1));
  return __uint_as_float((w & mask) | one) - base;
}

// one count on a stage's counter, ordered after this warp's reads of the
// stage (release) and before the refill that the last count starts (acquire)
__device__ __forceinline__ uint32_t count_out(uint32_t* cnt) {
  uint32_t old;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
               : "=r"(old) : "r"(smem_u32(cnt)) : "memory");
  return old;
}

struct Maps {
  const CUtensorMap* w;
  const CUtensorMap* x;
  const CUtensorMap* s;
};

// Stage t into its slot, by one whole warp: the weight rows [r0, r0 + nr)
// of the strip (boxes of 32 rows; rows past K read as zero), x's slice
// [r0, r0 + ROWS) of the block's rows (of both halves, packed; past K or
// K / 2 zero) and, for P4G with the scales in the ring, the scale rows of
// the one or two groups the stage touches in each half, all completing on
// the stage's barrier. What a tensor map cannot take the warp loads itself,
// into the same layout, before lane 0 arrives.
template <Form F, int MT, typename X>
__device__ __forceinline__ void refill(unsigned char* smem, const Maps& maps, const Params& p,
                                       int t, int kb, int ke, int col0, int m0) {
  using L = Layout<F, MT, X>;
  const int lane = threadIdx.x % 32, slot = t % L::NSTAGE;
  unsigned char* ws = smem + slot * L::W_STAGE;
  unsigned char* xs = smem + L::X_OFF + slot * L::X_STAGE;
  unsigned char* ss = smem + L::S_OFF + slot * L::S_STAGE;
  const uint32_t bar = smem_u32(smem + L::BAR_OFF) + 8 * slot;
  const int r0 = kb + t * L::ROWS, nr = min(L::ROWS, ke - r0);
  const int boxes = (nr + BOX_ROWS - 1) / BOX_ROWS;
  int gh = 0, g0 = 0;  // P4G: groups a half; the stage's first
  if constexpr (F == Form::P4G) {
    gh = L::F32 ? p.groups / 2 : p.rows / 128;
    g0 = L::F32 ? r0 / p.gsize : r0 / 128;
  }
  if (!p.wtma) {
    for (int c = lane; c < nr * (STRIP / 4); c += 32) {
      const int r = c / (STRIP / 4), word = c % (STRIP / 4);
      const int8_t* row = p.w + static_cast<long long>(r0 + r) * p.N;
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = col0 + 4 * word + b;
        if (col < p.N) v |= static_cast<uint32_t>(static_cast<uint8_t>(row[col])) << (8 * b);
      }
      *reinterpret_cast<uint32_t*>(ws + sw(r, 4 * word)) = v;
    }
  }
  if (!p.xtma) {
    const X* x = static_cast<const X*>(p.x);
    for (int c = lane; c < L::HALVES * MT * L::ROWS; c += 32) {
      const int h = c / (MT * L::ROWS), m = c / L::ROWS % MT, k = c % L::ROWS;
      const bool in = m0 + m < p.M && r0 + k < p.rows;
      *reinterpret_cast<X*>(xs + xsw<L>(h, m, k)) =
          in ? x[static_cast<long long>(m0 + m) * p.K + h * p.rows + r0 + k] : x_zero<X>();
    }
  }
  if (F == Form::P4G && p.sring && !p.stma) {
    // rows j = 0, 1: the low half's groups g0 and + 1; j = 2, 3 the high
    // half's, gh groups further
    for (int c = lane; c < 4 * STRIP; c += 32) {
      const int j = c / STRIP, col = col0 + c % STRIP, grp = g0 + (j & 1) + (j >> 1) * gh;
      reinterpret_cast<bf16*>(ss)[c] = (grp < 2 * gh && col < p.N)
          ? p.s[static_cast<long long>(grp) * p.N + col] : __float2bfloat16(0.f);
    }
  }
  __syncwarp();
  if (lane == 0) {
    const int xboxes = L::HALVES * (L::ROWS / L::XBOX);
    const int bytes = (p.wtma ? boxes * BOX_ROWS * STRIP : 0) +
                      (p.xtma ? xboxes * MT * 128 : 0) +
                      (F == Form::P4G && p.stma ? 4 * STRIP * 2 : 0);
    fence_proxy_async();  // the slot's reads by the warps before the copies' writes
    mbar_arrive_tx(bar, bytes);
    if (p.wtma)
      for (int b = 0; b < boxes; ++b)
        tma_load_2d(smem_u32(ws + b * BOX_ROWS * STRIP), maps.w, bar, col0, r0 + b * BOX_ROWS);
    if (p.xtma) {
      for (int b = 0; b < xboxes; ++b) {
        const uint32_t dst = smem_u32(xs + b * MT * 128);
        const int k = r0 + (b % (L::ROWS / L::XBOX)) * L::XBOX;
        if (L::PACKED)
          tma_load_3d(dst, maps.x, bar, k, b / (L::ROWS / L::XBOX), m0);
        else
          tma_load_2d(dst, maps.x, bar, k, m0);
      }
    }
    if (F == Form::P4G && p.stma)
      for (int j = 0; j < 4; ++j)
        tma_load_2d(smem_u32(ss + j * STRIP * 2), maps.s, bar, col0,
                    g0 + (j & 1) + (j >> 1) * gh);
  }
}

// the scale pairs (low half's, high half's) of the lane's 8 columns for the
// k-steps of stage row group j (0: the stage's first group, 1: the next)
__device__ __forceinline__ void scale_pairs(const unsigned char* st_scales, int j, int col,
                                            uint32_t (&sp)[8]) {
  const bf16* sc = reinterpret_cast<const bf16*>(st_scales);
  const uint4 lo = *reinterpret_cast<const uint4*>(sc + j * STRIP + col);
  const uint4 hi = *reinterpret_cast<const uint4*>(sc + (2 + j) * STRIP + col);
  const uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w}, h[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) sp[e] = __byte_perm(l[e / 2], h[e / 2], (e & 1) ? 0x7632 : 0x5410);
}

// eight bf16 (a 16-byte word) as fp32
__device__ __forceinline__ void bf16x8(const uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
  }
}

// FOLD (fp32 x, M <= 4): x_hi of rows 0-3 in B's columns 0-3 and x_lo in
// 4-7, so that one mma takes both products (their sums meet in the epilogue)
template <Form F, int MT, typename X, bool FOLD = false>
__global__ void __launch_bounds__(NT, 2)
    split_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap smap, const Params p) {
  using L = Layout<F, MT, X>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // every block of the cluster runs before any block writes into it; this
  // half of the barrier completes while the weight streams
  cluster_arrive_relaxed();

  const int col0 = blockIdx.y * STRIP, m0 = blockIdx.z * MT;
  const int mrows = min(MT, p.M - m0);
  const int kb = min(p.rows, rank * p.share), ke = min(p.rows, kb + p.share);
  const int nst = (ke - kb + L::ROWS - 1) / L::ROWS;
  const Maps maps = {&wmap, &xmap, &smap};
  float* rx = reinterpret_cast<float*>(smem + L::RX_OFF);
  const uint32_t bars = smem_u32(smem + L::BAR_OFF);
  uint32_t* cnt = reinterpret_cast<uint32_t*>(smem + L::CNT_OFF);
  if (threadIdx.x < L::NSTAGE) {
    mbar_init(bars + 8 * threadIdx.x, 1);
    cnt[threadIdx.x] = 0;
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int group = warp % L::GROUPS, band = warp / L::GROUPS;
  const int lcol = group * L::COLS + (L::COLS / 8) * g;  // the lane's columns of the strip
  if (warp == 0)
    for (int t = 0; t < min(nst, L::NSTAGE); ++t)
      refill<F, MT, X>(smem, maps, p, t, kb, ke, col0, m0);

  // the lane's rows 2 tq and 2 tq + 1 of a k-step in the swizzle: byte
  // offsets from the k-step's first row (the chunk c ^ (row % 8) does not
  // change with the k-step, which starts on a multiple of 8 rows)
  const int wo0 = sw(2 * tq, lcol), wo1 = sw(2 * tq + 1, lcol);
  float acc[L::MTI][L::NTI][4];
#pragma unroll
  for (int j = 0; j < L::MTI; ++j)
#pragma unroll
    for (int n = 0; n < L::NTI; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;
  uint32_t sp[8];  // P4G, bf16 x: scale pairs of the lane's columns
  int sp_at = -1;  // P4G, bf16 x: (stage, group) they belong to
  float sl[8], sh[8];  // P4G, fp32 x: the lane's columns' scales (low half, high half) ...
  int s_end = 0;       // ... of the group that ends before this packed row

  // P4G, fp32 x: the scales of packed row R's groups (the stage's own rows
  // of them, sg0 the stage's first group, or device memory)
  auto group_scales = [&](int R, const unsigned char* st_scales, int sg0) {
    const int grp = R / p.gsize;
    s_end = (grp + 1) * p.gsize;
    if (p.sring) {
      const bf16* sc = reinterpret_cast<const bf16*>(st_scales) + (grp - sg0) * STRIP + lcol;
      bf16x8(*reinterpret_cast<const uint4*>(sc), sl);
      bf16x8(*reinterpret_cast<const uint4*>(sc + 2 * STRIP), sh);
    } else {  // rows past K / 2 (the last k-step's) read zeros, as the ring's do
      const int col = col0 + lcol;
      const bool in = grp < p.groups / 2;
      const bf16* lo = p.s + static_cast<long long>(grp) * p.N + col;
      const bf16* hi = lo + static_cast<long long>(p.groups / 2) * p.N;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sl[e] = in && col + e < p.N ? __bfloat162float(lo[e]) : 0.f;
        sh[e] = in && col + e < p.N ? __bfloat162float(hi[e]) : 0.f;
      }
    }
  };

  // one k-step at row kk of stage t: d += the lane's share of its products
  auto kstep = [&](float (&d)[L::MTI][L::NTI][4], const unsigned char* ws,
                   const unsigned char* xs, int t, int slot, int r0, int kk, int sg0) {
    const unsigned char* wrow = ws + kk * STRIP;
    uint32_t w0[L::WORDS], w1[L::WORDS];
    ldw(wrow + wo0, w0);
    ldw(wrow + wo1, w1);
    if constexpr (L::F32) {
      // fp32 x: each k-step of the mma (8 k) two m16n8k8 TF32 products,
      // W x_hi + W x_lo, on one A fragment; x split once a B fragment. A's
      // k index tq is weight row 2 tq of the step (packed: the low nibble of
      // row 2 tq, or of 2 tq + 1 in the second step), tq + 4 row 2 tq + 1
      // (packed: the high nibble of the same row); B meets them with x at
      // the same k: x[k], x[k + 1] (packed: x[k], x[k + K/2]). x's k + 2 tq
      // and + 1 of row g: 8 bytes of a 16-byte chunk of the 128-byte swizzle
      // (FOLD: x row g % 4, its x_hi in B column g < 4, its x_lo in g >= 4)
      const int chunk = (kk % L::XBOX) / 4 + tq / 2, xr = FOLD ? g & 3 : g;
      const unsigned char* xp = xs + (kk / L::XBOX) * MT * 128 + xr * 128 +
                                ((chunk ^ xr) << 4) + 8 * (tq & 1);
      const float2 xa = *reinterpret_cast<const float2*>(xp);
      if constexpr (F == Form::I8) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(xa.x, bh0, bl0);
        split_tf32(xa.y, bh1, bl1);
        if (FOLD && g >= 4) {
          bh0 = bl0;
          bh1 = bl1;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // the m-tile's columns c and c + 1: bytes 2 j % 4 and + 1 of word
          // j / 2 (the upper two moved down by 16 bits), sign bits flipped
          const uint32_t v0 = (w0[j / 2] ^ 0x80808080u) >> (16 * (j & 1));
          const uint32_t v1 = (w1[j / 2] ^ 0x80808080u) >> (16 * (j & 1));
          const uint32_t a0 = __float_as_uint(field<0, 8>(v0));
          const uint32_t a1 = __float_as_uint(field<8, 8>(v0));
          const uint32_t a2 = __float_as_uint(field<0, 8>(v1));
          const uint32_t a3 = __float_as_uint(field<8, 8>(v1));
          mma_tf32(d[j][0], a0, a1, a2, a3, bh0, bh1);
          if (!FOLD) mma_tf32(d[j][0], a0, a1, a2, a3, bl0, bl1);
        }
      } else {
        const float2 xb = *reinterpret_cast<const float2*>(xp + (L::ROWS / L::XBOX) * MT * 128);
        uint32_t bh[2][2], bl[2][2];  // [packed row 2 tq + r][x[k], x[k + K/2]]
        split_tf32(xa.x, bh[0][0], bl[0][0]);
        split_tf32(xb.x, bh[0][1], bl[0][1]);
        split_tf32(xa.y, bh[1][0], bl[1][0]);
        split_tf32(xb.y, bh[1][1], bl[1][1]);
        if (FOLD && g >= 4) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            bh[r][0] = bl[r][0];
            bh[r][1] = bl[r][1];
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t* w = r ? w1 : w0;
          if constexpr (F == Form::P4G) {
            const int R = r0 + kk + 2 * tq + r;
            if (R >= s_end) group_scales(R, smem + L::S_OFF + slot * L::S_STAGE, sg0);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // columns c and c + 1: the low nibble at bits 0 and 8, the high
            // at 4 and 12, top bits flipped
            const uint32_t v = (w[j / 2] ^ 0x88888888u) >> (16 * (j & 1));
            float lo0 = field<0, 4>(v), lo1 = field<8, 4>(v);
            float hi0 = field<4, 4>(v), hi1 = field<12, 4>(v);
            if constexpr (F == Form::P4G) {  // exact: 11 significant bits at most
              lo0 *= sl[2 * j];
              lo1 *= sl[2 * j + 1];
              hi0 *= sh[2 * j];
              hi1 *= sh[2 * j + 1];
            }
            const uint32_t a0 = __float_as_uint(lo0), a1 = __float_as_uint(lo1);
            const uint32_t a2 = __float_as_uint(hi0), a3 = __float_as_uint(hi1);
            mma_tf32(d[j][0], a0, a1, a2, a3, bh[r][0], bh[r][1]);
            if (!FOLD) mma_tf32(d[j][0], a0, a1, a2, a3, bl[r][0], bl[r][1]);
          }
        }
      }
      return;
    }
    // x's k = kk + 2 tq (and + 8) of row 8 n + g: 4 bytes of a 16-byte chunk
    const unsigned char* xrow = xs + (kk / L::XBOX) * MT * 128 + g * 128 + 4 * tq;
    const int chunk = (kk % L::XBOX) / 8;
    if constexpr (F == Form::I8) {
      uint32_t w8[L::WORDS], w9[L::WORDS], b0[L::NTI], b1[L::NTI];
      ldw(wrow + 8 * STRIP + wo0, w8);
      ldw(wrow + 8 * STRIP + wo1, w9);
      if constexpr (L::NTI == 4) {
        // two ldmatrix.x4: n-tiles 2 q and 2 q + 1, k chunks chunk and + 1;
        // lane l gives row l % 8 of matrix l / 8
        const int r = lane % 8, mq = lane / 8;
        const uint32_t xb = smem_u32(xs) + (kk / L::XBOX) * MT * 128;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int row = 8 * (2 * q + mq / 2) + r;
          ldsm_x4(xb + row * 128 + (((chunk + mq % 2) ^ r) << 4), b0[2 * q], b1[2 * q],
                  b0[2 * q + 1], b1[2 * q + 1]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < L::NTI; ++n) {
          b0[n] = lds32(xrow + n * 8 * 128 + ((chunk ^ g) << 4));
          b1[n] = lds32(xrow + n * 8 * 128 + (((chunk + 1) ^ g) << 4));
        }
      }
#pragma unroll
      for (int j = 0; j < L::MTI; ++j) {
        // the m-tile's columns c and c + 1: bytes 2 j % 4 and + 1 of word j / 2
        const uint32_t sel = (j & 1) ? 0x7632 : 0x5410;
        const uint32_t p01 = __byte_perm(w0[j / 2], w1[j / 2], sel);
        const uint32_t p89 = __byte_perm(w8[j / 2], w9[j / 2], sel);
        const uint32_t a0 = i8_pair(p01), a1 = i8_pair(p01 >> 8);
        const uint32_t a2 = i8_pair(p89), a3 = i8_pair(p89 >> 8);
#pragma unroll
        for (int n = 0; n < L::NTI; ++n) mma(d[j][n], a0, a1, a2, a3, b0[n], b1[n]);
      }
    } else {
      // k pairs tq and tq + 4 of the mma are packed rows kk + 2 tq and + 1,
      // their low and high nibbles; B pairs x[k] with x[k + K/2] to match
      const uint32_t xl = lds32(xrow + ((chunk ^ g) << 4));
      const uint32_t xh = lds32(xrow + (L::ROWS / L::XBOX) * MT * 128 + ((chunk ^ g) << 4));
      const uint32_t b0 = __byte_perm(xl, xh, 0x5410), b1 = __byte_perm(xl, xh, 0x7632);
      if (F == Form::P4G) {
        const int j = (r0 + kk) / 128 - r0 / 128;
        if (t * 2 + j != sp_at) {  // the same in the whole warp
          sp_at = t * 2 + j;
          scale_pairs(smem + L::S_OFF + slot * L::S_STAGE, j, lcol, sp);
        }
      }
      const uint32_t w04[2] = {w0[0] >> 4, w0[1] >> 4}, w14[2] = {w1[0] >> 4, w1[1] >> 4};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sel = (j & 1) ? 0x7632 : 0x5410;
        const uint32_t qa = __byte_perm(w0[j / 2], w04[j / 2], sel);
        const uint32_t qb = __byte_perm(w1[j / 2], w14[j / 2], sel);
        uint32_t a0 = p4_pair(qa), a1 = p4_pair(qa >> 8);
        uint32_t a2 = p4_pair(qb), a3 = p4_pair(qb >> 8);
        if (F == Form::P4G) {
          a0 = hmul2(a0, sp[2 * j]);
          a1 = hmul2(a1, sp[2 * j + 1]);
          a2 = hmul2(a2, sp[2 * j]);
          a3 = hmul2(a3, sp[2 * j + 1]);
        }
        mma(d[j][0], a0, a1, a2, a3, b0, b1);
      }
    }
  };

  for (int t = 0; t < nst; ++t) {
    const int slot = t % L::NSTAGE;
    mbar_wait(bars + 8 * slot, (t / L::NSTAGE) & 1);  // stage t is in
    const unsigned char* ws = smem + slot * L::W_STAGE;
    const unsigned char* xs = smem + L::X_OFF + slot * L::X_STAGE;
    const int r0 = kb + t * L::ROWS, nr = min(L::ROWS, ke - r0);
    const int sg0 = L::F32 && F == Form::P4G ? r0 / p.gsize : 0;
    float d[L::MTI][L::NTI][4];
#pragma unroll
    for (int j = 0; j < L::MTI; ++j)
#pragma unroll
      for (int n = 0; n < L::NTI; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][n][e] = 0.f;
#pragma unroll
    for (int i = 0; i < L::ROWS / L::STEP / L::BANDS; ++i) {
      const int kk = (band + i * L::BANDS) * L::STEP;  // first row of the k-step in the stage
      if (kk >= nr) break;  // the same in the whole warp
      kstep(d, ws, xs, t, slot, r0, kk, sg0);
    }
#pragma unroll
    for (int j = 0; j < L::MTI; ++j)
#pragma unroll
      for (int n = 0; n < L::NTI; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][n][e] += d[j][n][e];
    // count this warp out of the stage; the last one refills its slot
    __syncwarp();
    uint32_t old = 0;
    if (lane == 0) old = count_out(cnt + slot);
    old = __shfl_sync(0xffffffffu, old, 0);
    if (old == WARPS - 1) {
      if (lane == 0) cnt[slot] = 0;  // no warp counts on it before the refill lands
      if (t + L::NSTAGE < nst)
        refill<F, MT, X>(smem, maps, p, t + L::NSTAGE, kb, ke, col0, m0);
    }
  }

  // the bands' sums meet in shared memory (the weight ring is free now) ...
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [BANDS][MT][RED_STRIDE]
#pragma unroll
  for (int j = 0; j < L::MTI; ++j)
#pragma unroll
    for (int n = 0; n < L::NTI; ++n) {
      // d[j][n]: A rows g, g + 8 (columns lcol + 2 j, + 1) x rows 8 n + 2 tq, + 1 of x
      float* r = red + (band * MT + 8 * n + 2 * tq) * RED_STRIDE + lcol + 2 * j;
      r[0] = acc[j][n][0];
      r[RED_STRIDE] = acc[j][n][1];
      r[1] = acc[j][n][2];
      r[RED_STRIDE + 1] = acc[j][n][3];
    }
  __syncthreads();
  // ... then the ranks' in rank o's shared memory, o's slice of the strip
  const int slice = (STRIP + C - 1) / C;
  cluster_wait();
  for (int i = threadIdx.x; i < mrows * STRIP; i += NT) {
    const int m = i / STRIP, c = i % STRIP;
    float v = 0.f;
#pragma unroll
    for (int b = 0; b < L::BANDS; ++b) {
      v += red[(b * MT + m) * RED_STRIDE + c];
      if (FOLD) v += red[(b * MT + m + 4) * RED_STRIDE + c];  // x_lo's products
    }
    const int owner = c / slice;
    *cluster.map_shared_rank(rx + (rank * MT + m) * slice + c - owner * slice, owner) = v;
  }
  cluster_arrive();
  cluster_wait();  // after it no block touches another's shared memory
  const int c0 = rank * slice, cn = max(0, min(slice, STRIP - c0));
  for (int i = threadIdx.x; i < mrows * cn; i += NT) {
    const int m = i / cn, c = i % cn, col = col0 + c0 + c;
    if (col >= p.N) continue;
    float v = 0.f;
    for (int r = 0; r < C; ++r) v += rx[(r * MT + m) * slice + c];
    if (F != Form::P4G) v *= __bfloat162float(p.s[col]);
    const long long at = static_cast<long long>(m0 + m) * p.N + col;
    if (p.out_f32)
      static_cast<float*>(p.y)[at] = v;
    else
      static_cast<bf16*>(p.y)[at] = __float2bfloat16(v);
  }
}

// Clusters of C blocks that can run at once, or a negative CUDA error.
template <Form F, int MT = 8, typename X = bf16>
int clusters_at_once(int C) {
  using L = Layout<F, MT, X>;
  if (C < 1 || C > MAX_CLUSTER) return -static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = split_kernel<F, MT, X>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::SMEM);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// a tiled tensor map of `rank` dims (innermost first; strides in bytes of
// the outer dims) with boxes of `box`, or an error
inline int tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                      const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode_tiled()(map, type, rank, const_cast<void*>(base), dims, strides,
                                    box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// One launch: grid (C, strips, tiles of MT rows of x), clusters of C along
// K. share: weight rows a rank (from split_plan), a multiple of the k-step,
// C shares covering the rows. P4G: p.groups even and dividing K.
template <Form F, int MT = 8, typename X = bf16>
int launch(Params p, int C, int share, cudaStream_t stream) {
  using L = Layout<F, MT, X>;
  if (p.M < 1 || p.rows < 1 || p.N < 1 || C < 1 || C > MAX_CLUSTER || share < L::STEP ||
      share % L::STEP || static_cast<long long>(C) * share < p.rows ||
      (F == Form::P4G && (p.groups < 2 || p.groups % 2 || p.K % p.groups)))
    return static_cast<int>(cudaErrorInvalidValue);
  p.share = share;
  p.gsize = F == Form::P4G ? p.K / p.groups : 0;
  p.sring = (F == Form::P4G && p.gsize >= L::ROWS) ? 1 : 0;
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  constexpr int EPC = 16 / sizeof(X);  // x's elements a 16-byte chunk
  p.wtma = (p.N % 16 == 0 && aligned(p.w)) ? 1 : 0;
  p.xtma = (p.rows % EPC == 0 && p.K % EPC == 0 && aligned(p.x)) ? 1 : 0;
  p.stma = (p.sring && p.N % 8 == 0 && aligned(p.s)) ? 1 : 0;
  CUtensorMap wmap, xmap, smap;
  memset(&wmap, 0, sizeof(wmap));
  memset(&xmap, 0, sizeof(xmap));
  memset(&smap, 0, sizeof(smap));
  int err = 0;
  if (p.wtma) {  // the weight [rows, N] bytes: 128 columns x 32 rows a box
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.N), static_cast<cuuint64_t>(p.rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.N)};
    const cuuint32_t box[2] = {STRIP, BOX_ROWS};
    err = tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p.w, dims, strides, box,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == 0 && p.xtma) {  // x [M, K], packed as [M][2][K/2]: 128 bytes of k x MT rows a box
    const CUtensorMapDataType type =
        L::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.rows), 2, static_cast<cuuint64_t>(p.M)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(p.rows) * sizeof(X),
                                   static_cast<cuuint64_t>(p.K) * sizeof(X)};
    const cuuint32_t box[3] = {L::XBOX, 1, MT};
    if (L::PACKED) {
      err = tensor_map(&xmap, type, 3, p.x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    } else {
      const cuuint64_t d2[2] = {static_cast<cuuint64_t>(p.K), static_cast<cuuint64_t>(p.M)};
      const cuuint32_t b2[2] = {L::XBOX, MT};
      err = tensor_map(&xmap, type, 2, p.x, d2, strides + 1, b2, CU_TENSOR_MAP_SWIZZLE_128B);
    }
  }
  if (err == 0 && p.stma) {  // the scales [groups, N] bf16: one group row of 128 columns a box
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.N), static_cast<cuuint64_t>(p.groups)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.N) * 2};
    const cuuint32_t box[2] = {STRIP, 1};
    err = tensor_map(&smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.s, dims, strides, box,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != 0) return err;
  const int strips = (p.N + STRIP - 1) / STRIP, tiles = (p.M + MT - 1) / MT;
  if constexpr (L::F32) {
    if (p.M <= 4)  // half the products: x_hi and x_lo in one B fragment
      return launch_clusters(split_kernel<F, MT, X, true>, C, strips, tiles, NT, L::SMEM, stream,
                             wmap, xmap, smap, p);
  }
  return launch_clusters(split_kernel<F, MT, X>, C, strips, tiles, NT, L::SMEM, stream, wmap,
                         xmap, smap, p);
}

}  // namespace qsplit
}  // namespace
