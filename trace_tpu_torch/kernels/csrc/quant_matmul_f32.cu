// Weight products of quantized leaves with fp32 activations: the fp32 forms
// of quant_matmul.cu and quant_matmul_p4.cu, for a model served in fp32.
// Replaces, in fp32, trace_tpu/kernels/quant_matmul.py quant_matmul (:320)
// and quant_matmul_stacked (:418) (int8 q, FORM_I8), quant_matmul_p4 (:133)
// (nibble-packed int4, per-channel s, FORM_P4) and quant_matmul_p4_grouped
// (:239) (groups of K / G rows, FORM_P4G), which compute in x's dtype:
//     FORM_I8, FORM_P4:  y = (x @ q) * s     (the scale once, on the fp32 sum)
//     FORM_P4G:          y = x @ (q * s[k / (K / G)])
// Every weight is exact in fp32 (an int8, a nibble, or a nibble times a bf16
// scale), so the products are exact and only the order of the fp32 sums
// differs from the plain version. A packed byte qp[k, n] holds weight rows k
// (low nibble, sign-extended) and k + K / 2 (high nibble). The stacked entry
// points are these with the layer's weight and scale pointers (the wrapper
// offsets them; nothing is copied).
//
// Up to 8 rows of x (a decode step) take the fp32 instances of the bf16
// kernels' split-K form (qmm_split.cuh, through quant_matmul.cu's and
// quant_matmul_p4.cu's _f32 entry points: one cluster launch, no workspace,
// two TF32 products a k-step). This source holds the form for more rows:
//   * a prefill, on the tensor cores: bound by operations, 2 M K N
//     of them (a 7B layer's four products at M = 3886: 1.695 TFLOP, 25.3 ms at
//     the 67 TFLOP/s fp32 CUDA-core peak). Every weight of the three forms is
//     exact in TF32, which keeps 11 significant bits (an int8 needs 7, a
//     nibble 3, a nibble times a bf16 scale 11), so only x is split: x_hi =
//     rna_tf32(x), x_lo = rna_tf32(x - x_hi) keep x to within 2^-22 of
//     itself, and x_hi W + x_lo W, two TF32 products whose every product is
//     exact in fp32, give fp32 accuracy (ceiling: 2 x 1.695 TFLOP at the
//     495 TFLOP/s TF32 peak, 6.85 ms). The skeleton of quant_matmul_p4.cu's
//     tensor-core form: a block computes a 128 x 128 tile of y (64 x 128 for
//     M <= 64) with two (one) consumer warpgroups issuing
//     wgmma.mma_async m64n128k8 .tf32 (fp32 accumulate) and one producer
//     warpgroup. A stage holds 32 values of k (one 128-byte row of fp32):
//     x's tile, which TMA fetches in the 128-byte swizzle, and the weight
//     tile, which the producer converts from a TMA-fetched tile of 32 stored
//     rows (packed: its low nibbles weigh x[:, k], its high nibbles
//     x[:, k + K/2], two stages) into fp32 values stored transposed
//     ([column][k], K-major in the same swizzle: TF32 wgmma takes no
//     MN-major operand), each byte once per block: the byte or nibble or'ed
//     into the mantissa of 2^23 minus 2^23 and its bias (exact), grouped
//     times its scale (exact). Full and empty mbarriers hand the stages over
//     (a 6-stage ring of 32 KB; 8 of 24 KB for the 64-row tile). A consumer
//     reads its x values of a stage into registers as wgmma's A fragments
//     and splits them there (cvt.rna.tf32: the wgmma would truncate), then
//     runs 8 wgmma, 4 on x_hi and 4 on x_lo, the weight read from shared
//     memory. The split in the producer, through shared memory, left the
//     producer setting the pace (PERF.md). The tensor cores add a
//     product into the accumulator truncating, so every PROMOTE_K values of
//     k (both halves of x) the wgmma sum is added into a second register sum
//     with round-to-nearest fp32 adds and started anew (PERF.md: the error
//     at K = 14336 with and without). setmaxnreg moves registers from the
//     producer to the two consumers. Shapes a tensor map cannot take (K / 2
//     % 4, N % 16, unaligned pointers) load the same tiles with predicated
//     loads in the producer.
// Nothing is atomic and every sum runs in a fixed order: a call repeats bit
// for bit.

#include <string.h>

#include "hopper_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;
enum Form { FORM_I8 = 0, FORM_P4 = 1, FORM_P4G = 2 };

// ---- tensor-core form (M > 8) ---------------------------------------------
//
// A stage's tiles are [rows][32 fp32], 128-byte rows in the 128-byte swizzle
// (16-byte chunk c of row r at chunk c ^ (r % 8)), the layout TMA writes and
// wgmma reads through a K-major descriptor: x [BM][32] and the weight
// [BN][32], stored transposed. A k step of 8 TF32 values moves the weight's
// descriptor by 32 bytes.

constexpr int TBN = 128;                  // columns of y per block
constexpr int TBK = 32;                   // values of k per stage
constexpr int ROW_BYTES = 128;            // bytes per row of an operand tile
constexpr int W_TILE = TBN * ROW_BYTES;   // the weight of a stage: 16 KB
constexpr int P_TILE = TBK * TBN;         // a tile of 32 stored weight rows: 4 KB
constexpr int P_SLOTS = 4;                // stored tiles in flight (3 ahead)
constexpr int PROMOTE_K = 128;            // k between promotions of the wgmma sum (0: none)

// NC consumer warpgroups of 64 rows each, then one producer warpgroup
template <int NC>
struct Tf {
  static constexpr int BM = 64 * NC;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int X_TILE = BM * ROW_BYTES;
  static constexpr int STAGE = X_TILE + W_TILE;  // x, weight
  static constexpr int STAGES = NC == 2 ? 6 : 8;
  static constexpr int P_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = P_OFF + P_SLOTS * P_TILE;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + P_SLOTS) + 1024;  // + alignment
};
static_assert(Tf<2>::SMEM <= 232448 && Tf<1>::SMEM <= 232448, "shared memory");

struct TcParams {
  const float* x;
  const int8_t* w;  // [rows, N]: int8 (rows = K) or packed (rows = K / 2)
  const bf16* s;
  void* y;
  int M, K, N, groups;
  int xtma;     // x through its tensor map (rows % 4 == 0, 16-byte aligned), else loads
  int wtma;     // w through its tensor map (N % 16 == 0, 16-byte aligned), else loads
  int yvec;     // N % 8 == 0 and y 16-byte aligned: 16-byte stores
};

template <int NC>
struct TfBars {  // addresses of the barriers in shared memory
  uint32_t full, empty, pfull;
  __device__ explicit TfBars(uint32_t base)
      : full(base + Tf<NC>::BAR_OFF), empty(full + 8 * Tf<NC>::STAGES),
        pfull(empty + 8 * Tf<NC>::STAGES) {}
};

__device__ __forceinline__ void producer_sync() {  // the producer warpgroup alone
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// x rounded to TF32, to nearest with ties away from zero, as an fp32 bit
// pattern whose low 13 bits are zero (so that x - x_hi is exactly the rest)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xFFFFE000u;
}

// d [64 x 128 of y, fp32] (+)= A [64 x 8] * B [8 x 128], TF32, A from
// registers (a thread of warp w holds rows 16 w + g and + 8, columns t and
// t + 4, g = lane / 4, t = lane % 4: a[0] (g, t), a[1] (g + 8, t), a[2]
// (g, t + 4), a[3] (g + 8, t + 4)), B from shared memory; d's fragment as
// in quant_matmul_p4.cu's wgmma_128. accumulate = 0 starts the sum.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// weight-tile row (the wgmma's N index) of output column n of the tile:
// thread t of a quad then holds the 32 columns 32 t .. 32 t + 31 of y
__device__ __forceinline__ int b_row(int n) {
  return 8 * ((n & 31) >> 1) + 2 * (n >> 5) + (n & 1);
}

// the scales of weight row r (of K) at columns col0 .. col0 + 3; 0 past K or N
__device__ __forceinline__ void scales4(const TcParams& p, int r, int col0, float (&s)[4]) {
  const bf16* row = p.s + static_cast<long long>(r / (p.K / p.groups)) * p.N + col0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    s[j] = (r < p.K && col0 + j < p.N) ? __bfloat162float(row[j]) : 0.f;
}

// The producer warpgroup: for each tile of 32 stored weight rows (TMA, 3
// tiles ahead, or loads), x's tiles of its H stages (TMA, or loads) and the
// weight converted into each stage's weight tile.
template <int NC, int FORM>
__device__ __forceinline__ void tf_produce(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                           const TcParams& p, unsigned char* smem, int m_blk,
                                           int n_blk) {
  using T = Tf<NC>;
  constexpr int H = FORM == FORM_I8 ? 1 : 2;  // stages a stored tile feeds
  const int rows = FORM == FORM_I8 ? p.K : p.K / 2;
  const int pt = threadIdx.x - 128 * NC, pw = pt / 32, lane = pt % 32;
  const TfBars<NC> bars(smem_u32(smem));
  const int nkp = (rows + TBK - 1) / TBK;
  auto slot_of = [&](int kp) { return smem + T::P_OFF + (kp % P_SLOTS) * P_TILE; };

  auto fetch = [&](int kp) {  // tile kp by TMA into its slot
    if (pt == 0) {
      fence_proxy_async();
      const uint32_t bar = bars.pfull + 8 * (kp % P_SLOTS);
      mbar_arrive_tx(bar, P_TILE);
      tma_load_2d(smem_u32(slot_of(kp)), wmap, bar, n_blk, kp * TBK);
    }
  };
  if (p.wtma)
    for (int kp = 0; kp < min(nkp, P_SLOTS - 1); ++kp) fetch(kp);

  // the thread's 4 columns 4 lane .. + 3 and 2 of the 8 chunks (of 4 rows)
  // of a tile, turning with the lane so that the 16-byte stores of the 8
  // lanes of a store phase land in 8 distinct chunks of the swizzle
  const int col0 = n_blk + 4 * lane;
  const bool row_scales = FORM == FORM_P4G && ((p.K / p.groups) % 4 || rows % 4);
  for (int kp = 0; kp < nkp; ++kp) {
    producer_sync();  // every thread is done with tile kp - 1's slot: refill it
    if (p.wtma && kp + P_SLOTS - 1 < nkp) fetch(kp + P_SLOTS - 1);

    float sc[2][H][4];  // FORM_P4G: the scales of the thread's chunks' first rows
    if (FORM == FORM_P4G) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < H; ++h)
          scales4(p, kp * TBK + 4 * ((lane + 2 * pw + i) & 7) + h * rows, col0, sc[i][h]);
    }

    unsigned char* stage[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {  // stage H kp + h takes half h of x
      const int st = H * kp + h, slot = st % T::STAGES;
      mbar_wait(bars.empty + 8 * slot, ((st / T::STAGES) & 1) ^ 1);
      stage[h] = smem + slot * T::STAGE;
      if (p.xtma) {
        if (pt == 0) {
          const uint32_t bar = bars.full + 8 * slot;
          mbar_arrive_tx(bar, T::X_TILE);
          if (FORM == FORM_I8)
            tma_load_2d(smem_u32(stage[h]), xmap, bar, kp * TBK, m_blk);
          else
            tma_load_3d(smem_u32(stage[h]), xmap, bar, kp * TBK, h, m_blk);
        }
      } else {
        for (int i = pt; i < T::BM * 8; i += 128) {  // x through loads, into the swizzle
          const int r = i / 8, c = i % 8;
          const int row = m_blk + r, col = kp * TBK + 4 * c;
          const float* src = p.x + static_cast<long long>(row) * p.K + h * rows + col;
          float a[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = (row < p.M && col + e < rows) ? src[e] : 0.f;
          *reinterpret_cast<float4*>(stage[h] + r * ROW_BYTES + ((c ^ (r & 7)) << 4)) =
              make_float4(a[0], a[1], a[2], a[3]);
        }
        if (pt == 0) mbar_arrive(bars.full + 8 * slot);  // in place of the copy's arrival
      }
    }

    const unsigned char* pk = slot_of(kp);
    if (p.wtma) {
      mbar_wait(bars.pfull + 8 * (kp % P_SLOTS), (kp / P_SLOTS) & 1);
    } else {
      for (int i = pt; i < P_TILE / 4; i += 128) {
        const int r = i / (TBN / 4), c = (i % (TBN / 4)) * 4;
        const int row = kp * TBK + r;
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = n_blk + c + b;
          if (row < rows && col < p.N)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(
                        p.w[static_cast<long long>(row) * p.N + col])) << (8 * b);
        }
        *reinterpret_cast<uint32_t*>(const_cast<unsigned char*>(pk) + r * TBN + c) = word;
      }
      producer_sync();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ch = (lane + 2 * pw + i) & 7;
      uint32_t w[4];  // rows 4 ch + e, columns 4 lane .. + 3
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[e] = *reinterpret_cast<const uint32_t*>(pk + (4 * ch + e) * TBN + 4 * lane);
        w[e] ^= FORM == FORM_I8 ? 0x80808080u : 0x88888888u;  // + 128, or + 8 a nibble
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float v[4][4];  // [column j][row e]
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s[4];
          if (FORM == FORM_P4G) {
            if (row_scales && e > 0)
              scales4(p, kp * TBK + 4 * ch + e + h * rows, col0, s);
            else
#pragma unroll
              for (int j = 0; j < 4; ++j) s[j] = sc[i][h][j];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // the biased byte or nibble in the mantissa of 2^23, minus 2^23
            // and the bias: the weight, exact
            const uint32_t b = FORM == FORM_I8 ? (w[e] >> (8 * j)) & 0xFFu
                                               : (w[e] >> (8 * j + 4 * h)) & 0xFu;
            float f = __uint_as_float(0x4B000000u | b) -
                      (FORM == FORM_I8 ? 8388736.f : 8388616.f);
            if (FORM == FORM_P4G) f *= s[j];
            v[j][e] = f;
          }
        }
        unsigned char* const wt = stage[h] + T::X_TILE;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = b_row(4 * lane + j);
          *reinterpret_cast<float4*>(wt + r * ROW_BYTES + ((ch ^ (r & 7)) << 4)) =
              make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
        }
      }
    }

    fence_proxy_async();
#pragma unroll
    for (int h = 0; h < H; ++h) mbar_arrive(bars.full + 8 * ((H * kp + h) % T::STAGES));
  }
}

template <typename OUT> __device__ __forceinline__ OUT cast_out(float v);
template <> __device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 cast_out<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// A consumer warpgroup: rows 64 wg .. of the tile. For each stage its x
// values into registers as wgmma's A fragments, split there into x_hi =
// rna_tf32(x) and x_lo = rna_tf32(x - x_hi); 8 wgmma (k steps of 8, x_hi
// then x_lo, the weight from shared memory); the wgmma sum promoted into
// acc every PROMOTE_K values of k (both halves) and at the end; then the
// epilogue.
template <int NC, int FORM, typename OUT>
__device__ __forceinline__ void tf_consume(const TcParams& p, unsigned char* smem, int m_blk,
                                           int n_blk, int nkt) {
  using T = Tf<NC>;
  constexpr int PROMOTE = (FORM == FORM_I8 ? 1 : 2) * PROMOTE_K / TBK;  // stages; 0: never
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t base = smem_u32(smem);
  const TfBars<NC> bars(base);
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  // the thread's rows 64 wg + 16 warp + g and + 8 of the x tile (row % 8 = g)
  const int xrow = (64 * wg + 16 * warp + g) * ROW_BYTES + 4 * t;

  int fresh = 1;  // the next wgmma starts the partial sum
  for (int kt = 0; kt < nkt; ++kt) {
    const int slot = kt % T::STAGES;
    mbar_wait(bars.full + 8 * slot, (kt / T::STAGES) & 1);
    const unsigned char* xs = smem + slot * T::STAGE + xrow;
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // row + 8 (i & 1), column 8 kk + t + 4 (i >> 1)
        const float v = *reinterpret_cast<const float*>(
            xs + 8 * ROW_BYTES * (i & 1) + (((2 * kk + (i >> 1)) ^ g) << 4));
        hi[kk][i] = tf32_rna(v);
        lo[kk][i] = tf32_rna(v - __uint_as_float(hi[kk][i]));
      }
    const uint32_t b = base + slot * T::STAGE + T::X_TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32(part, hi[kk], sw128_desc(b + 32 * kk), !fresh || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tf32(part, lo[kk], sw128_desc(b + 32 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();  // the A registers are free again, the stage's slot too
    mbar_arrive(bars.empty + 8 * slot);
    fresh = kt + 1 == nkt || (PROMOTE > 0 && (kt + 1) % PROMOTE == 0);
    if (fresh) {
      fence_operands(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
  }

  // thread (warp w, g, t) holds rows 16 w + g and + 8 of its warpgroup's 64,
  // columns 32 t .. 32 t + 31: value o of a row is acc[4 (o / 2) + 2 h + o % 2]
  OUT* const y = static_cast<OUT*>(p.y);
  constexpr int V = 16 / sizeof(OUT);  // values per 16-byte store
#pragma unroll
  for (int k = 0; k < 2; ++k) {  // 16 columns at a time
    const int col0 = n_blk + 32 * t + 16 * k;
    float sc[16];
#pragma unroll
    for (int o = 0; o < 16; ++o)
      sc[o] = (FORM != FORM_P4G && col0 + o < p.N) ? __bfloat162float(p.s[col0 + o]) : 1.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m_blk + 64 * wg + 16 * warp + g + 8 * h;
      if (row >= p.M) continue;
      OUT* out = y + static_cast<long long>(row) * p.N + col0;
      __align__(16) OUT v[16];
#pragma unroll
      for (int o = 0; o < 16; ++o)
        v[o] = cast_out<OUT>(acc[32 * k + 4 * (o >> 1) + 2 * h + (o & 1)] * sc[o]);
#pragma unroll
      for (int i = 0; i < 16 / V; ++i) {
        if (p.yvec && col0 + (i + 1) * V <= p.N) {
          reinterpret_cast<uint4*>(out)[i] = reinterpret_cast<const uint4*>(v)[i];
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (col0 + i * V + e < p.N) out[i * V + e] = v[i * V + e];
        }
      }
    }
  }
}

template <int NC, int FORM, typename OUT>
__global__ void __launch_bounds__(Tf<NC>::THREADS, 1)
    tf32_wgmma(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap, const TcParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int m_blk = blockIdx.x * Tf<NC>::BM, n_blk = blockIdx.y * TBN;
  if (threadIdx.x == 0) {
    const TfBars<NC> bars(smem_u32(smem));
    for (int i = 0; i < Tf<NC>::STAGES; ++i) {
      mbar_init(bars.full + 8 * i, 129);  // the producer warpgroup's threads + the x copy
      mbar_init(bars.empty + 8 * i, 128 * NC);
    }
    for (int i = 0; i < P_SLOTS; ++i) mbar_init(bars.pfull + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int rows = FORM == FORM_I8 ? p.K : p.K / 2;
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) >= NC) {
    // with two consumer warpgroups (384 threads: 168 registers a thread at
    // launch) the producer gives registers to the consumers, which hold two
    // sums of 64 and 32 A-fragment registers: 72 + 2 x 216 = 3 x 168
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    tf_produce<NC, FORM>(&xmap, &wmap, p, smem, m_blk, n_blk);
    return;
  }
  if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
  tf_consume<NC, FORM, OUT>(p, smem, m_blk, n_blk,
                            (FORM == FORM_I8 ? 1 : 2) * ((rows + TBK - 1) / TBK));
}

// x [M, K] fp32 as [M][K] (int8) or [M][2][K/2] (packed: one map serves both
// halves); columns past the half and rows past M read as zero
int tf_x_map(CUtensorMap* map, const TcParams& p, int form, int bm) {
  const bool packed = form != FORM_I8;
  const cuuint64_t rows = static_cast<cuuint64_t>(packed ? p.K / 2 : p.K);
  const cuuint64_t dims[3] = {rows, static_cast<cuuint64_t>(packed ? 2 : p.M),
                              static_cast<cuuint64_t>(p.M)};
  const cuuint64_t strides[2] = {rows * 4, static_cast<cuuint64_t>(p.K) * 4};
  const cuuint32_t box[3] = {TBK, packed ? 1u : static_cast<cuuint32_t>(bm),
                             static_cast<cuuint32_t>(bm)};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode_tiled()(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, packed ? 3 : 2, const_cast<float*>(p.x), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// w [rows, N] bytes; rows past the end and columns past N read as zero
int tf_w_map(CUtensorMap* map, const TcParams& p, int form) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.N),
                              static_cast<cuuint64_t>(form == FORM_I8 ? p.K : p.K / 2)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.N)};
  const cuuint32_t box[2] = {TBN, TBK};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode_tiled()(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p.w), dims, strides, box,
      step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int NC, int FORM, typename OUT>
int launch_tf(const TcParams& p, cudaStream_t stream) {
  using T = Tf<NC>;
  const auto kernel = tf32_wgmma<NC, FORM, OUT>;
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  if ((p.xtma || p.wtma) && encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  int err = p.xtma ? tf_x_map(&xmap, p, FORM, T::BM) : 0;
  if (err == 0 && p.wtma) err = tf_w_map(&wmap, p, FORM);
  if (err != 0) return err;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.M + T::BM - 1) / T::BM, (p.N + TBN - 1) / TBN);  // M fastest: the blocks
  // in flight share a few column tiles of the weight
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(xmap, wmap, p);
  return static_cast<int>(cudaGetLastError());
}

template <int FORM, typename OUT>
int launch_tc(const TcParams& p, cudaStream_t stream) {
  return p.M <= 64 ? launch_tf<1, FORM, OUT>(p, stream) : launch_tf<2, FORM, OUT>(p, stream);
}

template <int FORM>
int launch(const TcParams& p, int out_f32, cudaStream_t stream) {
  return out_f32 ? launch_tc<FORM, float>(p, stream) : launch_tc<FORM, bf16>(p, stream);
}

}  // namespace

// x [M, K] fp32 (M > 8); w [K, N] int8 (form 0) or [K / 2, N] packed
// (forms 1, 2); s [N] (forms 0, 1) or [groups, N] (form 2) bf16; y [M, N]
// fp32 (out_f32) or bf16; all contiguous.
extern "C" int quant_matmul_f32_tiled(const float* x, const void* w, const void* s, void* y,
                                      int M, int K, int N, int form, int groups, int out_f32,
                                      void* stream) {
  if (M <= 8 || K < 1 || N < 1 || (form != FORM_I8 && K % 2) ||
      (form == FORM_P4G && (groups < 1 || K % groups)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = form == FORM_I8 ? K : K / 2;
  TcParams t;
  t.x = x; t.w = static_cast<const int8_t*>(w); t.s = static_cast<const bf16*>(s); t.y = y;
  t.M = M; t.K = K; t.N = N; t.groups = groups;
  t.xtma = (rows % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) ? 1 : 0;
  t.wtma = (N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) ? 1 : 0;
  t.yvec = (N % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0) ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == FORM_I8) return launch<FORM_I8>(t, out_f32, st);
  if (form == FORM_P4) return launch<FORM_P4>(t, out_f32, st);
  if (form == FORM_P4G) return launch<FORM_P4G>(t, out_f32, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
