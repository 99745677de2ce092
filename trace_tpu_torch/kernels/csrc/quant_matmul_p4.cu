// Nibble-packed int4 weight products for Hopper (sm_90a): bf16 x, packed
// int8 bytes qp [K/2, N], bf16 scales, bf16 or fp32 y, fp32 sums.
//
// Byte qp[k, n] holds weight rows k (low nibble) and k + K/2 (high nibble),
// each a 4-bit two's complement value. Two functions:
//   * per channel (s [N]):   y = (x[:, :K/2] @ lo + x[:, K/2:] @ hi) * s,
//     the nibbles exact, the scale applied once on the fp32 sum;
//   * grouped (s [G, N], K = 128 G, G even):  y = x @ W with
//     W[k, n] = bf16(nibble[k, n] * s[k / 128, n]); the rounding of the
//     scaled weight to bf16 is part of the function. bf16 x bf16 products are
//     exact in fp32, so only the order of the fp32 sum differs from the
//     plain version.
//
// Replaces quant_matmul_p4 (_qmm_p4_kernel) and quant_matmul_p4_grouped
// (_qmm_p4g_kernel) of trace_tpu/kernels/quant_matmul.py. The TPU kernels
// unpack with float arithmetic, get x pre-split into its two halves and
// everything padded to block multiples; here the nibbles come out of the
// 32-bit word with integer masks, the kernels index x at k and k + K/2
// themselves, and ragged M, N (and K, per channel) are predicated. The
// stacked entry points add the layer's offset to the weight and scale
// pointers, so layer li of a whole [L, K/2, N] leaf is read in place.
//
// Two forms, chosen on M by the entry point:
//   * M <= SMALL_M_MAX (a decode step): bound by bytes, K N / 2 of them
//     streamed once for all rows of x. The P4 (per channel) and P4G
//     (grouped) forms of qmm_split.cuh: one cluster launch per product with
//     no workspace (the ranks along the packed rows exchange partial sums
//     through distributed shared memory in rank order), long blocks in one
//     wave, a five-stage TMA ring of 16 KB stages that no block barrier
//     paces, and the products on the tensor cores (mma.sync m16n8k16): a
//     byte's two nibbles are one k pair of A, met in B by x[k] and
//     x[k + K/2], dequantized in bf16x2 arithmetic as the tensor-core form's
//     producers do (136 + nibble minus 136, exact; grouped, times the scale
//     pair, rounded once as the plain version's fp32 product rounded to
//     bf16). Tensor cores and not FMAs on fp32 values: about 4.4 lane
//     operations a packed byte (grouped) against ~12, which keeps the
//     arithmetic under the byte time. ptxas (CUDA 12.8, sm_90a): 67 (per
//     channel) and 90 (grouped) registers, no spills.
//   * larger M (prefill): bound by operations, 2 M K N of them (a 7B layer's
//     four products at M = 3886: 1.7 TFLOP, 1.7 ms at the card's bf16 peak).
//     Only wgmma reaches that rate, and the weight has to become bf16 on the
//     way, outside the warps that run it. A block computes a 128 x 128 tile
//     of y (64 x 128 for M <= 64, where a 128-row tile would be half empty)
//     with two (one) consumer warpgroups issuing wgmma.mma_async m64n128k16
//     (bf16 in, fp32 accumulate), A and B read from shared memory through
//     descriptors, and two producer warpgroups that run no wgmma. A packed
//     tile (64 packed rows x 128 columns) feeds two stages: its low nibbles
//     weigh x[:, k], its high nibbles x[:, k + K/2], for the same 64 values of
//     k. The producers take alternate packed tiles, each fetched by TMA into
//     the producer's own slot; for each tile a producer waits until its two
//     stages of a 6-stage ring are free, asks TMA for x's two tiles [BM x 64]
//     (one tensor map over x viewed as [M][2][K/2]: rows past M and columns
//     past K/2 read as zero), and dequantizes the packed tile into the
//     stages' two weight tiles, each byte once per block: bf16x2 arithmetic,
//     nibble | 0x4300 is the bf16 128 + nibble, minus 136 after the sign bit
//     is flipped, times the scale pair, each step exact or rounded once as
//     the plain version's fp32 product rounded to bf16. Full and empty
//     mbarriers hand the stages over; a consumer runs 4 wgmma a stage. The
//     weight tiles are stored transposed ([column][k], K-major, 128-byte
//     swizzle), their rows permuted so that a thread's 32 accumulator columns
//     are 32 neighbouring columns of y for the epilogue's 16-byte stores.
//     Shapes a tensor map cannot take (K/2 % 8, N % 16, unaligned pointers)
//     load the same tiles with predicated loads in the producers. The sums
//     run in a fixed order: a repeat gives the same bits.
//     What holds it at ~45 % of peak (PERF.md): shared-memory traffic (each
//     consumer reads the whole weight tile, and TMA and the producers write
//     every stage: ~690 cycles of the bus per 512 cycles of tensor work) and
//     the latency of the copies in flight. A 128 x 256 tile would cut both,
//     but its 128 accumulators a thread need more registers than 512 threads
//     can hold, and one producer warpgroup does not dequantize fast enough;
//     both roles fit the 128 registers a thread holds at launch, so no
//     setmaxnreg.
// fp32 x takes the fp32 instances of the split form up to 8 rows (the _f32
// entry points: x split into two TF32 parts, each k-step two m16n8k8 TF32
// products, the weight exact in TF32; grouped at any even G dividing K) and
// quant_matmul_f32.cu's tensor-core form beyond.

#include <string.h>

#include "hopper_common.cuh"
#include "qmm_split.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int SMALL_M_MAX = 8;   // rows up to which the split form runs

template <typename OUT> __device__ __forceinline__ OUT cast_out(float v);
template <> __device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 cast_out<bf16>(float v) {
  return __float2bfloat16(v);
}

// ---- tensor-core form ---------------------------------------------------
//
// A packed tile of 64 rows feeds two stages: its low nibbles weigh x[:, k]
// and its high nibbles x[:, k + K/2], for the same 64 values of k. A stage's
// operand tiles are [rows][64 bf16], 128-byte rows in the 128-byte swizzle
// (16-byte chunk c of row r at chunk c ^ (r % 8)), the layout TMA writes and
// wgmma reads through a K-major descriptor: x's tile [BM][64] of one half and
// the dequantized weight of that half stored transposed, [BN][64].

constexpr int BN = 128;               // columns of y per block
constexpr int BKP = 64;               // packed rows per packed tile: two stages
constexpr int ROW_BYTES = 128;        // bytes per row of an operand tile
constexpr int B_TILE = BN * ROW_BYTES;  // the dequantized weight of a stage: 16 KB
constexpr int P_TILE = BKP * BN;      // one packed tile: 8 KB
constexpr int PRODUCERS = 2;          // producer warpgroups: alternate packed tiles
constexpr int STAGES = 6;             // operand stages in flight

// NC consumer warpgroups of 64 rows each, then the producer warpgroups, each
// with one slot for its packed tile
template <int NC>
struct Tc {
  static constexpr int BM = 64 * NC;
  static constexpr int THREADS = 128 * (NC + PRODUCERS);
  static constexpr int X_TILE = BM * ROW_BYTES;
  static constexpr int STAGE = X_TILE + B_TILE;
  static constexpr int P_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = P_OFF + PRODUCERS * P_TILE;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + PRODUCERS) + 1024;  // + alignment
};
static_assert(Tc<2>::SMEM <= 232448, "shared memory");

struct TcParams {
  const bf16* x;
  const int8_t* qp;
  const bf16* s;
  void* y;
  int M, K, N;
  int xtma;  // x through its tensor map (K/2 % 8 == 0, 16-byte aligned), else loads
  int wtma;  // qp through its tensor map (N % 16 == 0, 16-byte aligned), else loads
  int yvec;  // N % 8 == 0 and y 16-byte aligned: 16-byte stores
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void producer_sync(int q) {  // producer warpgroup q alone
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + q) : "memory");
}

// d [64 x 128 of y, fp32] += A [64 x 16] * B [16 x 128], both from shared
// memory. Fragment of d (PTX ISA, wgmma .m64nNk16): with w the warp of the
// warpgroup, g = lane / 4 and t = lane % 4, d[4c + 2h + e] is row 16 w + g + 8 h,
// column 8 c + 2 t + e.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
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
      "%64, %65, p, 1, 1, 0, 0;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1));

}

// B row (column of the wgmma's N) of output column n of the tile: thread t
// of a quad then holds the 32 columns 32 t .. 32 t + 31 of y
__device__ __forceinline__ int b_row(int n) {
  return 8 * ((n & 31) >> 1) + 2 * (n >> 5) + (n & 1);
}

template <int NC>
struct Bars {  // addresses of the barriers in shared memory
  uint32_t full, empty, pfull;
  __device__ explicit Bars(uint32_t base)
      : full(base + Tc<NC>::BAR_OFF), empty(full + 8 * STAGES), pfull(empty + 8 * STAGES) {}
};

// Producer warpgroup q: packed tiles q, q + 2, .. into its slot (TMA, or
// loads for shapes a tensor map cannot take); for each, x's two tiles into
// the tile's two stages (the same) and the low and the high nibbles,
// dequantized, beside them.
template <int NC, bool GROUPED>
__device__ __forceinline__ void p4_produce(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                           const TcParams& p, unsigned char* smem,
                                           int m_blk, int n_blk) {
  using T = Tc<NC>;
  const int Kh = p.K / 2;
  const int q = threadIdx.x / 128 - NC;
  const int pt = threadIdx.x % 128, pw = pt / 32, lane = pt % 32;
  const Bars<NC> bars(smem_u32(smem));
  const uint32_t pbar = bars.pfull + 8 * q;
  unsigned char* const pk = smem + T::P_OFF + q * P_TILE;

  auto load_packed = [&](int kp) {
    if (p.wtma) {
      if (pt == 0) {
        fence_proxy_async();
        mbar_arrive_tx(pbar, P_TILE);
        tma_load_2d(smem_u32(pk), wmap, pbar, n_blk, kp * BKP);
      }
      return;
    }
    for (int i = pt; i < P_TILE / 4; i += 128) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const int row = kp * BKP + r;
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = n_blk + c + b;
        if (row < Kh && col < p.N)
          word |= static_cast<uint32_t>(static_cast<uint8_t>(
                      p.qp[static_cast<long long>(row) * p.N + col])) << (8 * b);
      }
      *reinterpret_cast<uint32_t*>(pk + r * BN + c) = word;
    }
  };

  const int nkp = (Kh + BKP - 1) / BKP;
  if (q < nkp) load_packed(q);

  // the thread's 4 columns 4 lane .. + 3, and 2 of the 8 row groups (of 8
  // rows) of the packed tile, turning with the lane so that the 16-byte
  // stores of the 8 lanes of a store phase land in 8 distinct chunks
  const int c4 = lane;
  const int rg0 = lane + 2 * pw;
  const __nv_bfloat162 bias = as_bf162(0x43084308u);  // 136 = 128 + 8, twice
  __nv_bfloat162 slo[4], shi[4];  // GROUPED: the scales of the thread's columns, doubled
  for (int kp = q, use = 0; kp < nkp; kp += PRODUCERS, ++use) {
    unsigned char* stage[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // stage 2 kp + h takes half h of x
      const int st = 2 * kp + h, slot = st % STAGES;
      mbar_wait(bars.empty + 8 * slot, ((st / STAGES) & 1) ^ 1);
      stage[h] = smem + slot * T::STAGE;
      if (p.xtma) {
        if (pt == 0) {
          mbar_arrive_tx(bars.full + 8 * slot, T::X_TILE);
          tma_load_3d(smem_u32(stage[h]), xmap, bars.full + 8 * slot, kp * BKP, h, m_blk);
        }
      } else {
        for (int i = pt; i < T::BM * 8; i += 128) {
          const int r = i / 8, ch = i % 8;
          const int row = m_blk + r, col = kp * BKP + ch * 8;
          const bf16* src = p.x + static_cast<long long>(row) * p.K + h * Kh + col;
          __align__(16) bf16 v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = (row < p.M && col + e < Kh) ? src[e] : __float2bfloat16(0.f);
          *reinterpret_cast<uint4*>(stage[h] + r * ROW_BYTES + ((ch ^ (r & 7)) << 4)) =
              *reinterpret_cast<const uint4*>(v);
        }
        if (pt == 0) mbar_arrive(bars.full + 8 * slot);  // in place of the copy's arrival
      }
    }

    if (GROUPED) {  // rows 64 kp ..: group kp / 2; the high half's is K / 256 further
      const bf16* rlo = p.s + static_cast<long long>(kp >> 1) * p.N;
      const bf16* rhi = p.s + static_cast<long long>((kp >> 1) + (p.K >> 8)) * p.N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n_blk + 4 * c4 + j;
        const bool ok = col < p.N;
        slo[j] = __bfloat162bfloat162(ok ? rlo[col] : __float2bfloat16(0.f));
        shi[j] = __bfloat162bfloat162(ok ? rhi[col] : __float2bfloat16(0.f));
      }
    }

    if (p.wtma)
      mbar_wait(pbar, use & 1);
    else
      producer_sync(q);  // the warpgroup's loads of the packed tile are in
    unsigned char* const blo = stage[0] + T::X_TILE;
    unsigned char* const bhi = stage[1] + T::X_TILE;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int rg = (rg0 + it) & 7;
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = ld32(pk + (8 * rg + i) * BN + 4 * c4) ^ 0x88888888u;  // nibble + 8
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          // byte j of rows 2 pp and 2 pp + 1: nibble | 0x4300 is the bf16
          // 128 + nibble, minus 136 the weight (exact); times the scale pair,
          // rounded once as the plain version's fp32 product rounded to bf16
          const uint32_t sel = __byte_perm(w[2 * pp], w[2 * pp + 1], 0x4400 + 0x1111 * j);
          __nv_bfloat162 l = __hsub2(as_bf162((sel & 0x000F000Fu) | 0x43004300u), bias);
          __nv_bfloat162 h = __hsub2(as_bf162(((sel >> 4) & 0x000F000Fu) | 0x43004300u), bias);
          if (GROUPED) {
            l = __hmul2(l, slo[j]);
            h = __hmul2(h, shi[j]);
          }
          lo[pp] = as_u32(l);
          hi[pp] = as_u32(h);
        }
        const int r = b_row(4 * c4 + j);
        const int off = r * ROW_BYTES + ((rg ^ (r & 7)) << 4);
        *reinterpret_cast<uint4*>(blo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(bhi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
    fence_proxy_async();
    mbar_arrive(bars.full + 8 * ((2 * kp) % STAGES));
    mbar_arrive(bars.full + 8 * ((2 * kp + 1) % STAGES));
    producer_sync(q);  // every thread is done with the packed slot: refill it
    if (kp + PRODUCERS < nkp) load_packed(kp + PRODUCERS);
  }
}

// A consumer warpgroup: rows 64 wg .. of the tile, 4 wgmma a stage (k steps
// of 16), then the epilogue.
template <int NC, bool GROUPED, typename OUT>
__device__ __forceinline__ void p4_consume(const TcParams& p, unsigned char* smem, int m_blk,
                                           int n_blk, int nkt) {
  using T = Tc<NC>;
  const int wg = threadIdx.x / 128;
  const uint32_t base = smem_u32(smem);
  const Bars<NC> bars(base);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {  // stage kt: packed tile kt / 2, x's half kt % 2
    const int slot = kt % STAGES;
    mbar_wait(bars.full + 8 * slot, (kt / STAGES) & 1);
    const uint32_t st = base + slot * T::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_128(acc, sw128_desc(st + wg * 64 * ROW_BYTES + 32 * kk),
                sw128_desc(st + T::X_TILE + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release its slot
    if (kt > 0) mbar_arrive(bars.empty + 8 * ((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // thread (warp w, g, t) holds rows 16 w + g and + 8 of its warpgroup's 64,
  // columns 32 t .. 32 t + 31: value o of a row is acc[4 (o / 2) + 2 h + o % 2]
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  OUT* const y = static_cast<OUT*>(p.y);
  constexpr int V = 16 / sizeof(OUT);  // values per 16-byte store
#pragma unroll
  for (int k = 0; k < 2; ++k) {  // 16 columns at a time
    const int col0 = n_blk + 32 * t + 16 * k;
    float sc[16];
#pragma unroll
    for (int o = 0; o < 16; ++o)
      sc[o] = (!GROUPED && col0 + o < p.N) ? __bfloat162float(p.s[col0 + o]) : 1.f;
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

template <int NC, bool GROUPED, typename OUT>
__global__ void __launch_bounds__(Tc<NC>::THREADS, 1)
    p4_wgmma(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wmap, const TcParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int m_blk = blockIdx.x * Tc<NC>::BM, n_blk = blockIdx.y * BN;
  if (threadIdx.x == 0) {
    const Bars<NC> bars(smem_u32(smem));
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bars.full + 8 * i, 129);  // a producer warpgroup's 128 threads + the x copy
      mbar_init(bars.empty + 8 * i, 128 * NC);
    }
    for (int i = 0; i < PRODUCERS; ++i) mbar_init(bars.pfull + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 128 * NC)
    p4_produce<NC, GROUPED>(&xmap, &wmap, p, smem, m_blk, n_blk);
  else
    p4_consume<NC, GROUPED, OUT>(p, smem, m_blk, n_blk, 2 * ((p.K / 2 + BKP - 1) / BKP));
}

// x [M, K] as [M][2][K/2]: one map serves both halves, and columns past K/2
// and rows past M read as zero
int x_map(CUtensorMap* map, const TcParams& p, int bm) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.K / 2), 2,
                              static_cast<cuuint64_t>(p.M)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(p.K / 2) * 2,
                                 static_cast<cuuint64_t>(p.K) * 2};
  const cuuint32_t box[3] = {64, 1, static_cast<cuuint32_t>(bm)};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode_tiled()(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(p.x), dims, strides, box,
      step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// qp [K/2, N] bytes; rows past K/2 and columns past N read as zero (weight 0)
int w_map(CUtensorMap* map, const TcParams& p) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.N), static_cast<cuuint64_t>(p.K / 2)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.N)};
  const cuuint32_t box[2] = {BN, BKP};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode_tiled()(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p.qp), dims, strides, box,
      step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int NC, bool GROUPED, typename OUT>
int launch_wgmma(const TcParams& p, cudaStream_t stream) {
  using T = Tc<NC>;
  const auto kernel = p4_wgmma<NC, GROUPED, OUT>;
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  if ((p.xtma || p.wtma) && encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  int err = p.xtma ? x_map(&xmap, p, T::BM) : 0;
  if (err == 0 && p.wtma) err = w_map(&wmap, p);
  if (err != 0) return err;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.M + T::BM - 1) / T::BM, (p.N + BN - 1) / BN);  // M fastest: the blocks
  // in flight share a few column tiles of the weight
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(xmap, wmap, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool GROUPED, typename OUT>
int launch_tc(const TcParams& p, cudaStream_t stream) {
  return p.M <= 64 ? launch_wgmma<1, GROUPED, OUT>(p, stream)
                   : launch_wgmma<2, GROUPED, OUT>(p, stream);
}

template <bool GROUPED>
int run(const void* x, const int8_t* qp, const bf16* s, void* y, int M, int K, int N,
        int cluster, int share, int out_f32, cudaStream_t stream) {
  if (M < 1 || K < 2 || K % 2 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (GROUPED && K % 256) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  if (M <= SMALL_M_MAX) {
    qsplit::Params p = {};
    p.x = xb; p.w = qp; p.s = s; p.y = y;
    p.M = M; p.K = K; p.N = N; p.rows = K / 2; p.groups = K / 128; p.out_f32 = out_f32;
    return qsplit::launch<GROUPED ? qsplit::Form::P4G : qsplit::Form::P4>(p, cluster, share,
                                                                         stream);
  }
  TcParams p;
  p.x = xb; p.qp = qp; p.s = s; p.y = y;
  p.M = M; p.K = K; p.N = N;
  p.xtma = ((K / 2) % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) ? 1 : 0;
  p.wtma = (N % 16 == 0 && reinterpret_cast<uintptr_t>(qp) % 16 == 0) ? 1 : 0;
  p.yvec = (N % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0) ? 1 : 0;
  return out_f32 ? launch_tc<GROUPED, float>(p, stream) : launch_tc<GROUPED, bf16>(p, stream);
}

// fp32 x, M <= SMALL_M_MAX: the fp32 instance of the split form (grouped:
// G groups, even and dividing K). Larger M takes quant_matmul_f32.cu.
template <bool GROUPED>
int run_f32(const void* x, const int8_t* qp, const bf16* s, int G, void* y, int M, int K,
            int N, int cluster, int share, int out_f32, cudaStream_t stream) {
  if (M < 1 || M > SMALL_M_MAX || K < 2 || K % 2 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  qsplit::Params p = {};
  p.x = x; p.w = qp; p.s = s; p.y = y;
  p.M = M; p.K = K; p.N = N; p.rows = K / 2; p.groups = G; p.out_f32 = out_f32;
  return qsplit::launch<GROUPED ? qsplit::Form::P4G : qsplit::Form::P4, 8, float>(
      p, cluster, share, stream);
}

}  // namespace

// M <= SMALL_M_MAX (8) takes the split form: one cluster launch, clusters of
// `cluster` blocks along the K / 2 packed rows, each rank taking `share` of
// them (a multiple of 8; cluster * share >= K / 2). Larger M takes the
// tensor-core form and reads neither. Only y is written.

// Clusters of `cluster` blocks of the split form that run at once, or a
// negative CUDA error.
extern "C" int quant_matmul_p4_clusters_at_once(int grouped, int cluster) {
  return grouped ? qsplit::clusters_at_once<qsplit::Form::P4G>(cluster)
                 : qsplit::clusters_at_once<qsplit::Form::P4>(cluster);
}

// per channel: qp [K/2, N], s [N]
extern "C" int quant_matmul_p4_bf16(const void* x, const void* qp, const void* s, void* y,
                                    int M, int K, int N, int cluster, int share,
                                    int out_f32, void* stream) {
  return run<false>(x, static_cast<const int8_t*>(qp), static_cast<const bf16*>(s), y, M, K,
                    N, cluster, share, out_f32, static_cast<cudaStream_t>(stream));
}

// grouped: qp [K/2, N], s [K / 128, N]
extern "C" int quant_matmul_p4_grouped_bf16(const void* x, const void* qp, const void* s,
                                            void* y, int M, int K, int N, int cluster,
                                            int share, int out_f32, void* stream) {
  return run<true>(x, static_cast<const int8_t*>(qp), static_cast<const bf16*>(s), y, M, K,
                   N, cluster, share, out_f32, static_cast<cudaStream_t>(stream));
}

// qp [L, K/2, N] and s [L, N] or [L, K / 128, N] whole; layer li is read in place
extern "C" int quant_matmul_p4_stacked_bf16(const void* x, const void* qp, const void* s,
                                            int li, int L, void* y, int M, int K, int N,
                                            int cluster, int share, int out_f32,
                                            void* stream) {
  if (li < 0 || li >= L) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* ql = static_cast<const int8_t*>(qp) + static_cast<long long>(li) * (K / 2) * N;
  const bf16* sl = static_cast<const bf16*>(s) + static_cast<long long>(li) * N;
  return run<false>(x, ql, sl, y, M, K, N, cluster, share, out_f32,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int quant_matmul_p4_grouped_stacked_bf16(const void* x, const void* qp,
                                                    const void* s, int li, int L, void* y,
                                                    int M, int K, int N, int cluster,
                                                    int share, int out_f32, void* stream) {
  if (li < 0 || li >= L) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* ql = static_cast<const int8_t*>(qp) + static_cast<long long>(li) * (K / 2) * N;
  const bf16* sl = static_cast<const bf16*>(s) + static_cast<long long>(li) * (K / 128) * N;
  return run<true>(x, ql, sl, y, M, K, N, cluster, share, out_f32,
                   static_cast<cudaStream_t>(stream));
}

// fp32 x: the fp32 instances of the split form, M <= 8 (shares a multiple
// of 8 packed rows); grouped ones take s [G, N], G even and dividing K.
extern "C" int quant_matmul_p4_f32_clusters_at_once(int grouped, int cluster) {
  return grouped ? qsplit::clusters_at_once<qsplit::Form::P4G, 8, float>(cluster)
                 : qsplit::clusters_at_once<qsplit::Form::P4, 8, float>(cluster);
}

extern "C" int quant_matmul_p4_f32(const void* x, const void* qp, const void* s, void* y, int M,
                                   int K, int N, int cluster, int share, int out_f32,
                                   void* stream) {
  return run_f32<false>(x, static_cast<const int8_t*>(qp), static_cast<const bf16*>(s), 1, y,
                        M, K, N, cluster, share, out_f32, static_cast<cudaStream_t>(stream));
}

extern "C" int quant_matmul_p4_grouped_f32(const void* x, const void* qp, const void* s, int G,
                                           void* y, int M, int K, int N, int cluster,
                                           int share, int out_f32, void* stream) {
  return run_f32<true>(x, static_cast<const int8_t*>(qp), static_cast<const bf16*>(s), G, y,
                       M, K, N, cluster, share, out_f32, static_cast<cudaStream_t>(stream));
}

// qp [L, K/2, N] and s [L, N] or [L, G, N] whole; layer li is read in place
extern "C" int quant_matmul_p4_stacked_f32(const void* x, const void* qp, const void* s, int li,
                                           int L, void* y, int M, int K, int N, int cluster,
                                           int share, int out_f32, void* stream) {
  if (li < 0 || li >= L) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* ql = static_cast<const int8_t*>(qp) + static_cast<long long>(li) * (K / 2) * N;
  const bf16* sl = static_cast<const bf16*>(s) + static_cast<long long>(li) * N;
  return run_f32<false>(x, ql, sl, 1, y, M, K, N, cluster, share, out_f32,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int quant_matmul_p4_grouped_stacked_f32(const void* x, const void* qp, const void* s,
                                                   int li, int L, int G, void* y, int M, int K,
                                                   int N, int cluster, int share, int out_f32,
                                                   void* stream) {
  if (li < 0 || li >= L || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* ql = static_cast<const int8_t*>(qp) + static_cast<long long>(li) * (K / 2) * N;
  const bf16* sl = static_cast<const bf16*>(s) + static_cast<long long>(li) * G * N;
  return run_f32<true>(x, ql, sl, G, y, M, K, N, cluster, share, out_f32,
                       static_cast<cudaStream_t>(stream));
}
