// Attention backward in fp32 on Hopper's tensor cores: the fp32 form of
// attention_bwd.cu, for training an fp32 model. From the forward's residuals
// o and lse (attention_f32.cu),
//
//     p = exp(s - lse)        delta = rowsum(do * o)
//     dv = p^T do             ds = p * (do v^T - delta)
//     dq = ds k * scale       dk = ds^T q * scale
//
// with dk and dv summed over the G query heads of a kv head. Replaces, in
// fp32, trace_tpu/kernels/flash_backward.py flash_attention_bwd: _dq_kernel
// and _dkv_kernel (with the group sum after them), which compute in the
// operand's dtype. Three launches: attn_bwd_delta_f32_kernel (a warp a
// query row), then the dq and the dk/dv kernels below.
//
// Products: every fp32 product a b is three TF32 wgmma products, a_hi b_hi +
// a_hi b_lo + a_lo b_hi, with v_hi = rna_tf32(v), v_lo = rna_tf32(v - v_hi)
// (split); the dropped a_lo b_lo is ~2^-22 of a b. wgmma m64n32k8 .tf32,
// fp32 accumulators. Bound on an H100: operations, three times each product
// at the 495 TFLOP/s TF32 peak (at the training shape, B 2, 32 / 8 heads, T
// 2048, hd 128, causal, one row padded by 300: dq 3 x 89.1 GFLOP, 0.540 ms;
// dk/dv 3 x 118.8, 0.720 ms).
//
// Design. TF32 wgmma reads no MN-major operand from shared memory, and its B
// operand comes only from shared memory, K-major. So every product is written
// with the operand that would need a transpose as A, which a consumer thread
// gathers from a plain (unsplit) tile in shared memory into its registers, in
// any order, and splits there; B operands are written once as hi and lo
// tiles. (The other way, a transposed hi and lo copy of each streamed tile
// written by a producer, needs twice the ring and puts the split in the
// producer, which set the pace of the first design of quant_matmul_f32.cu's
// tensor-core form: PERF.md.)
//   * dq: a block owns NB = 32 query rows of one (head, batch row), whose Q
//     and dO stay in shared memory split into hi and lo B tiles [row][hd],
//     and streams tiles of MT = 64 keys of K and V as plain fp32. Per tile:
//     S^T = K Q^T and dP^T = V dO^T (M = 64 keys, N = 32 rows, A = K or V
//     gathered row-wise), then dQ^T += K^T dS^T (M = hd, N = rows, A = K
//     gathered column-wise, B = ds written [row][key] as hi and lo).
//   * dk/dv: a block owns NB = 32 keys of one (kv head, batch row), whose K
//     and V stay as hi and lo B tiles [key][hd], and streams tiles of MT = 64
//     query rows of Q and dO over the G query heads of the kv head, one after
//     the other in a fixed order. Per tile: S = Q K^T and dP = dO V^T (M = 64
//     rows, N = 32 keys), then dV^T += dO^T P and dK^T += Q^T dS (M = hd,
//     N = keys, A = dO or Q gathered column-wise, B = p and ds written
//     [key][row] as hi and lo).
// The A-fragment layout (a thread: columns t and t + 4 of rows g and g + 8)
// is not the accumulator's (columns 2t, 2t + 1), so no accumulator is fed
// back as A: p and ds go through shared memory as B tiles, and the gathers
// take their fragments in a permuted order that makes each pair of a
// thread's values neighbours, one 8-byte load: row-wise the contraction's 8
// columns of a k step in the order 0, 2, 4, 6, 1, 3, 5, 7 (the resident B
// tiles are written in the same order), column-wise the output's rows
// (out_col).
// A block has three warpgroups: a producer that copies the streamed tiles
// with cp.async (zero-filled past the tensor) into a ring of STAGES stages
// (full and empty mbarriers), and two consumers, one per product of the
// first pair: consumer 0 forms S (S^T) and p, consumer 1 dP (dP^T) and ds,
// p reaching it through shared memory (dq: an exchange buffer; dk/dv: the
// hi + lo of the p B tile, within 2^-23 of p). Then dq's consumers each add
// half the tile's keys into their own dQ^T (the two summed in a fixed order
// at the end), and dk/dv's consumer 0 adds dV^T, consumer 1 dK^T. Named
// barriers hand p and ds between the two. A product's A fragments go in
// batches of 8 (64 registers split, 24 wgmma), each waited for.
//
// Shared memory a block (bytes; hd 128 / 64): 4 resident B tiles of 32 rows
// (hi, lo of two operands) 64 K / 32 K; 4 per-tile B tiles [32][64] (p, ds hi
// and lo; dq: ds hi, lo and the p exchange) 32 K; the ring, a stage two
// plain [64][hd] tiles, 2 x 64 K / 4 x 32 K; 1 K of barriers and alignment:
// 225 K / 193 K of the 227 K. The B tiles are [hd / 32 or 2 boxes][32 rows]
// [128 bytes] in the 128-byte swizzle (16-byte chunk c of row r at c ^ (r %
// 8)); a plain tile is [64 rows][hd] with 16-byte chunk c of row r at c ^
// sw(r) within each 128 bytes, sw(r) = 2 (r % 4) + (r / 4) % 2, so that the
// row-wise and the column-wise gathers of a warp both meet 32 banks.
//
// Registers: a consumer thread holds its first product's accumulator (16),
// the output's (hd / 2) and a tile's partial of it (hd / 2), and a batch of
// 8 A fragments split (64); ptxas fits both kernels in 168 registers a
// thread without spilling; at run time setmaxnreg gives a consumer thread
// 224 and a producer thread 56.
//
// Sums: the tensor cores add into an accumulator truncating, so the output's
// products of a tile run into a fresh partial, which is then added into the
// output with round-to-nearest fp32 adds (without, dk/dv at the training
// shape leaves its limits: PERF.md). Nothing is atomic and every
// sum runs in a fixed order: a call repeats bit for bit.
//
// What sets the pace (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W): the
// consumers' CUDA-core work, not
// the tensor cores. With every wgmma taken out the kernels keep 83-88 % of
// their time: the gathers and splits of the A fragments (the split alone
// 13-17 %; cvt.rna.tf32.f32 in its place, a quarter-rate conversion, took
// 19-31 % more in all), forming p and ds and writing their B tiles, the
// handovers between the consumers, with three warps a scheduler to hide it.
//
// Causal key tiles past a block's last row (dq) and query tiles before a
// block's first key (dk/dv) are skipped; a row that sees no key (lse = -1e30)
// then differs from the plain version, which visits every key, unless its do
// is zero, as it is in training (padding carries no label): the same rule as
// the bf16 form.

#include "attention_common.cuh"

namespace {

constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int NB = 32;    // rows a block owns: query rows (dq), keys (dk/dv); N of every product
constexpr int MT = 64;    // rows of a streamed tile: keys (dq), query rows (dk/dv)
constexpr int BOX = NB * 128;  // a 32-column box of a B tile
constexpr float MASKED = NEG_INF * LOG2E;  // a masked score in log2 units (see attention_bwd.cu)

// named barriers besides 0 (__syncthreads)
constexpr int BAR_CONSUMERS = 1;   // both consumer warpgroups (256 threads)
constexpr int BAR_P = 2;           // p is written (consumer 0 arrives, consumer 1 waits)
constexpr int BAR_P_READ = 3;      // dk/dv: p is read (consumer 1 arrives, consumer 0 waits)
constexpr int BAR_WG = 4;          // + wg: one consumer warpgroup (128 threads)

struct Params {
  const float *q, *k, *v, *bias, *d_o, *lse, *delta;
  float *dq, *dk, *dv;
  int H, group, tq, tk, causal;
  float scale, scale_log2;
};

template <int HD>
struct Cfg {
  static constexpr int STAGES = HD == 128 ? 2 : 4;
  static constexpr int BT = NB * HD * 4;   // a resident B tile, hi or lo
  static constexpr int PT = NB * MT * 4;   // a per-tile B tile
  static constexpr int RAW = MT * HD * 4;  // a plain streamed tile
  static constexpr int PT_OFF = 4 * BT;
  static constexpr int STAGE_OFF = PT_OFF + 4 * PT;
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * 2 * RAW;
  static constexpr int SMEM = BAR_OFF + 16 * STAGES + 1024;  // + alignment
};
static_assert(Cfg<128>::SMEM <= 232448 && Cfg<64>::SMEM <= 232448, "shared memory");

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}

// one arrival on bar once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// byte offset of element (n, k) in a B tile: box k / 32, row n, 16-byte chunk
// (k % 32) / 4 swizzled by n % 8
__device__ __forceinline__ int b_off(int n, int k) {
  return (k >> 5) * BOX + n * 128 + ((((k & 31) >> 2) ^ (n & 7)) << 4) + (k & 3) * 4;
}

// float offset of element (r, c) in a plain [rows][HD] tile
template <int HD>
__device__ __forceinline__ int raw_off(int r, int c) {
  const int sw = ((r & 3) << 1) | ((r >> 2) & 1);
  return r * HD + ((((c >> 2) & 7) ^ sw) << 2) + (c & ~31) + (c & 3);
}

// an fp32 bit pattern rounded to TF32, to nearest with ties away from zero,
// its low 13 bits zero (a TF32 wgmma ignores them, truncating): for finite
// values what cvt.rna.tf32.f32 gives, in two integer operations where that
// conversion runs at a quarter of their rate
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo to within 2^-22 of v: hi = rna_tf32(v), lo = rna_tf32(v - hi)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(__float_as_uint(v));
  lo = rna_tf32(__float_as_uint(v - __uint_as_float(hi)));
}

// element (n, k) of a B tile pair (hi at base, lo at base + lo_off) from v
__device__ __forceinline__ void put_split(unsigned char* base, int lo_off, int n, int k, float v) {
  uint32_t hi, lo;
  split(v, hi, lo);
  const int o = b_off(n, k);
  *reinterpret_cast<uint32_t*>(base + o) = hi;
  *reinterpret_cast<uint32_t*>(base + lo_off + o) = lo;
}

// d [64 x 32] (+)= A [64 x 8] B [8 x 32], TF32; A from registers (a thread of
// warp w holds rows 16 w + g and + 8, columns t and t + 4, g = lane / 4,
// t = lane % 4: a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8,
// t + 4)), B K-major from shared memory; d[4 j + 2 h + e] is row 16 w + g +
// 8 h, column 8 j + 2 t + e. accumulate = 0 starts the sum.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d[mc] [64 x 32] (+)= A_mc [64 x 8 KSTEPS] B [8 KSTEPS x 32] in three TF32
// products: frag(mc, kk, v) gathers the thread's four fp32 values of A_mc's
// k step kk, split here; B's hi and lo tiles at b_hi and b_lo (k step kk at
// box kk / 4, 32 bytes a step within it). Batches of up to 8 A fragments
// (64 registers), each waited for. The first product starts the sum.
template <int MC, int KSTEPS, typename Frag>
__device__ __forceinline__ void tf32x3(float (&d)[MC][16], Frag frag, uint32_t b_hi,
                                       uint32_t b_lo) {
  constexpr int BATCH = 8 / MC < KSTEPS ? 8 / MC : KSTEPS;
  static_assert(KSTEPS % BATCH == 0, "k steps");
#pragma unroll
  for (int k0 = 0; k0 < KSTEPS; k0 += BATCH) {
    uint32_t hi[BATCH][MC][4], lo[BATCH][MC][4];
#pragma unroll
    for (int kk = 0; kk < BATCH; ++kk)
#pragma unroll
      for (int mc = 0; mc < MC; ++mc) {
        float v[4];
        frag(mc, k0 + kk, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(v[i], hi[kk][mc][i], lo[kk][mc][i]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BATCH; ++kk) {
      const int k = k0 + kk;
      const uint32_t off = (k >> 2) * BOX + (k & 3) * 32;
#pragma unroll
      for (int mc = 0; mc < MC; ++mc) {
        wgmma_n32(d[mc], hi[kk][mc], sw128_desc(b_hi + off), k > 0);
        wgmma_n32(d[mc], hi[kk][mc], sw128_desc(b_lo + off), 1);
        wgmma_n32(d[mc], lo[kk][mc], sw128_desc(b_hi + off), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();  // the A registers are free again
  }
#pragma unroll
  for (int mc = 0; mc < MC; ++mc) fence_operands(d[mc]);
}

// a tile's partial of an output added into its sum, rounding to nearest
template <int MC>
__device__ __forceinline__ void promote(float (&acc)[MC][16], const float (&part)[MC][16]) {
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[mc][i] += part[mc][i];
}

// A fragment of rows r0.. (M) of a plain tile X, its k step the columns c0 ..
// c0 + 7 in the order c0, c0 + 2, c0 + 4, c0 + 6, c0 + 1, ..., c0 + 7 (K
// position j at column c0 + 2 (j % 4) + j / 4, as load_resident orders the B
// tiles these products meet): a thread's K positions t and t + 4 are
// neighbouring columns, one 8-byte load
template <int HD>
__device__ __forceinline__ void gather_rows(const float* x, int r0, int c0, int g, int t,
                                            float (&v)[4]) {
  const float2 a = *reinterpret_cast<const float2*>(x + raw_off<HD>(r0 + g, c0 + 2 * t));
  const float2 b = *reinterpret_cast<const float2*>(x + raw_off<HD>(r0 + g + 8, c0 + 2 * t));
  v[0] = a.x;
  v[1] = b.x;
  v[2] = a.y;
  v[3] = b.y;
}

// A fragment of X^T: K its rows r0.., M its columns c0 .. c0 + 15, M position
// m at column c0 + 2 (m % 8) + m / 8 (a thread's M positions g and g + 8 are
// neighbouring columns, one 8-byte load; the output's rows follow: out_col)
template <int HD>
__device__ __forceinline__ void gather_cols(const float* x, int r0, int c0, int g, int t,
                                            float (&v)[4]) {
  const float2 a = *reinterpret_cast<const float2*>(x + raw_off<HD>(r0 + t, c0 + 2 * g));
  const float2 b = *reinterpret_cast<const float2*>(x + raw_off<HD>(r0 + t + 4, c0 + 2 * g));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// the column of hd that row 16 warp + g + 8 h of a warpgroup's m64 chunk mc
// of an output gathered by gather_cols (dQ^T, dV^T, dK^T) stands for
__device__ __forceinline__ int out_col(int mc, int warp, int g, int h) {
  return 64 * mc + 16 * warp + 2 * g + h;
}

template <int HD>
struct Bars {
  uint32_t full, empty;  // stage 0's, 8 bytes a stage
  __device__ explicit Bars(uint32_t base)
      : full(base + Cfg<HD>::BAR_OFF), empty(full + 8 * Cfg<HD>::STAGES) {}
};

// thread 0: a stage is full after the producer warpgroup's 128 cp.async
// arrivals, empty after every consumer thread's arrival
template <int HD>
__device__ __forceinline__ unsigned char* block_start(unsigned char* smem_raw) {
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    const Bars<HD> bar(smem_u32(smem));
    for (int i = 0; i < Cfg<HD>::STAGES; ++i) {
      mbar_init(bar.full + 8 * i, 128);
      mbar_init(bar.empty + 8 * i, 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return smem;
}

// The producer warpgroup: for step it = 0 .. total - 1 the two plain tiles of
// MT rows (rows src_row(it) .. of x and y, zero past `rows`) into stage
// it % STAGES
template <int HD, typename Src>
__device__ __forceinline__ void produce(unsigned char* smem, int total, int rows, Src src) {
  using C = Cfg<HD>;
  const Bars<HD> bar(smem_u32(smem));
  const int pt = threadIdx.x - 128 * CONSUMERS;
  constexpr int CH = HD / 4;  // 16-byte chunks a row
  for (int it = 0; it < total; ++it) {
    const int slot = it % C::STAGES;
    if (it >= C::STAGES) mbar_wait(bar.empty + 8 * slot, ((it / C::STAGES) - 1) & 1);
    const float *x, *y;
    int r0;
    src(it, x, y, r0);
    const uint32_t dst = smem_u32(smem + C::STAGE_OFF + slot * 2 * C::RAW);
    for (int i = pt; i < 2 * MT * CH; i += 128) {
      const int which = i / (MT * CH), r = (i / CH) % MT, c = 4 * (i % CH);
      const bool in = r0 + r < rows;
      const float* s = (which ? y : x) + static_cast<long long>(in ? r0 + r : 0) * HD + c;
      cp_async16(dst + which * C::RAW + 4 * raw_off<HD>(r, c), s, in);
    }
    cp_async_arrive(bar.full + 8 * slot);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows r0 .. r0 + NB - 1 of x and y ([rows][HD], zero past `rows`) split into
// the resident B tiles x hi, x lo, y hi, y lo, each k step of 8 columns in
// gather_rows' order; by both consumer warpgroups
template <int HD>
__device__ __forceinline__ void load_resident(unsigned char* smem, const float* x, const float* y,
                                              int r0, int rows) {
  using C = Cfg<HD>;
  constexpr int C8 = HD / 8;
  for (int i = threadIdx.x; i < 2 * NB * C8; i += 128 * CONSUMERS) {
    const int which = i / (NB * C8), n = (i / C8) % NB, c = 8 * (i % C8);
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f), w = u;
    if (r0 + n < rows) {
      const float* src = (which ? y : x) + static_cast<long long>(r0 + n) * HD + c;
      u = *reinterpret_cast<const float4*>(src);
      w = *reinterpret_cast<const float4*>(src + 4);
    }
    const float e[8] = {u.x, u.z, w.x, w.z, u.y, u.w, w.y, w.w};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint4 hi, lo;
      split(e[4 * half], hi.x, lo.x);
      split(e[4 * half + 1], hi.y, lo.y);
      split(e[4 * half + 2], hi.z, lo.z);
      split(e[4 * half + 3], hi.w, lo.w);
      unsigned char* base = smem + which * 2 * C::BT + b_off(n, c + 4 * half);
      *reinterpret_cast<uint4*>(base) = hi;
      *reinterpret_cast<uint4*>(base + C::BT) = lo;
    }
  }
  fence_proxy_async();
  named_sync(BAR_CONSUMERS, 128 * CONSUMERS);
}

// ---------------------------------------------------------------- dq

template <int HD>
__device__ __forceinline__ void dq_consume(const Params& p, unsigned char* smem, int h, int b,
                                           int q0, int ntiles) {
  using C = Cfg<HD>;
  constexpr int MC = HD / 64;
  const uint32_t base = smem_u32(smem);
  const Bars<HD> bar(base);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long qrow = (static_cast<long long>(b) * p.H + h) * p.tq;
  const float* const bias = p.bias ? p.bias + static_cast<long long>(b) * p.tk : nullptr;
  load_resident<HD>(smem, p.q + qrow * HD, p.d_o + qrow * HD, q0, p.tq);

  // the thread's query rows (columns of S^T): q0 + 8 j + 2 t + e at 2 j + e;
  // consumer 0 their lse (log2 units, +inf past Tq: p = 0), consumer 1 delta
  float stat[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + 8 * (i / 2) + 2 * t + i % 2;
    stat[i] = wg == 0 ? (row < p.tq ? __fmul_rn(p.lse[qrow + row], LOG2E) : INFINITY)
                      : (row < p.tq ? p.delta[qrow + row] : 0.f);
  }
  unsigned char* const ds_tile = smem + C::PT_OFF;  // ds [row][key]: hi, lo at + PT
  float* const px = reinterpret_cast<float*>(smem + C::PT_OFF + 2 * C::PT);  // p, [16][128]
  float acc[MC][16], part[MC][16];
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[mc][i] = part[mc][i] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int slot = j % C::STAGES, k0 = j * MT;
    mbar_wait(bar.full + 8 * slot, (j / C::STAGES) & 1);
    const float* const ks = reinterpret_cast<const float*>(smem + C::STAGE_OFF + slot * 2 * C::RAW);
    float s[1][16];
    if (wg == 0) {
      float bk[2];  // the bias of the thread's keys 16 warp + g (+ 8), log2 units; -inf past Tk
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int key = k0 + 16 * warp + g + 8 * hh;
        bk[hh] = key >= p.tk ? -INFINITY : bias ? __fmul_rn(bias[key], LOG2E) : 0.f;
      }
      // S^T = K Q^T
      tf32x3<1, HD / 8>(s, [&](int, int kk, float (&v)[4]) {
        gather_rows<HD>(ks, 16 * warp, 8 * kk, g, t, v);
      }, base, base + C::BT);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int hh = (i / 2) % 2, c = 2 * (i / 4) + i % 2;
        const int key = k0 + 16 * warp + g + 8 * hh, row = q0 + 8 * (i / 4) + 2 * t + i % 2;
        float x = fmaf(s[0][i], p.scale_log2, bk[hh]);
        if (p.causal && key > row) x = MASKED;
        px[i * 128 + tid] = ex2(x - stat[c]);
      }
      named_arrive(BAR_P, 256);
      named_sync(BAR_CONSUMERS, 256);  // ds is written
    } else {
      // dP^T = V dO^T
      tf32x3<1, HD / 8>(s, [&](int, int kk, float (&v)[4]) {
        gather_rows<HD>(ks + MT * HD, 16 * warp, 8 * kk, g, t, v);
      }, base + 2 * C::BT, base + 3 * C::BT);
      named_sync(BAR_P, 256);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int hh = (i / 2) % 2, c = 2 * (i / 4) + i % 2;
        const float ds = px[i * 128 + tid] * (s[0][i] - stat[c]);
        put_split(ds_tile, C::PT, 8 * (i / 4) + 2 * t + i % 2, 16 * warp + g + 8 * hh, ds);
      }
      fence_proxy_async();
      named_sync(BAR_CONSUMERS, 256);
    }
    // dQ^T += K^T dS^T over the warpgroup's 32 keys of the tile
    tf32x3<MC, 4>(part, [&](int mc, int kk, float (&v)[4]) {
      gather_cols<HD>(ks, 32 * wg + 8 * kk, 64 * mc + 16 * warp, g, t, v);
    }, base + C::PT_OFF + wg * BOX, base + C::PT_OFF + C::PT + wg * BOX);
    mbar_arrive(bar.empty + 8 * slot);
    promote<MC>(acc, part);
  }

  // consumer 1's sum through shared memory (the resident tiles, read by no
  // product any more), consumer 0 adds it to its own and writes dq
  float* const other = reinterpret_cast<float*>(smem);
  if (wg == 1) {
#pragma unroll
    for (int mc = 0; mc < MC; ++mc)
#pragma unroll
      for (int i = 0; i < 16; ++i) other[(16 * mc + i) * 128 + tid] = acc[mc][i];
  }
  named_sync(BAR_CONSUMERS, 256);
  if (wg == 1) return;
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = q0 + 8 * (i / 4) + 2 * t + i % 2;
      const int d = out_col(mc, warp, g, (i / 2) % 2);
      if (row < p.tq)
        p.dq[(qrow + row) * HD + d] = (acc[mc][i] + other[(16 * mc + i) * 128 + tid]) * p.scale;
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1) attn_bwd_dq_f32_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = block_start<HD>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  // causal row blocks longest first: the last sees the most keys
  const int q0 = (p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * NB;
  const int k_end = p.causal ? min(p.tk, q0 + NB) : p.tk;
  const int ntiles = (k_end + MT - 1) / MT;
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const long long kbase = (static_cast<long long>(b) * (p.H / p.group) + h / p.group) * p.tk;
    produce<HD>(smem, ntiles, p.tk, [&](int it, const float*& x, const float*& y, int& r0) {
      x = p.k + kbase * HD;
      y = p.v + kbase * HD;
      r0 = it * MT;
    });
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  dq_consume<HD>(p, smem, h, b, q0, ntiles);
}

// ---------------------------------------------------------------- dk, dv

template <int HD>
__device__ __forceinline__ void dkv_consume(const Params& p, unsigned char* smem, int kvh, int b,
                                            int k0, int qt_start, int nqt, int total) {
  using C = Cfg<HD>;
  constexpr int MC = HD / 64;
  const uint32_t base = smem_u32(smem);
  const Bars<HD> bar(base);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long kbase = (static_cast<long long>(b) * (p.H / p.group) + kvh) * p.tk;
  load_resident<HD>(smem, p.k + kbase * HD, p.v + kbase * HD, k0, p.tk);

  // the bias of the thread's keys (columns of S): k0 + 8 j + 2 t + e at 2 j +
  // e, log2 units; -inf past Tk (p = 0)
  float bk[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + 8 * (i / 2) + 2 * t + i % 2;
    bk[i] = key >= p.tk ? -INFINITY
            : p.bias ? __fmul_rn(p.bias[static_cast<long long>(b) * p.tk + key], LOG2E) : 0.f;
  }
  unsigned char* const pt_tile = smem + C::PT_OFF;  // p [key][row]: hi, lo at + PT
  unsigned char* const dt_tile = pt_tile + 2 * C::PT;  // ds [key][row]: hi, lo
  float acc[MC][16], part[MC][16];
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[mc][i] = part[mc][i] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int slot = it % C::STAGES;
    const int hq = kvh * p.group + it / nqt, q0 = (qt_start + it % nqt) * MT;
    const long long qrow = (static_cast<long long>(b) * p.H + hq) * p.tq;
    float stat[2];  // the thread's rows 16 warp + g (+ 8): consumer 0 lse (log2
    // units, +inf past Tq: p = 0), consumer 1 delta
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + 16 * warp + g + 8 * hh;
      stat[hh] = wg == 0 ? (row < p.tq ? __fmul_rn(p.lse[qrow + row], LOG2E) : INFINITY)
                         : (row < p.tq ? p.delta[qrow + row] : 0.f);
    }
    mbar_wait(bar.full + 8 * slot, (it / C::STAGES) & 1);
    const float* const qs = reinterpret_cast<const float*>(smem + C::STAGE_OFF + slot * 2 * C::RAW);
    const float* const dos = qs + MT * HD;
    float s[1][16];
    if (wg == 0) {
      // S = Q K^T
      tf32x3<1, HD / 8>(s, [&](int, int kk, float (&v)[4]) {
        gather_rows<HD>(qs, 16 * warp, 8 * kk, g, t, v);
      }, base, base + C::BT);
      if (it > 0) named_sync(BAR_P_READ, 256);  // consumer 1 has read the last tile's p
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int hh = (i / 2) % 2, c = 2 * (i / 4) + i % 2;
        const int row = q0 + 16 * warp + g + 8 * hh, key = k0 + 8 * (i / 4) + 2 * t + i % 2;
        float x = fmaf(s[0][i], p.scale_log2, bk[c]);
        if (p.causal && key > row) x = MASKED;
        put_split(pt_tile, C::PT, key - k0, row - q0, ex2(x - stat[hh]));
      }
      fence_proxy_async();
      named_arrive(BAR_P, 256);
      named_sync(BAR_WG + wg, 128);
      // dV^T += dO^T P
      tf32x3<MC, MT / 8>(part, [&](int mc, int kk, float (&v)[4]) {
        gather_cols<HD>(dos, 8 * kk, 64 * mc + 16 * warp, g, t, v);
      }, base + C::PT_OFF, base + C::PT_OFF + C::PT);
    } else {
      // dP = dO V^T
      tf32x3<1, HD / 8>(s, [&](int, int kk, float (&v)[4]) {
        gather_rows<HD>(dos, 16 * warp, 8 * kk, g, t, v);
      }, base + 2 * C::BT, base + 3 * C::BT);
      named_sync(BAR_P, 256);
      float ds[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int o = b_off(8 * (i / 4) + 2 * t + i % 2, 16 * warp + g + 8 * ((i / 2) % 2));
        const float pr = *reinterpret_cast<const float*>(pt_tile + o) +
                         *reinterpret_cast<const float*>(pt_tile + C::PT + o);
        ds[i] = pr * (s[0][i] - stat[(i / 2) % 2]);
      }
      named_arrive(BAR_P_READ, 256);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        put_split(dt_tile, C::PT, 8 * (i / 4) + 2 * t + i % 2, 16 * warp + g + 8 * ((i / 2) % 2),
                  ds[i]);
      fence_proxy_async();
      named_sync(BAR_WG + wg, 128);
      // dK^T += Q^T dS
      tf32x3<MC, MT / 8>(part, [&](int mc, int kk, float (&v)[4]) {
        gather_cols<HD>(qs, 8 * kk, 64 * mc + 16 * warp, g, t, v);
      }, base + C::PT_OFF + 2 * C::PT, base + C::PT_OFF + 3 * C::PT);
    }
    mbar_arrive(bar.empty + 8 * slot);
    promote<MC>(acc, part);
  }
  if (wg == 0 && total > 0) named_sync(BAR_P_READ, 256);  // consumer 1's last arrival

  // consumer 0 writes dv, consumer 1 dk: dV^T / dK^T element (out_col(mc,
  // warp, g, h), key k0 + 8 j + 2 t + e) at acc[mc][4 j + 2 h + e]
  float* const out = wg == 0 ? p.dv : p.dk;
  const float scale = wg == 0 ? 1.f : p.scale;
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = k0 + 8 * (i / 4) + 2 * t + i % 2;
      const int d = out_col(mc, warp, g, (i / 2) % 2);
      if (key < p.tk) out[(kbase + key) * HD + d] = acc[mc][i] * scale;
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1) attn_bwd_dkv_f32_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = block_start<HD>(smem_raw);
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * NB;  // causal: key block 0 sees the most rows and goes first
  // causal: query tiles whose last row lies before the block's first key see none of its keys
  const int qt_start = p.causal ? k0 / MT : 0;
  const int nqt = (p.tq + MT - 1) / MT - qt_start;
  const int total = nqt > 0 ? p.group * nqt : 0;
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    produce<HD>(smem, total, p.tq, [&](int it, const float*& x, const float*& y, int& r0) {
      const long long qrow =
          (static_cast<long long>(b) * p.H + kvh * p.group + it / nqt) * p.tq;
      x = p.q + qrow * HD;
      y = p.d_o + qrow * HD;
      r0 = (qt_start + it % nqt) * MT;
    });
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  dkv_consume<HD>(p, smem, kvh, b, k0, qt_start, nqt, total);
}

__global__ void attn_bwd_delta_f32_kernel(const float* o, const float* d_o, float* delta,
                                          long long rows, int hd) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s = fmaf(o[row * hd + d], d_o[row * hd + d], s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) delta[row] = s;
}

Params make_params(const float* q, const float* k, const float* v, const float* bias,
                   const float* d_o, const float* lse, const float* delta, int H, int group,
                   int tq, int tk, int causal, float scale) {
  Params p = {q, k, v, bias, d_o, lse, delta, nullptr, nullptr, nullptr,
              H, group, tq, tk, causal, scale, scale * LOG2E};
  return p;
}

bool bad_shape(int B, int H, int group, int tq, int tk) {
  return B < 1 || H < 1 || group < 1 || H % group || tq < 1 || tk < 1;
}

template <int HD, bool DQ>
int launch(const Params& p, int B, cudaStream_t stream) {
  const auto kernel = DQ ? attn_bwd_dq_f32_kernel<HD> : attn_bwd_dkv_f32_kernel<HD>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<HD>::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid = DQ ? dim3(p.H, B, (p.tq + NB - 1) / NB)
                       : dim3(p.H / p.group, B, (p.tk + NB - 1) / NB);
  kernel<<<grid, THREADS, Cfg<HD>::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool DQ>
int launch_hd(const Params& p, int B, int hd, cudaStream_t stream) {
  if (hd == 128) return launch<128, DQ>(p, B, stream);
  if (hd == 64) return launch<64, DQ>(p, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// delta [rows] = rowsum(do * o) over rows of hd contiguous fp32 values
extern "C" int attn_bwd_delta_f32(const float* o, const float* d_o, float* delta,
                                  long long rows, int hd, void* stream) {
  if (rows < 1 || hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((rows + 7) / 8);
  attn_bwd_delta_f32_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d_o, delta, rows, hd);
  return static_cast<int>(cudaGetLastError());
}

// q, do [B, H, Tq, hd], k, v [B, H / group, Tk, hd], lse, delta [B, H, Tq],
// bias [B, Tk] or null: contiguous fp32, 16-byte aligned; dq [B, H, Tq, hd]
extern "C" int attn_bwd_dq_f32(const float* q, const float* k, const float* v,
                               const float* bias, const float* d_o, const float* lse,
                               const float* delta, float* dq, int B, int H, int group, int tq,
                               int tk, int hd, int causal, float scale, void* stream) {
  if (bad_shape(B, H, group, tq, tk)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, bias, d_o, lse, delta, H, group, tq, tk, causal, scale);
  p.dq = dq;
  return launch_hd<true>(p, B, hd, static_cast<cudaStream_t>(stream));
}

// the same operands; dk, dv [B, H / group, Tk, hd], summed over the group
extern "C" int attn_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                const float* bias, const float* d_o, const float* lse,
                                const float* delta, float* dk, float* dv, int B, int H,
                                int group, int tq, int tk, int hd, int causal, float scale,
                                void* stream) {
  if (bad_shape(B, H, group, tq, tk)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, bias, d_o, lse, delta, H, group, tq, tk, causal, scale);
  p.dk = dk;
  p.dv = dv;
  return launch_hd<false>(p, B, hd, static_cast<cudaStream_t>(stream));
}
