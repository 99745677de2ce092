// Attention forward in fp32 on Hopper's tensor cores (sm_90a): fp32 in, fp32
// out, fp32 softmax statistics and accumulators. The fp32 form of
// attention.cu, for a model served or trained in fp32
// (``model_init(dtype=torch.float32)``, an fp32 TraceConfig); the wrappers of
// kernels/flash_attention.py and kernels/flash_backward.py choose it by
// dtype.
//
// One kernel serves the fp32 forms of three TPU kernels, as attention.cu
// does for bf16:
//   * flash_attention (_attn_kernel) of trace_tpu/kernels/flash_attention.py:
//     causal GQA attention over [B, H, T, hd] with an additive fp32 [B, Tk]
//     bias; with a query offset (chunked prefill: query row r sits at
//     position q_offset + r and sees the keys j <= q_offset + r);
//   * vit_attention_btd (_btd_kernel), same file: bidirectional, read and
//     written through (batch, head, token) element strides, so that q, k and
//     v may be column slices of the fused [B, P, 3D] projection; keys >=
//     kv_len masked;
//   * flash_attention_fwd_res (_fwd_res_kernel) of
//     trace_tpu/kernels/flash_backward.py: with an ``lse`` pointer also each
//     query row's natural-log logsumexp, which attention_bwd_f32.cu reads.
//
// Products: the Pallas kernels compute in the operand's dtype, fp32 here.
// Every fp32 product a b runs as three TF32 wgmma products, a_hi b_hi + a_hi
// b_lo + a_lo b_hi, with v_hi = rna_tf32(v), v_lo = rna_tf32(v - v_hi) (the
// split of attention_bwd_f32.cu, in two integer operations); the dropped
// a_lo b_lo is ~2^-22 of a b. Bound on an H100: operations, three times each
// product at the 495 TFLOP/s TF32 peak (the prefill shape's two products of
// ~29.7 GFLOP over the visible causal pairs: 0.360 ms; at the fp32 CUDA-core
// peak of 67 TFLOP/s the same pairs take 0.887 ms).
//
// Design: PR 6's forward skeleton (attention.cu) with every operand the
// tensor cores read from shared memory split into hi and lo tiles. A block
// owns 128 query rows of one (head, batch row) and has three warpgroups.
//   * The producer warpgroup streams tiles of 64 keys: it reads K and V rows
//     from device memory (zero past Tk) into registers, groups of rows at a
//     time with every load of a group issued before any is used, after
//     asking the next tile's rows into L2; splits them there and writes four
//     B tiles into a stage of the ring: K hi and lo as [key][hd] and V^T hi
//     and lo as [hd][key], the transpose that O += P V needs (TF32 wgmma reads
//     B only from shared memory and only K-major). A stage is 128 KB at hd
//     128 (one stage beside Q's 64 KB) and 64 KB at hd 64 (three). Its K half
//     and its V half have full and empty mbarriers of their own, so that at
//     hd 128 the producer writes the next tile's K while the consumers still
//     read this tile's V: one stage works as two. (Tried and slower, PERF.md:
//     a cp.async staging ring of one plain half-tile, which fits at hd 128;
//     32-key tiles in two stages at hd 128.)
//   * Two consumer warpgroups of 64 query rows each. Q stays plain in shared
//     memory; per tile, S = Q K^T takes Q's A fragments gathered from it
//     (one 8-byte load for a thread's two values of a k step) and split in
//     registers, in batches of 8 k steps (64 registers, 24 wgmma m64n64k8),
//     each waited for. Then the online softmax on the S accumulator (scores
//     prescaled by scale * log2(e), ex2, the row max over the quad), and
//     O += P V with P from registers: the S accumulator holds columns 2t and
//     2t + 1 of a k step where a TF32 A fragment wants t and t + 4, so the
//     contraction runs over each 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7,
//     the order in which the producer writes V^T's keys (and K's hd columns,
//     for Q's gather). P is split in batches of 4 (hd 128) or 8 k steps.
//   * Sums: a tile's P V runs into a fresh accumulator, then O = O * alpha +
//     partial by round-to-nearest fp32 FMA (the tensor cores add truncating;
//     without the promotion the backward's dk/dv left its limits at T = 2048,
//     PERF.md PR 23). A consumer thread holds O (hd / 2), the partial (hd / 2),
//     S (32) and a batch of split fragments; setmaxnreg moves registers from
//     the producer warpgroup (56 at hd 128, 72 at hd 64) to the consumers
//     (224, 216).
//   * Causal blocks are issued longest first, key tiles past a warpgroup's
//     last row are skipped, and a warpgroup whose rows lie past Tq does no
//     work (it still passes every barrier of the ring).
// What sets the pace (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W): not the
// tensor cores, and no one side alone. At the prefill shape (0.94 ms) the
// kernel keeps 88 % of its time with every wgmma taken out, 86 % with the
// consumers only passing the ring's barriers (the producer alone: its reads
// wait on L2 or device memory, and with one stage at hd 128 each half of the
// ring waits for the consumers), and 90 % without the producer's loads and
// splits (the consumers alone: Q's gathers and splits, the softmax, P's
// splits, a wait after each batch of 24 or 12 wgmma).
// Masks use the finite -1e30 of the JAX package; keys past Tk weigh 0. A
// query row that sees no key gets the mean of v over the Tk keys, as the
// plain version gives it (its softmax is uniform over scores that are all
// -1e30): unseen_rows_f32_kernel, a second launch where there is a bias,
// writes it, as attention.cu does for bf16. Nothing is atomic and every sum
// runs in a fixed order: a call repeats bit for bit.

#include "attention_common.cuh"

namespace {

constexpr int BQ = 128;         // query rows of a block
constexpr int CONSUMERS = 2;    // consumer warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int BK = 64;          // keys of a tile
constexpr float M_INIT = -1e38f;  // running-max start, below any masked score
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const float *q, *k, *v, *bias;  // bias: [B, Tk] additive, or null
  float* o;
  float* lse;  // [B, H, Tq] or null
  int H, group, tq, tk, kv_len, causal, q_offset;
  float scale_log2;  // hd^-0.5 * log2(e)
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot, sbias;
};

template <int HD>
struct Cfg {
  static constexpr int STAGES = HD == 128 ? 1 : 3;
  static constexpr int KT = BK * HD * 4;       // one B tile: K or V^T, hi or lo
  static constexpr int STAGE = 4 * KT;         // K hi, K lo, V^T hi, V^T lo
  static constexpr int Q_OFF = STAGES * STAGE;  // Q, plain: [BQ][HD] (raw_off)
  static constexpr int BAR_OFF = Q_OFF + BQ * HD * 4;
  static constexpr int SMEM = BAR_OFF + 32 * STAGES + 1024;  // + alignment
  static constexpr int KBOX = BK * 128;  // a K tile's box of 32 hd columns
  static constexpr int VBOX = HD * 128;  // a V^T tile's box of 32 keys
  // k steps of P split at a time (registers)
  static constexpr int PV_BATCH = HD == 128 ? 4 : 8;
};
static_assert(Cfg<128>::SMEM <= 232448 && Cfg<64>::SMEM <= 232448, "shared memory");

// a stage's barriers, 8 bytes each: K full, V full, K empty, V empty
struct Bars {
  uint32_t kfull, vfull, kempty, vempty;
  __device__ Bars(uint32_t bar_base, int slot)
      : kfull(bar_base + 32 * slot), vfull(kfull + 8), kempty(kfull + 16), vempty(kfull + 24) {}
};

// an fp32 bit pattern rounded to TF32, to nearest with ties away from zero,
// its low 13 bits zero (attention_bwd_f32.cu's rounding: what
// cvt.rna.tf32.f32 gives for finite values, in two integer operations)
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo to within 2^-22 of v
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(__float_as_uint(v));
  lo = rna_tf32(__float_as_uint(v - __uint_as_float(hi)));
}

// four values split into a hi and a lo 16-byte chunk
__device__ __forceinline__ void split4(float a, float b, float c, float d, uint4& hi, uint4& lo) {
  split(a, hi.x, lo.x);
  split(b, hi.y, lo.y);
  split(c, hi.z, lo.z);
  split(d, hi.w, lo.w);
}

// element i of v (i a constant after unrolling)
__device__ __forceinline__ float elem(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// float offset of element (r, c) in a plain [rows][HD] tile: 16-byte chunk c
// of row r at c ^ sw(r) within each 128 bytes, sw(r) = 2 (r % 4) + (r / 4) %
// 2, so that a warp's row-wise gather (8 rows x 32 bytes) meets 32 banks
template <int HD>
__device__ __forceinline__ int raw_off(int r, int c) {
  const int sw = ((r & 3) << 1) | ((r >> 2) & 1);
  return r * HD + ((((c >> 2) & 7) ^ sw) << 2) + (c & ~31) + (c & 3);
}

// d [64 x 64] (+)= A [64 x 8] B [8 x 64], TF32: A from registers (a thread of
// warp w holds rows 16 w + g and + 8, columns t and t + 4, g = lane / 4,
// t = lane % 4: a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8,
// t + 4)), B K-major from shared memory; d[4 j + 2 h + e] is row 16 w + g +
// 8 h, column 8 j + 2 t + e. accumulate = 0 starts the sum.
__device__ __forceinline__ void tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// the same with B [8 x 128]
__device__ __forceinline__ void tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
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
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int N> struct Tf32;
template <> struct Tf32<64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    tf32_rs_n64(d, a, b, acc);
  }
};
template <> struct Tf32<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    tf32_rs_n128(d, a, b, acc);
  }
};

// d [64 x N] = A [64 x 8 KSTEPS] B [8 KSTEPS x N] in three TF32 products:
// frag(kk, v) gives the thread's four fp32 values of A's k step kk, split
// here; B's hi and lo tiles at b_hi and b_lo, k step kk at box kk / 4 (BOX
// bytes apart), 32 bytes a step within it. Batches of BATCH k steps, each
// waited for (the A registers are free again).
template <int N, int KSTEPS, int BATCH, int BOX, typename Frag>
__device__ __forceinline__ void tf32x3(float (&d)[N / 2], Frag frag, uint32_t b_hi,
                                       uint32_t b_lo) {
  static_assert(KSTEPS % BATCH == 0, "k steps");
#pragma unroll
  for (int k0 = 0; k0 < KSTEPS; k0 += BATCH) {
    uint32_t hi[BATCH][4], lo[BATCH][4];
#pragma unroll
    for (int kk = 0; kk < BATCH; ++kk) {
      float v[4];
      frag(k0 + kk, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) split(v[i], hi[kk][i], lo[kk][i]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BATCH; ++kk) {
      const int k = k0 + kk;
      const uint32_t off = (k >> 2) * BOX + (k & 3) * 32;
      Tf32<N>::rs(d, hi[kk], sw128_desc(b_hi + off), k > 0);
      Tf32<N>::rs(d, hi[kk], sw128_desc(b_lo + off), 1);
      Tf32<N>::rs(d, lo[kk], sw128_desc(b_hi + off), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_operands(d);
}

// ---------------------------------------------------------------- producer

// Tile j's K rows k0 .. k0 + BK - 1 (zero past Tk) split into K hi / lo B
// tiles [key][hd], each 8 hd columns in the order 0, 2, 4, 6, 1, 3, 5, 7 (Q's
// gather meets them so). Item i: key i / (HD / 8), columns 8 (i % (HD / 8))
// ..: neighbouring threads read neighbouring 32 bytes of a row. Of the 8
// threads of a quarter warp, the 4 in the odd 32-column box write their
// second 16-byte chunk first, so that the quarter warp's 8 chunks are
// distinct banks. A thread's items go in groups of 4, each group's loads
// issued before any of them is used (the reads wait on L2 or device memory).
template <int HD>
__device__ __forceinline__ void put_k(unsigned char* st, const Params& p, const float* kg, int k0,
                                      int pt) {
  using C = Cfg<HD>;
  constexpr int U = 4, C8 = HD / 8;
  static_assert((BK * C8) % (128 * U) == 0, "items");
#pragma unroll 1
  for (int i0 = pt; i0 < BK * C8; i0 += 128 * U) {
    float4 u[U], w[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int i = i0 + 128 * q, n = i / C8, c = 8 * (i % C8);
      u[q] = w[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + n < p.tk) {
        const float* src = kg + static_cast<long long>(k0 + n) * p.skt + c;
        u[q] = __ldg(reinterpret_cast<const float4*>(src));
        w[q] = __ldg(reinterpret_cast<const float4*>(src + 4));
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int i = i0 + 128 * q, n = i / C8, c = 8 * (i % C8);
      const int swap = (c >> 5) & 1;
      // byte offset of (key n, column c + 4 half): box c / 32, 16-byte chunk
      // (c % 32) / 4 + half swizzled by n % 8; half = h ^ swap
      const int off = (c >> 5) * C::KBOX + n * 128;
      const int ch = (c & 31) >> 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool odd = h ^ swap;  // the columns c + 1, c + 3, c + 5, c + 7
        uint4 hi, lo;
        split4(odd ? u[q].y : u[q].x, odd ? u[q].w : u[q].z, odd ? w[q].y : w[q].x,
               odd ? w[q].w : w[q].z, hi, lo);
        const int o = off + (((ch + odd) ^ (n & 7)) << 4);
        *reinterpret_cast<uint4*>(st + o) = hi;
        *reinterpret_cast<uint4*>(st + C::KT + o) = lo;
      }
    }
  }
}

// Tile j's V rows split into V^T hi / lo B tiles [hd][key], each 8 keys in
// the order 0, 2, 4, 6, 1, 3, 5, 7 (P's fragments meet them so: positions 0-3
// the even keys, 4-7 the odd). Item i: key group i % 8 (8 keys), columns
// 4 (i / 8) ..: the item's 8 rows x 16 bytes are loaded at once, then per
// half (the even or the odd keys) and column the hd row's 16-byte chunk of
// those positions is written. The 8 threads of a quarter warp hold the 8
// groups of one column; groups 4-7 take the odd half first, so that the
// quarter warp's 8 chunks are distinct banks.
template <int HD>
__device__ __forceinline__ void put_v(unsigned char* st, const Params& p, const float* vg, int k0,
                                      int pt) {
  using C = Cfg<HD>;
  unsigned char* const vt = st + 2 * C::KT;
#pragma unroll 1
  for (int i = pt; i < (BK / 8) * (HD / 4); i += 128) {
    const int grp = i % (BK / 8), c = 4 * (i / (BK / 8));
    const int swap = grp >> 2;
    float4 r[8];  // r[2 m + hs]: key 8 grp + 2 m + (hs ^ swap)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int key = k0 + 8 * grp + (e ^ swap);
      r[e] = key < p.tk
                 ? __ldg(reinterpret_cast<const float4*>(vg + static_cast<long long>(key) * p.svt + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int box = (grp >> 2) * C::VBOX;
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
      const int half = hs ^ swap;  // positions 4 half ..: the keys 2 m + half
      const int chunk = 2 * (grp & 3) + half;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int n = c + cc;
        uint4 hi, lo;
        split4(elem(r[hs], cc), elem(r[2 + hs], cc), elem(r[4 + hs], cc), elem(r[6 + hs], cc),
               hi, lo);
        const int off = box + n * 128 + ((chunk ^ (n & 7)) << 4);
        *reinterpret_cast<uint4*>(vt + off) = hi;
        *reinterpret_cast<uint4*>(vt + C::KT + off) = lo;
      }
    }
  }
}

// tile j's K and V rows (those below Tk) asked into L2 ahead of their reads
template <int HD>
__device__ __forceinline__ void prefetch_l2(const Params& p, const float* kg, const float* vg,
                                            int k0, int pt) {
  constexpr int LINES = HD / 32;  // 128-byte lines a row
  for (int i = pt; i < 2 * BK * LINES; i += 128) {
    const int key = k0 + (i / LINES) % BK, line = i % LINES;
    if (key >= p.tk) continue;
    const float* src = i < BK * LINES ? kg + static_cast<long long>(key) * p.skt
                                      : vg + static_cast<long long>(key) * p.svt;
    asm volatile("prefetch.global.L2 [%0];\n" :: "l"(src + 32 * line));
  }
}

template <int HD>
__device__ __forceinline__ void produce(const Params& p, unsigned char* smem, int kvh, int b,
                                        int ntiles) {
  using C = Cfg<HD>;
  const uint32_t bar_base = smem_u32(smem) + C::BAR_OFF;
  const int pt = threadIdx.x - 128 * CONSUMERS;
  const float* const kg = p.k + b * p.skb + kvh * p.skh;
  const float* const vg = p.v + b * p.svb + kvh * p.svh;
  for (int j = 0; j < ntiles; ++j) {
    const int slot = j % C::STAGES;
    const Bars bar(bar_base, slot);
    const uint32_t parity = ((j / C::STAGES) - 1) & 1;
    unsigned char* const st = smem + slot * C::STAGE;
    if (j + 1 < ntiles) prefetch_l2<HD>(p, kg, vg, (j + 1) * BK, pt);
    if (j >= C::STAGES) mbar_wait(bar.kempty, parity);
    put_k<HD>(st, p, kg, j * BK, pt);
    fence_proxy_async();  // the stores, seen by the consumers' wgmma
    mbar_arrive(bar.kfull);
    if (j >= C::STAGES) mbar_wait(bar.vempty, parity);
    put_v<HD>(st, p, vg, j * BK, pt);
    fence_proxy_async();
    mbar_arrive(bar.vfull);
  }
}

// ---------------------------------------------------------------- consumers

// The bias of the thread's keys of a tile, log2 units (loaded while the
// tile's S product runs)
__device__ __forceinline__ void load_bias(float (&bl)[BK / 4], const Params& p, const float* bias,
                                          int k0, int t) {
  if (!bias) return;
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) {
    const int jj = k0 + 8 * (i / 2) + 2 * t + (i % 2);
    bl[i] = jj < p.tk ? bias[jj] * LOG2E : 0.f;
  }
}

// The online softmax of one S tile in registers (attention.cu's): scale (log2
// units), bias, masks, the running max and the thread's share of the row
// sums; s becomes the unnormalized probabilities, alpha the factor O must be
// rescaled by. EDGE and BIAS are template arguments so that each form is one
// straight block of code. lim: the keys j < lim[hh] that row hh may see.
template <bool EDGE, bool BIAS>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const float (&bl)[BK / 4],
                                             const Params& p, int k0, const int (&lim)[2],
                                             int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx[4] = {M_INIT, M_INIT, M_INIT, M_INIT};
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = BIAS ? fmaf(s[4 * c + 2 * hh + e], p.scale_log2, bl[2 * c + e])
                       : s[4 * c + 2 * hh + e] * p.scale_log2;
        if (EDGE) {
          const int jj = k0 + 8 * c + 2 * t + e;
          x = jj < lim[hh] ? x : NEG_INF;
          x = jj < p.tk ? x : -INFINITY;  // no such key: weight 0, not in the max
        }
        s[4 * c + 2 * hh + e] = x;
        mx[(2 * c + e) % 4] = fmaxf(mx[(2 * c + e) % 4], x);
      }
    }
    float mr = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    const float m_new = fmaxf(m[hh], mr);
    alpha[hh] = ex2(m[hh] - m_new);
    m[hh] = m_new;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = ex2(s[4 * c + 2 * hh + e] - m_new);
        s[4 * c + 2 * hh + e] = pe;
        sum[(2 * c + e) % 4] += pe;
      }
    }
    l[hh] = l[hh] * alpha[hh] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
  }
}

// softmax_tile in the form a tile needs; the branches are uniform
__device__ __forceinline__ void softmax_any(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], const float (&bl)[BK / 4],
                                            const Params& p, bool bias, int k0, bool edge,
                                            const int (&lim)[2], int t) {
  if (bias) {
    if (edge) softmax_tile<true, true>(s, m, l, alpha, bl, p, k0, lim, t);
    else softmax_tile<false, true>(s, m, l, alpha, bl, p, k0, lim, t);
  } else {
    if (edge) softmax_tile<true, false>(s, m, l, alpha, bl, p, k0, lim, t);
    else softmax_tile<false, false>(s, m, l, alpha, bl, p, k0, lim, t);
  }
}

// the warpgroup's 64 query rows (row0.., zero past Tq) into its plain Q tile
template <int HD>
__device__ __forceinline__ void load_q(float* qs, const Params& p, int h, int b, int row0,
                                       int tid) {
  const float* const qg = p.q + b * p.sqb + h * p.sqh;
  for (int i = tid; i < 64 * HD / 4; i += 128) {
    const int r = i / (HD / 4), c = 4 * (i % (HD / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < p.tq)
      x = __ldg(reinterpret_cast<const float4*>(qg + static_cast<long long>(row0 + r) * p.sqt + c));
    *reinterpret_cast<float4*>(qs + raw_off<HD>(r, c)) = x;
  }
}

template <int HD>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, int h, int b,
                                        int q0, int ntiles) {
  using C = Cfg<HD>;
  const uint32_t base = smem_u32(smem);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg;  // the warpgroup's first query row
  const int row[2] = {row0 + 16 * warp + g, row0 + 16 * warp + g + 8};
  const int lim[2] = {p.causal ? min(p.kv_len, p.q_offset + row[0] + 1) : p.kv_len,
                      p.causal ? min(p.kv_len, p.q_offset + row[1] + 1) : p.kv_len};
  // key tiles this warpgroup needs: none past its last row (causal), none
  // at all when its rows lie past Tq
  const int wg_end = p.causal ? min(p.tk, p.q_offset + row0 + 64) : p.tk;
  const int nt = row0 >= p.tq ? 0 : (wg_end + BK - 1) / BK;
  const int kv_lim = min(p.tk, p.kv_len);
  const float* bias = p.bias ? p.bias + b * p.sbias : nullptr;
  float* const qs = reinterpret_cast<float*>(smem + C::Q_OFF) + 64 * wg * HD;
  if (nt > 0) load_q<HD>(qs, p, h, b, row0, tid);
  consumer_sync(wg);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {M_INIT, M_INIT};  // running max, log2 units
  float l[2] = {0.f, 0.f};        // this thread's share of the row sums

  for (int j = 0; j < ntiles; ++j) {
    const int slot = j % C::STAGES;
    const Bars bar(base + C::BAR_OFF, slot);
    const uint32_t parity = (j / C::STAGES) & 1;
    const uint32_t st = base + slot * C::STAGE;
    mbar_wait(bar.kfull, parity);
    if (j >= nt) {  // past the warpgroup's rows: release both halves unread
      mbar_arrive(bar.kempty);
      mbar_wait(bar.vfull, parity);
      mbar_arrive(bar.vempty);
      continue;
    }
    const int k0 = j * BK;
    float bl[BK / 4];
    load_bias(bl, p, bias, k0, t);
    float s[BK / 2];  // s[4c + 2hh + e]: row row[hh], key k0 + 8c + 2t + e
    // S = Q K^T: Q's rows 16 warp + g (+ 8), a k step's columns 8 kk + 2 t and
    // + 1 (K positions t and t + 4 in the producer's order), one 8-byte load
    tf32x3<BK, HD / 8, 8, C::KBOX>(s, [&](int kk, float (&v)[4]) {
      const float2 a = *reinterpret_cast<const float2*>(qs + raw_off<HD>(16 * warp + g, 8 * kk + 2 * t));
      const float2 c = *reinterpret_cast<const float2*>(qs + raw_off<HD>(16 * warp + g + 8, 8 * kk + 2 * t));
      v[0] = a.x;
      v[1] = c.x;
      v[2] = a.y;
      v[3] = c.y;
    }, st, st + C::KT);
    mbar_arrive(bar.kempty);
    // masks only on tiles that reach past the keys or above a row's diagonal
    const bool edge = k0 + BK > kv_lim || (p.causal && k0 + BK - 1 > p.q_offset + row0);
    float alpha[2];
    softmax_any(s, m, l, alpha, bl, p, bias != nullptr, k0, edge, lim, t);
    mbar_wait(bar.vfull, parity);
    // partial = P V: k step kk's K positions t and t + 4 are the S columns
    // 8 kk + 2 t and + 1
    float part[HD / 2];
    tf32x3<HD, BK / 8, C::PV_BATCH, C::VBOX>(part, [&](int kk, float (&v)[4]) {
      v[0] = s[4 * kk];
      v[1] = s[4 * kk + 2];
      v[2] = s[4 * kk + 1];
      v[3] = s[4 * kk + 3];
    }, st + 2 * C::KT, st + 3 * C::KT);
    mbar_arrive(bar.vempty);
    // O = O * alpha + partial, rounding to nearest
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[4 * n + i] = fmaf(o[4 * n + i], alpha[i / 2], part[4 * n + i]);
  }

  float* const og = p.o + b * p.sob + h * p.soh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    if (row[hh] >= p.tq) continue;
    if (p.lse && t == 0) {
      // a row that saw no key keeps m = -1e30 in natural-log units too
      const float mn = m[hh] <= NEG_INF ? NEG_INF : m[hh] * LN2;
      p.lse[(static_cast<long long>(b) * p.H + h) * p.tq + row[hh]] = mn + logf(lt);
    }
    float* const orow = og + static_cast<long long>(row[hh]) * p.sot + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[4 * n + 2 * hh] / lt, o[4 * n + 2 * hh + 1] / lt);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1) attn_fwd_f32_kernel(const Params p) {
  using C = Cfg<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int h = blockIdx.x, b = blockIdx.y;
  // causal q tiles longest first: the last tile holds the most keys
  const int q0 = (p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BQ;
  const int k_end = p.causal ? min(p.tk, p.q_offset + q0 + BQ) : p.tk;
  const int ntiles = (k_end + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      const Bars bar(smem_u32(smem) + C::BAR_OFF, i);
      mbar_init(bar.kfull, 128);  // the producer warpgroup's threads
      mbar_init(bar.vfull, 128);
      mbar_init(bar.kempty, 128 * CONSUMERS);
      mbar_init(bar.vempty, 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) >= CONSUMERS) {
    if constexpr (HD == 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    else asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    produce<HD>(p, smem, h / p.group, b, ntiles);
    return;
  }
  if constexpr (HD == 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  else asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
  consume<HD>(p, smem, h, b, q0, ntiles);
}

// The rows of batch row b that see no key get the mean of v over the Tk keys
// in each query head of kv head blockIdx.x; 32 columns a block, 8 key groups
// of 32 threads summed in group order (a fixed order). Causal, row r sees
// the keys j <= q_offset + r below kv_len whose bias is above -1e29: the
// rows with q_offset + r below the first such key see none; not causal,
// every row sees none when no key is visible. Launched after the main
// kernel, only with a bias.
__global__ void __launch_bounds__(256) unseen_rows_f32_kernel(const Params p) {
  const int kvh = blockIdx.x, b = blockIdx.y, c = blockIdx.z * 32 + threadIdx.x % 32;
  const int grp = threadIdx.x / 32;
  const float* bias = p.bias + b * p.sbias;
  const int lim = min(p.tk, p.kv_len);
  __shared__ int first;
  __shared__ float part[8][32];
  if (threadIdx.x == 0) first = lim;
  __syncthreads();
  for (int j = threadIdx.x; j < lim; j += 256)
    if (bias[j] > -1e29f) {
      atomicMin(&first, j);
      break;
    }
  __syncthreads();
  const int rows = first >= lim ? p.tq : p.causal ? max(0, min(first - p.q_offset, p.tq)) : 0;
  if (rows == 0) return;
  const float* vb = p.v + b * p.svb + kvh * p.svh + c;
  float s = 0.f;
  for (int j = grp; j < p.tk; j += 8) s += vb[static_cast<long long>(j) * p.svt];
  part[grp][threadIdx.x % 32] = s;
  __syncthreads();
  if (grp == 0) {
    for (int g = 1; g < 8; ++g) s += part[g][threadIdx.x];
    part[0][threadIdx.x] = s / p.tk;
  }
  __syncthreads();
  const float mean = part[0][threadIdx.x % 32];
  for (int i = grp; i < p.group * rows; i += 8) {
    const int h = kvh * p.group + i / rows, r = i % rows;
    p.o[b * p.sob + h * p.soh + static_cast<long long>(r) * p.sot + c] = mean;
  }
}

template <int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<HD>;
  const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attn_fwd_f32_kernel<HD><<<dim3(p.H, B, (p.tq + BQ - 1) / BQ), THREADS, C::SMEM, stream>>>(p);
  if (p.bias) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    unseen_rows_f32_kernel<<<dim3(p.H / p.group, B, HD / 32), 256, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements; the last dim of q, k, v and o has unit stride, the
// pointers and the other strides are 16-byte aligned.
extern "C" int attn_fwd_f32(
    const float* q, const float* k, const float* v, const float* bias, float* o, float* lse,
    int B, int H, int group, int tq, int tk, int hd, int kv_len, int causal, int q_offset,
    float scale, long long sqb, long long sqh, long long sqt, long long skb, long long skh,
    long long skt, long long svb, long long svh, long long svt, long long sob, long long soh,
    long long sot, long long sbias, void* stream) {
  if (B < 1 || H < 1 || group < 1 || H % group || tq < 1 || tk < 1 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = {q, k, v, bias, o, lse, H, group, tq, tk, kv_len, causal, q_offset,
                    scale * LOG2E, sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot,
                    sbias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch<128>(p, B, s);
  if (hd == 64) return launch<64>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
