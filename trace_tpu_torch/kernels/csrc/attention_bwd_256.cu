// Attention backward for Hopper (sm_90a) at head dim 256: bf16 q/k/v/do in,
// bf16 dq/dk/dv out, fp32 row statistics and accumulators. A library of its
// own beside attention_bwd.cu (hd 64 and 128), so that the two compile in
// parallel; the delta pre-pass stays there (it reads any even hd).
//
// Replaces the two backward TPU kernels of trace_tpu/kernels/flash_backward.py
// (_dq_kernel and _dkv_kernel, whose caller pads hd to a multiple of 128) at
// hd 256, and below it on copies padded to 256 (the wrappers in
// kernels/flash_backward.py):
//   p  = exp(s - lse)           s = q k^T * scale + bias (+ causal mask)
//   dv = p^T do
//   ds = p * (do v^T - delta)
//   dq = ds k * scale           dk = ds^T q * scale
// with dk and dv summed over the query heads of a kv head.
//
// Bound on an H100: operations. At Falcon3-7B's heads (B = 2, 12 / 4 heads,
// T = 2048, causal, one row right-padded by 300) one product over the
// visible pairs is ~22.3 GFLOP: dq needs 3 (0.068 ms at the bf16 peak), dk/dv
// 4 (0.090 ms), over ~100 MB of operands.
//
// Design: attention_bwd.cu's skeleton (a producer warp issuing TMA copies of
// 64-column boxes in the 128-byte swizzle, two consumer warpgroups running
// every product as wgmma with fp32 accumulators, setmaxnreg giving them 240
// registers a thread), with tiles cut to what hd 256 leaves:
//   * attn_bwd_dq_kernel: a block owns 128 query rows, 64 to a consumer
//     warpgroup. Q and dO stay resident (64 KB each); K and V stream in tiles
//     of 32 keys (16 KB each) through a ring of 3 stages, each with its keys'
//     bias. A warpgroup holds dQ [64 x 256] in fp32, 128 registers a thread,
//     beside S and dP of a 32-key tile (16 each): 64-key tiles would take 64
//     and leave one stage beside Q and dO. Per tile S = Q K^T and dP = dO V^T
//     (m64n32k16, both operands K-major in shared memory), ds on the
//     accumulators, dQ += dS K (m64n256k16, dS from registers, K MN-major).
//   * attn_bwd_dkv_kernel: dK and dV of 64 keys at hd 256 would take 256
//     registers a thread in one warpgroup, so a block owns 64 keys and each
//     consumer warpgroup half of hd's columns of both (64 + 64 registers). K
//     and V stay resident (32 KB each); tiles of 64 query rows of Q and dO
//     (with their rows' lse, +inf past Tq, and delta) stream through a ring
//     of 2 stages over the G query heads of the kv head, one after the other
//     in a fixed order. Per tile the warpgroups split S^T = K Q^T and dP^T =
//     V dO^T (64 keys x 64 rows, contracted over all 256 columns) by query
//     rows, 32 each (m64n32k16), form p^T and ds^T on the accumulators and
//     write them as bf16 into a shared [64 x 64] tile each (double-buffered:
//     the other warpgroup may still read the previous pair); after a named
//     barrier of both, each runs dV[:, half] += P^T dO[:, half] and
//     dK[:, half] += dS^T Q[:, half] (m64n128k16, A K-major and B MN-major
//     from shared memory). The group sum happens in registers: no float
//     atomics, so a step repeats bit for bit.
//   * Causal tiles that see nothing are skipped, and the mask applies only on
//     tiles that cross the diagonal (a template argument), as at hd 128.
//     Outputs are staged through a resident tile (Q for dq, K and V for dk
//     and dv) and written as 16-byte rows.
// p and ds are rounded to bf16 before their second product, as in
// attention_bwd.cu; masks are the finite -1e30 of the JAX package; a query
// row that sees no key has lse = -1e30 and p = 1 on every key tile visited
// (padding, whose do is 0 in training).

#include "attention_common.cuh"

namespace {

constexpr int HD = 256;
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr float MASKED = NEG_INF * LOG2E;       // a masked score in log2 units

struct BwdParams {
  const float* bias;   // [B, Tk] additive, or null
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  bf16* dq;            // [B, H, Tq, 256]
  bf16* dk;            // [B, H / group, Tk, 256]
  bf16* dv;
  int H, group, tq, tk, causal;
  float scale, scale_log2;
  int qfold, kfold;    // the operand's map is (h*hd + column, token, batch)
};

// Shared memory of the dq kernel: Q and dO resident ([4][BM][128 B] each), a
// ring of STAGES K / V tile pairs ([4][BN][128 B] each), the streamed keys'
// bias, then the mbarriers: resident full, full per stage, empty per stage.
struct DqCfg {
  static constexpr int BM = 128;  // query rows of a block
  static constexpr int BN = 32;   // keys of a streamed tile
  static constexpr int STAGES = 3;
  static constexpr int RES = BM * HD * 2;
  static constexpr int TILE = BN * HD * 2;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int STAT_OFF = 2 * RES + STAGES * STAGE;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * BN * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
};

// Shared memory of the dk/dv kernel: K and V resident ([4][BM][128 B] each),
// a ring of STAGES Q / dO tile pairs ([4][BN][128 B] each), two buffers of
// the p^T and ds^T tiles ([BM][128 B] bf16 each), the streamed rows' lse and
// delta, then the mbarriers as above.
struct DkvCfg {
  static constexpr int BM = 64;  // keys of a block
  static constexpr int BN = 64;  // query rows of a streamed tile
  static constexpr int STAGES = 2;
  static constexpr int RES = BM * HD * 2;
  static constexpr int TILE = BN * HD * 2;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int PT = BM * BN * 2;  // a p^T or ds^T tile
  static constexpr int PT_OFF = 2 * RES + STAGES * STAGE;
  static constexpr int STAT_OFF = PT_OFF + 2 * 2 * PT;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BN * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};
static_assert(DqCfg::SMEM <= 232448 && DkvCfg::SMEM <= 232448, "shared memory");
static_assert(DkvCfg::BN == 64, "a p^T row is one 128-byte swizzle row");

template <class C>
struct Bars {
  uint32_t res_full, full, empty;  // full and empty: stage 0's, 8 bytes a stage
  __device__ explicit Bars(uint32_t base)
      : res_full(base + C::BAR_OFF), full(res_full + 8), empty(full + 8 * C::STAGES) {}
};

// the block's barriers, by thread 0: a stage is full after 33 arrivals of the
// producer warp (lane 0's, announcing the bytes of its copies, then every
// lane's after its stores) and those bytes, empty after every consumer
// thread's arrival
template <class C>
__device__ __forceinline__ void init_barriers(uint32_t base) {
  if (threadIdx.x == 0) {
    const Bars<C> bar(base);
    mbar_init(bar.res_full, 1);
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(bar.full + 8 * i, 33);
      mbar_init(bar.empty + 8 * i, 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ void consumers_sync() {  // both consumer warpgroups
  asm volatile("bar.sync 3, %0;\n" :: "n"(128 * CONSUMERS) : "memory");
}

// d [64 x 32] (+)= A [64 x 16] B [16 x 32], A and B K-major in shared memory;
// accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d [64 x 128] += A [64 x 16] B [16 x 128], A K-major and B MN-major
// (transpose bit set), both in shared memory
__device__ __forceinline__ void wgmma_ss_n128_mn(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
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
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D [64 x 32] = A [64 x 256] B^T, B [32 x 256]: a the warpgroup's 64 rows of
// a tile whose boxes hold a_rows rows, b the first of 32 rows of a tile whose
// boxes hold b_rows rows; both K-major (the shape of Q K^T)
__device__ __forceinline__ void nt_n32(float (&d)[16], uint32_t a, int a_rows, uint32_t b,
                                       int b_rows) {
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc)
    wgmma_ss_n32(d, sw128_desc(a + (kc / 4) * a_rows * ROW_BYTES + (kc % 4) * 32),
                 sw128_desc(b + (kc / 4) * b_rows * ROW_BYTES + (kc % 4) * 32), kc > 0);
}

// ---------------------------------------------------------------- dq

// One warp: Q and dO of the block once (lane 0), then per key tile j its K
// and V tiles (lane 0) and its keys' bias in log2 units, -inf past Tk (p = 0
// on keys the tensor does not hold, whose K and V rows TMA fills with
// zeros; every lane), into the tile's stage.
__device__ __forceinline__ void dq_produce(const CUtensorMap* qmap, const CUtensorMap* domap,
                                           const CUtensorMap* kmap, const CUtensorMap* vmap,
                                           const BwdParams& p, unsigned char* smem, int h, int b,
                                           int q0, int ntiles) {
  using C = DqCfg;
  const uint32_t base = smem_u32(smem);
  const Bars<C> bar(base);
  const int kvh = h / p.group, lane = threadIdx.x % 32;
  const float* const bias = p.bias ? p.bias + static_cast<long long>(b) * p.tk : nullptr;
  if (lane == 0) {
    mbar_arrive_tx(bar.res_full, 2 * C::RES);
    load_rows<HD>(base, qmap, p.qfold, bar.res_full, q0, h, b, C::BM);
    load_rows<HD>(base + C::RES, domap, p.qfold, bar.res_full, q0, h, b, C::BM);
  }
  for (int j = 0; j < ntiles; ++j) {
    const int slot = j % C::STAGES;
    if (j >= C::STAGES) mbar_wait(bar.empty + 8 * slot, ((j / C::STAGES) - 1) & 1);
    if (lane == 0) {
      const uint32_t ks = base + 2 * C::RES + slot * C::STAGE;
      mbar_arrive_tx(bar.full + 8 * slot, C::STAGE);
      load_rows<HD>(ks, kmap, p.kfold, bar.full + 8 * slot, j * C::BN, kvh, b, C::BN);
      load_rows<HD>(ks + C::TILE, vmap, p.kfold, bar.full + 8 * slot, j * C::BN, kvh, b, C::BN);
    }
    float* const st = reinterpret_cast<float*>(smem + C::STAT_OFF) + slot * C::BN;
    for (int i = lane; i < C::BN; i += 32) {
      const int jj = j * C::BN + i;
      st[i] = jj >= p.tk ? -INFINITY : bias ? __fmul_rn(bias[jj], LOG2E) : 0.f;
    }
    mbar_arrive(bar.full + 8 * slot);
  }
}

// ds = p (dp - delta) of one 32-key tile in registers, s becoming ds: s[4c +
// 2hh + e] is row row[hh], key k0 + 8c + 2t + e, whose bias is bl[8c + 2t +
// e]. DIAG adds the causal mask (keys after the row).
template <bool DIAG>
__device__ __forceinline__ void dq_ds(float (&s)[16], const float (&dp)[16], const float* bl,
                                      float scale_log2, int k0, const int (&row)[2],
                                      const float (&lse)[2], const float (&delta)[2], int t) {
#pragma unroll
  for (int c = 0; c < DqCfg::BN / 8; ++c) {
    const float2 b2 = *reinterpret_cast<const float2*>(bl + 8 * c + 2 * t);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * c + 2 * hh + e;
        float x = fmaf(s[i], scale_log2, e ? b2.y : b2.x);
        if (DIAG) x = k0 + 8 * c + 2 * t + e > row[hh] ? MASKED : x;
        s[i] = ex2(x - lse[hh]) * (dp[i] - delta[hh]);
      }
  }
}

__device__ __forceinline__ void dq_consume(const BwdParams& p, unsigned char* smem, int h, int b,
                                           int q0, int ntiles) {
  using C = DqCfg;
  const uint32_t base = smem_u32(smem);
  const Bars<C> bar(base);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg;  // the warpgroup's first query row
  const int row[2] = {row0 + 16 * warp + g, row0 + 16 * warp + g + 8};
  // key tiles this warpgroup needs: none past its last row (causal), none
  // at all when its rows lie past Tq
  const int wg_end = p.causal ? min(p.tk, row0 + 64) : p.tk;
  const int nt = row0 >= p.tq ? 0 : (wg_end + C::BN - 1) / C::BN;
  const long long qrow = (static_cast<long long>(b) * p.H + h) * p.tq;
  float lse[2], delta[2];  // lse in log2 units
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lse[hh] = row[hh] < p.tq ? __fmul_rn(p.lse[qrow + row[hh]], LOG2E) : 0.f;
    delta[hh] = row[hh] < p.tq ? p.delta[qrow + row[hh]] : 0.f;
  }
  const uint32_t qa = base + wg * 64 * ROW_BYTES, doa = qa + C::RES;
  const float* const stats = reinterpret_cast<const float*>(smem + C::STAT_OFF);

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  mbar_wait(bar.res_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int slot = j % C::STAGES;
    mbar_wait(bar.full + 8 * slot, (j / C::STAGES) & 1);
    if (j >= nt) {  // past the warpgroup's rows: release the stage unread
      mbar_arrive(bar.empty + 8 * slot);
      continue;
    }
    const uint32_t ks = base + 2 * C::RES + slot * C::STAGE;
    float s[C::BN / 2], dp[C::BN / 2];
    wgmma_fence();
    nt_n32(s, qa, C::BM, ks, C::BN);              // S = Q K^T
    nt_n32(dp, doa, C::BM, ks + C::TILE, C::BN);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    const int k0 = j * C::BN;
    const float* const bl = stats + slot * C::BN;
    if (p.causal && k0 + C::BN - 1 > row0)  // the tile crosses the diagonal
      dq_ds<true>(s, dp, bl, p.scale_log2, k0, row, lse, delta, t);
    else
      dq_ds<false>(s, dp, bl, p.scale_log2, k0, row, lse, delta, t);
    uint32_t da[C::BN / 16][4];
    pack_frags<C::BN>(da, s);
    wgmma_fence();
    pn_product<HD, C::BN>(dq, da, ks);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq);
    mbar_arrive(bar.empty + 8 * slot);
  }

  // dQ times scale as bf16 through the warpgroup's own rows of Q (its wgmma
  // reads of them are done), then 16-byte rows of dq
  unsigned char* const stage = smem + wg * 64 * ROW_BYTES;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(stage + (n / 8) * C::BM * ROW_BYTES + r * ROW_BYTES +
                                   (((n % 8) ^ (r & 7)) << 4) + 4 * t) =
          pack(dq[4 * n + 2 * hh] * p.scale, dq[4 * n + 2 * hh + 1] * p.scale);
  }
  consumer_sync(wg);
  if (row0 >= p.tq) return;
  bf16* const out = p.dq + (qrow + row0) * HD;
  for (int i = threadIdx.x % 128; i < 64 * (HD / 8); i += 128) {
    const int r = i / (HD / 8), n = i % (HD / 8);
    if (row0 + r >= p.tq) break;  // rows only grow with i
    *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * HD + 8 * n) =
        *reinterpret_cast<const uint4*>(stage + (n / 8) * C::BM * ROW_BYTES + r * ROW_BYTES +
                                        (((n % 8) ^ (r & 7)) << 4));
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap domap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int h = blockIdx.x, b = blockIdx.y;
  // causal q tiles longest first: the last tile sees the most keys
  const int q0 = (p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * DqCfg::BM;
  const int k_end = p.causal ? min(p.tk, q0 + DqCfg::BM) : p.tk;
  const int ntiles = (k_end + DqCfg::BN - 1) / DqCfg::BN;
  init_barriers<DqCfg>(smem_u32(smem));
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x / 32 == 4 * CONSUMERS)
      dq_produce(&qmap, &domap, &kmap, &vmap, p, smem, h, b, q0, ntiles);
    return;
  }
  // a consumer thread holds dQ (128), S and dP (16 each) and dS
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  dq_consume(p, smem, h, b, q0, ntiles);
}

// ---------------------------------------------------------------- dk, dv

// One warp: K and V of the block once (lane 0), then per step ``it`` query
// head kvh * G + it / nqt, query tile qt_start + it % nqt: its Q and dO tiles
// (lane 0) and its rows' lse (log2 units, +inf past Tq) and delta (every
// lane) into the step's stage.
__device__ __forceinline__ void dkv_produce(const CUtensorMap* qmap, const CUtensorMap* domap,
                                            const CUtensorMap* kmap, const CUtensorMap* vmap,
                                            const BwdParams& p, unsigned char* smem, int kvh,
                                            int b, int k0, int qt_start, int nqt, int total) {
  using C = DkvCfg;
  const uint32_t base = smem_u32(smem);
  const Bars<C> bar(base);
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_arrive_tx(bar.res_full, 2 * C::RES);
    load_rows<HD>(base, kmap, p.kfold, bar.res_full, k0, kvh, b, C::BM);
    load_rows<HD>(base + C::RES, vmap, p.kfold, bar.res_full, k0, kvh, b, C::BM);
  }
  for (int it = 0; it < total; ++it) {
    const int slot = it % C::STAGES;
    if (it >= C::STAGES) mbar_wait(bar.empty + 8 * slot, ((it / C::STAGES) - 1) & 1);
    const int hq = kvh * p.group + it / nqt;
    const int q0 = (qt_start + it % nqt) * C::BN;
    if (lane == 0) {
      const uint32_t qs = base + 2 * C::RES + slot * C::STAGE;
      mbar_arrive_tx(bar.full + 8 * slot, C::STAGE);
      load_rows<HD>(qs, qmap, p.qfold, bar.full + 8 * slot, q0, hq, b, C::BN);
      load_rows<HD>(qs + C::TILE, domap, p.qfold, bar.full + 8 * slot, q0, hq, b, C::BN);
    }
    const long long qrow = (static_cast<long long>(b) * p.H + hq) * p.tq + q0;
    float* const st = reinterpret_cast<float*>(smem + C::STAT_OFF) + slot * 2 * C::BN;
    for (int i = lane; i < C::BN; i += 32) {
      const bool in = q0 + i < p.tq;
      st[i] = in ? __fmul_rn(p.lse[qrow + i], LOG2E) : INFINITY;
      st[C::BN + i] = in ? p.delta[qrow + i] : 0.f;
    }
    mbar_arrive(bar.full + 8 * slot);
  }
}

// p^T and ds^T of the warpgroup's 32 query rows of a tile in registers, s
// becoming p^T and dp ds^T: s[4c + 2hh + e] is key key[hh], query row q0 +
// col + e with col = qc0 + 8c + 2t, whose lse and delta are st[col + e] and
// st[BN + col + e]. DIAG adds the causal mask (keys after the row).
template <bool DIAG>
__device__ __forceinline__ void dkv_ds(float (&s)[16], float (&dp)[16], const float* st,
                                       const BwdParams& p, int q0, int qc0, const int (&key)[2],
                                       const float (&bk)[2], int t) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = qc0 + 8 * c + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(st + col);
    const float2 d = *reinterpret_cast<const float2*>(st + DkvCfg::BN + col);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * c + 2 * hh + e;
        float x = fmaf(s[i], p.scale_log2, bk[hh]);
        if (DIAG) x = key[hh] > q0 + col + e ? MASKED : x;
        const float pr = ex2(x - (e ? l.y : l.x));
        s[i] = pr;
        dp[i] = pr * (dp[i] - (e ? d.y : d.x));
      }
  }
}

// The warpgroup's [64 keys x 32 rows] of p^T or ds^T as bf16 into columns
// qc0.. of a [64 x 64] tile, one 128-byte row a key in the 128-byte swizzle
// (the layout a K-major wgmma operand reads)
__device__ __forceinline__ void store_pt(unsigned char* tile, const float (&s)[16], int qc0,
                                         int warp, int g, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint32_t*>(tile + r * ROW_BYTES + (((qc0 / 8 + c) ^ (r & 7)) << 4) +
                                   4 * t) = pack(s[4 * c + 2 * hh], s[4 * c + 2 * hh + 1]);
  }
}

// D [64 x 128] += A [64 x 64] B, A a p^T or ds^T tile, B [64 rows x 128
// columns] the half of a streamed tile whose first box is b (MN-major)
__device__ __forceinline__ void pt_product(float (&d)[64], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DkvCfg::BN / 16; ++kk)
    wgmma_ss_n128_mn(d, sw128_desc(a + kk * 32),
                     sw128_desc_mn(b + kk * 16 * ROW_BYTES, DkvCfg::BN * ROW_BYTES));
}

// A warpgroup's accumulator [64 x 128] times `scale` as bf16 into the two
// boxes (BM rows each) of a resident tile that hold its half of the columns,
// box0 the first, then its rows r < valid as 16-byte stores to out[r * HD ..]
__device__ __forceinline__ void stage_half(unsigned char* box0, const float (&acc)[64],
                                           float scale, int warp, int g, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<uint32_t*>(box0 + (n / 8) * DkvCfg::BM * ROW_BYTES + r * ROW_BYTES +
                                   (((n % 8) ^ (r & 7)) << 4) + 4 * t) =
          pack(acc[4 * n + 2 * hh] * scale, acc[4 * n + 2 * hh + 1] * scale);
  }
}

__device__ __forceinline__ void write_half(const unsigned char* box0, bf16* out, int valid) {
  for (int i = threadIdx.x % 128; i < 64 * 16; i += 128) {
    const int r = i / 16, n = i % 16;
    if (r >= valid) break;  // rows only grow with i
    *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * HD + 8 * n) =
        *reinterpret_cast<const uint4*>(box0 + (n / 8) * DkvCfg::BM * ROW_BYTES +
                                        r * ROW_BYTES + (((n % 8) ^ (r & 7)) << 4));
  }
}

__device__ __forceinline__ void dkv_consume(const BwdParams& p, unsigned char* smem, int kvh,
                                            int b, int k0, int qt_start, int nqt, int total) {
  using C = DkvCfg;
  const uint32_t base = smem_u32(smem);
  const Bars<C> bar(base);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qc0 = 32 * wg;  // the warpgroup's query rows of a tile: qc0 ... qc0 + 31
  const int half = 2 * wg;  // its columns of dk and dv: boxes half and half + 1
  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  float bk[2];  // the bias of the thread's keys, log2 units; -inf past Tk (p = 0)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    bk[hh] = key[hh] >= p.tk ? -INFINITY
             : p.bias ? __fmul_rn(p.bias[static_cast<long long>(b) * p.tk + key[hh]], LOG2E)
                      : 0.f;
  const uint32_t ka = base, va = base + C::RES;
  const float* const stats = reinterpret_cast<const float*>(smem + C::STAT_OFF);

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar.res_full, 0);
  int done = 0;  // tiles added: the p^T / ds^T buffer alternates with them
  for (int it = 0; it < total; ++it) {
    const int slot = it % C::STAGES;
    mbar_wait(bar.full + 8 * slot, (it / C::STAGES) & 1);
    const int q0 = (qt_start + it % nqt) * C::BN;
    // nothing to add (the same for both warpgroups): every row of the tile
    // lies before the block's first key
    if (p.causal && q0 + C::BN - 1 < k0) {
      mbar_arrive(bar.empty + 8 * slot);
      continue;
    }
    const uint32_t qs = base + 2 * C::RES + slot * C::STAGE, dos = qs + C::TILE;
    float s[16], dp[16];
    wgmma_fence();
    nt_n32(s, ka, C::BM, qs + qc0 * ROW_BYTES, C::BN);    // S^T = K Q^T, 32 rows
    nt_n32(dp, va, C::BM, dos + qc0 * ROW_BYTES, C::BN);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    const float* const st = stats + slot * 2 * C::BN;
    if (p.causal && k0 + C::BM - 1 > q0 + qc0)  // the warpgroup's rows cross the diagonal
      dkv_ds<true>(s, dp, st, p, q0, qc0, key, bk, t);
    else
      dkv_ds<false>(s, dp, st, p, q0, qc0, key, bk, t);
    // p^T and ds^T of the whole tile in shared memory: this warpgroup's rows,
    // then the other's after the barrier; the other may still read the
    // buffer before (its products of the tile before)
    const int buf = C::PT_OFF + (done & 1) * 2 * C::PT;
    store_pt(smem + buf, s, qc0, warp, g, t);
    store_pt(smem + buf + C::PT, dp, qc0, warp, g, t);
    fence_proxy_async();
    consumers_sync();
    wgmma_fence();
    pt_product(dv, base + buf, dos + half * C::BN * ROW_BYTES);         // dV += P^T dO
    pt_product(dk, base + buf + C::PT, qs + half * C::BN * ROW_BYTES);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dk);
    fence_operands(dv);
    mbar_arrive(bar.empty + 8 * slot);
    ++done;
  }

  // no product reads K or V any more: stage dk (times scale) and dv through
  // the warpgroup's columns of them, then 16-byte rows
  consumers_sync();
  unsigned char* const kbox = smem + half * C::BM * ROW_BYTES;
  stage_half(kbox, dk, p.scale, warp, g, t);
  stage_half(kbox + C::RES, dv, 1.f, warp, g, t);
  consumer_sync(wg);
  const long long off =
      ((static_cast<long long>(b) * (p.H / p.group) + kvh) * p.tk + k0) * HD + 128 * wg;
  write_half(kbox, p.dk + off, p.tk - k0);
  write_half(kbox + C::RES, p.dv + off, p.tk - k0);
}

__global__ void __launch_bounds__(THREADS, 1)
    attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap domap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const BwdParams p) {
  using C = DkvCfg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * C::BM;  // causal: key tile 0 sees the most rows and goes first
  // query tiles whose last row lies before the block's first key are
  // causally masked for every key of the block
  const int qt_start = p.causal ? k0 / C::BN : 0;
  const int nqt = (p.tq + C::BN - 1) / C::BN - qt_start;
  const int total = nqt > 0 ? p.group * nqt : 0;
  init_barriers<C>(smem_u32(smem));
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x / 32 == 4 * CONSUMERS)
      dkv_produce(&qmap, &domap, &kmap, &vmap, p, smem, kvh, b, k0, qt_start, nqt, total);
    return;
  }
  // a consumer thread holds its halves of dK and dV (64 each) and its rows'
  // S^T and dP^T (16 each)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  dkv_consume(p, smem, kvh, b, k0, qt_start, nqt, total);
}

struct Operands {
  const void *q, *k, *v, *d_o;
  int B;
};

// One launch of the dq (DQ) or the dk/dv kernel: tensor maps of the
// contiguous q, do [B, H, Tq, 256] and k, v [B, H / group, Tk, 256] with
// boxes of the rows each kernel keeps resident or streams
template <bool DQ>
int launch(BwdParams p, const Operands& a, cudaStream_t stream) {
  if (a.B < 1 || p.H < 1 || p.group < 1 || p.H % p.group || p.tq < 1 || p.tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hkv = p.H / p.group;
  const int qrows = DQ ? DqCfg::BM : DkvCfg::BN, krows = DQ ? DqCfg::BN : DkvCfg::BM;
  const int smem = DQ ? DqCfg::SMEM : DkvCfg::SMEM;
  const long long qh = static_cast<long long>(p.tq) * HD, kh = static_cast<long long>(p.tk) * HD;
  CUtensorMap qmap, domap, kmap, vmap;
  int err = make_map(&qmap, &p.qfold, a.q, HD, p.H, p.tq, a.B, p.H * qh, qh, HD, qrows);
  if (err == 0)
    err = make_map(&domap, &p.qfold, a.d_o, HD, p.H, p.tq, a.B, p.H * qh, qh, HD, qrows);
  if (err == 0) err = make_map(&kmap, &p.kfold, a.k, HD, hkv, p.tk, a.B, hkv * kh, kh, HD, krows);
  if (err == 0) err = make_map(&vmap, &p.kfold, a.v, HD, hkv, p.tk, a.B, hkv * kh, kh, HD, krows);
  if (err != 0) return err;
  const auto kernel = DQ ? attn_bwd_dq_kernel : attn_bwd_dkv_kernel;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid = DQ ? dim3(p.H, a.B, (p.tq + DqCfg::BM - 1) / DqCfg::BM)
                       : dim3(hkv, a.B, (p.tk + DkvCfg::BM - 1) / DkvCfg::BM);
  kernel<<<grid, THREADS, smem, stream>>>(qmap, domap, kmap, vmap, p);
  return static_cast<int>(cudaGetLastError());
}

BwdParams make_params(const float* bias, const float* lse, const float* delta, int H, int group,
                      int tq, int tk, int causal, float scale) {
  BwdParams p;
  p.bias = bias;
  p.lse = lse;
  p.delta = delta;
  p.dq = nullptr;
  p.dk = nullptr;
  p.dv = nullptr;
  p.H = H;
  p.group = group;
  p.tq = tq;
  p.tk = tk;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.qfold = p.kfold = 0;
  return p;
}

}  // namespace

// The entries of attention_bwd.cu at hd = 256 (any other hd is refused). All
// tensors contiguous and 16-byte aligned: q, d_o, dq [B, H, Tq, 256]; k, v
// [B, H / group, Tk, 256]; bias [B, Tk] or null; lse, delta [B, H, Tq].
extern "C" int attn_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const float* bias, const void* d_o,
    const float* lse, const float* delta, void* dq, int B, int H, int group, int tq,
    int tk, int hd, int causal, float scale, void* stream) {
  if (hd != HD) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p = make_params(bias, lse, delta, H, group, tq, tk, causal, scale);
  p.dq = static_cast<bf16*>(dq);
  const Operands a = {q, k, v, d_o, B};
  return launch<true>(p, a, static_cast<cudaStream_t>(stream));
}

// As attn_bwd_dq_bf16; dk, dv [B, H / group, Tk, 256], summed over each kv
// head's ``group`` query heads.
extern "C" int attn_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const float* bias, const void* d_o,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H, int group,
    int tq, int tk, int hd, int causal, float scale, void* stream) {
  if (hd != HD) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p = make_params(bias, lse, delta, H, group, tq, tk, causal, scale);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  const Operands a = {q, k, v, d_o, B};
  return launch<false>(p, a, static_cast<cudaStream_t>(stream));
}
