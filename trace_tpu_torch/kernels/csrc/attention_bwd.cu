// Attention backward for Hopper (sm_90a): bf16 q/k/v/do in, bf16 dq/dk/dv
// out, fp32 row statistics and accumulators.
//
// Replaces the two backward TPU kernels of trace_tpu/kernels/flash_backward.py
// (_dq_kernel and _dkv_kernel, FlashAttention-2 order) and the XLA code
// around them (delta = rowsum(do * o); the sum of dk/dv over the query heads
// of a kv head):
//   p  = exp(s - lse)           s = q k^T * scale + bias (+ causal mask)
//   dv = p^T do
//   ds = p * (do v^T - delta)
//   dq = ds k * scale           dk = ds^T q * scale
//
// Bound on an H100: operations. At the training shape (B = 2, 32 / 8 heads,
// T = 2048, hd = 128, causal, one row right-padded by 300) one product over
// the visible pairs is ~29.7 GFLOP; dq needs 3 (0.090 ms at the bf16 peak),
// dk/dv 4 (0.120 ms), over ~100 MB of operands.
//
// Design: the forward's (attention.cu) on both kernels. A block has three
// warpgroups: a producer, whose one warp issues TMA copies of 64-column
// boxes in the 128-byte swizzle (per-launch 4-D tensor maps), and two
// consumer warpgroups that run every product as wgmma with fp32
// accumulators in registers (at hd = 128 setmaxnreg gives them 240
// registers a thread, the producer 24).
//   * attn_bwd_dq_kernel: a block owns 128 query rows of one (head, batch
//     row), 64 to a consumer warpgroup. Q and dO are copied once; K and V
//     tiles of 64 keys stream through a ring of 4 stages (full and empty
//     mbarriers), each with its keys' bias in log2 units (-inf past Tk),
//     which the producer warp stages beside the tile: read by every
//     consumer thread from global memory instead, it cost a third of the
//     kernel's time. Per tile a warpgroup runs S = Q K^T and dP = dO V^T (both
//     operands K-major from shared memory), forms ds = p (dP - delta) on the
//     accumulators, p = 2^(s scale log2(e) + bias log2(e) - lse log2(e)) by
//     ex2, and adds dS K into its 64 x hd dQ: dS from registers (the
//     accumulator layout is the A-fragment layout, packed to bf16 pairs), K
//     read MN-major through the transpose bit.
//   * attn_bwd_dkv_kernel: a block owns 128 keys of one (kv head, batch row),
//     64 to a consumer warpgroup. K and V are copied once; tiles of 64 query
//     rows of Q and dO stream through the ring over the G query heads of the
//     kv head, one after the other in a fixed order, with the rows' lse and
//     delta, which the producer warp stages in shared memory beside each
//     tile (lse as +inf past Tq: p = 0 on rows the tensor does not hold,
//     whose Q and dO rows TMA fills with zeros; keys past Tk get the bias
//     -inf). Per tile: S^T = K Q^T and dP^T = V dO^T (A = K or V, B = Q or
//     dO, K-major), p^T and ds^T on the accumulators, then dV += P^T dO and
//     dK += dS^T Q with A from registers and dO, Q read MN-major from the
//     same swizzled tiles. The group sum
//     thus happens in registers: no per-query-head copy of dk/dv and no
//     float atomics, so a step repeats bit for bit.
//   * Causal tiles that see nothing are skipped: key tiles past a dq
//     warpgroup's last row, query tiles before a dk/dv warpgroup's first key.
//     The blocks with the most work are issued first (the last query tile for
//     dq, key tile 0 for dk/dv). The causal mask only on tiles that cross
//     the diagonal, each form one straight block of code (a template
//     argument).
//   * Outputs are staged through the warpgroup's own rows of a resident tile
//     (Q for dq, K and V for dk and dv) and written as 16-byte rows.
//   * attn_bwd_delta_kernel: delta = rowsum(do * o), one warp per row.
// p and ds are rounded to bf16 before their second product (p^T do, ds k,
// ds^T q), as the forward rounds p before p v; the plain version keeps them
// in fp32, and the comparison's tolerance says so. What now sets the pace
// (PERF.md): the two kernels recompute s and do v^T (7 products for
// the function's 5); within a warpgroup the elementwise step between its
// products waits on the first and holds back the second, and only the other
// warpgroup hides it; S and dP (S^T and dP^T) are m64n64 products with both
// operands in shared memory. A warpgroup that issues its next products
// before the elementwise step needs more registers than hd = 128 leaves:
// tried, the compiler serialized the products or spilled.
//
// Masks are finite, as in the JAX package: a masked score is -1e30 (in log2
// units -1e30 * log2(e), finite in fp32). A query row that sees no key has
// lse = -1e30 and p = 2^0 = 1 on every key tile this kernel visits; the TPU
// kernel visits the causally masked tiles too. Such rows are padding and
// carry do = 0 in training, where both give zero.

#include "attention_common.cuh"

namespace {

constexpr int CONSUMERS = 2;                    // consumer warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int BM = 128;  // rows a block owns: query rows (dq), keys (dk/dv)
constexpr int BN = 64;   // rows of a streamed tile: keys (dq), query rows (dk/dv)
// a masked score in log2 units. lse and bias are scaled with __fmul_rn, never
// contracted into an fma, so that a masked bias or the lse = -1e30 of a row
// that sees no key become exactly this value.
constexpr float MASKED = NEG_INF * LOG2E;

struct BwdParams {
  const float* bias;   // [B, Tk] additive, or null
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  bf16* dq;            // [B, H, Tq, hd]
  bf16* dk;            // [B, H / group, Tk, hd]
  bf16* dv;
  int H, group, tq, tk, causal;
  float scale, scale_log2;
  int qfold, kfold;    // the operand's map is (h*hd + column, token, batch)
};

// Shared memory of a block: two resident tiles of BM rows (Q and dO, or K
// and V), a ring of STAGES pairs of streamed tiles of BN rows (K and V, or Q
// and dO), the streamed rows' bias (dq) or lse and delta (dk/dv), then the
// mbarriers: resident full, full per stage, empty per stage.
template <int HD>
struct Cfg {
  static constexpr int STAGES = 4;
  static constexpr int RES = BM * HD * 2;   // a resident tile, [HD / 64][BM rows][128 B]
  static constexpr int TILE = BN * HD * 2;  // a streamed tile, [HD / 64][BN rows][128 B]
  static constexpr int STAGE = 2 * TILE;
  static constexpr int STAT_OFF = 2 * RES + STAGES * STAGE;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BN * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
};
static_assert(Cfg<128>::SMEM <= 232448 && Cfg<64>::SMEM <= 232448, "shared memory");

template <int HD>
struct Bars {
  uint32_t res_full, full, empty;  // full and empty: stage 0's, 8 bytes a stage
  __device__ explicit Bars(uint32_t base)
      : res_full(base + Cfg<HD>::BAR_OFF), full(res_full + 8),
        empty(full + 8 * Cfg<HD>::STAGES) {}
};

// the block's barriers, by thread 0: a stage is full after 33 arrivals of the
// producer warp (lane 0's, announcing the bytes of its copies, then every
// lane's after its stores) and those bytes, empty after every consumer
// thread's arrival
template <int HD>
__device__ __forceinline__ void init_barriers(uint32_t base) {
  if (threadIdx.x == 0) {
    const Bars<HD> bar(base);
    mbar_init(bar.res_full, 1);
    for (int i = 0; i < Cfg<HD>::STAGES; ++i) {
      mbar_init(bar.full + 8 * i, 33);
      mbar_init(bar.empty + 8 * i, 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A warpgroup's accumulator [64 x HD] times `scale` as bf16 into `stage`, its
// 64 rows of a resident tile whose wgmma reads are done (boxes BM rows apart,
// 16-byte chunks swizzled by row against bank conflicts)
template <int HD>
__device__ __forceinline__ void stage_rows(unsigned char* stage, const float (&acc)[HD / 2],
                                           float scale, int warp, int g, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(stage + (n / 8) * BM * ROW_BYTES + r * ROW_BYTES +
                                   (((n % 8) ^ (r & 7)) << 4) + 4 * t) =
          pack(acc[4 * n + 2 * hh] * scale, acc[4 * n + 2 * hh + 1] * scale);
  }
}

// the staged rows r < valid as 16-byte stores to out[r * HD ..]
template <int HD>
__device__ __forceinline__ void write_rows(const unsigned char* stage, bf16* out, int valid) {
  for (int i = threadIdx.x % 128; i < 64 * (HD / 8); i += 128) {
    const int r = i / (HD / 8), n = i % (HD / 8);
    if (r >= valid) break;  // rows only grow with i
    *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * HD + 8 * n) =
        *reinterpret_cast<const uint4*>(stage + (n / 8) * BM * ROW_BYTES + r * ROW_BYTES +
                                        (((n % 8) ^ (r & 7)) << 4));
  }
}

// ---------------------------------------------------------------- dq

// One warp: Q and dO of the block once (lane 0), then per key tile j its K
// and V tiles (lane 0) and its keys' bias in log2 units, -inf past Tk (p = 0
// on keys the tensor does not hold, whose K and V rows TMA fills with
// zeros; every lane), into the tile's stage. A stage is full after 33
// arrivals: lane 0's with the copies' bytes, then every lane's after its
// stores.
template <int HD>
__device__ __forceinline__ void dq_produce(const CUtensorMap* qmap, const CUtensorMap* domap,
                                           const CUtensorMap* kmap, const CUtensorMap* vmap,
                                           const BwdParams& p, unsigned char* smem, int h, int b,
                                           int q0, int ntiles) {
  using C = Cfg<HD>;
  const uint32_t base = smem_u32(smem);
  const Bars<HD> bar(base);
  const int kvh = h / p.group, lane = threadIdx.x % 32;
  const float* const bias = p.bias ? p.bias + static_cast<long long>(b) * p.tk : nullptr;
  if (lane == 0) {
    mbar_arrive_tx(bar.res_full, 2 * C::RES);
    load_rows<HD>(base, qmap, p.qfold, bar.res_full, q0, h, b, BM);
    load_rows<HD>(base + C::RES, domap, p.qfold, bar.res_full, q0, h, b, BM);
  }
  for (int j = 0; j < ntiles; ++j) {
    const int slot = j % C::STAGES;
    if (j >= C::STAGES) mbar_wait(bar.empty + 8 * slot, ((j / C::STAGES) - 1) & 1);
    if (lane == 0) {
      const uint32_t ks = base + 2 * C::RES + slot * C::STAGE;
      mbar_arrive_tx(bar.full + 8 * slot, C::STAGE);
      load_rows<HD>(ks, kmap, p.kfold, bar.full + 8 * slot, j * BN, kvh, b, BN);
      load_rows<HD>(ks + C::TILE, vmap, p.kfold, bar.full + 8 * slot, j * BN, kvh, b, BN);
    }
    float* const st = reinterpret_cast<float*>(smem + C::STAT_OFF) + slot * 2 * BN;
    for (int i = lane; i < BN; i += 32) {
      const int jj = j * BN + i;
      st[i] = jj >= p.tk ? -INFINITY : bias ? __fmul_rn(bias[jj], LOG2E) : 0.f;
    }
    mbar_arrive(bar.full + 8 * slot);
  }
}

// ds = p (dp - delta) of one key tile in registers, s becoming ds: s[4c +
// 2hh + e] is row row[hh], key k0 + 8c + 2t + e, whose bias is bl[8c + 2t +
// e]. DIAG adds the causal mask (keys after the row), so that each form is
// one straight block of code.
template <bool DIAG>
__device__ __forceinline__ void dq_ds(float (&s)[BN / 2], const float (&dp)[BN / 2],
                                      const float* bl, float scale_log2, int k0,
                                      const int (&row)[2], const float (&lse)[2],
                                      const float (&delta)[2], int t) {
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
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

template <int HD>
__device__ __forceinline__ void dq_consume(const BwdParams& p, unsigned char* smem, int h, int b,
                                           int q0, int ntiles) {
  using C = Cfg<HD>;
  const uint32_t base = smem_u32(smem);
  const Bars<HD> bar(base);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg;  // the warpgroup's first query row
  const int row[2] = {row0 + 16 * warp + g, row0 + 16 * warp + g + 8};
  // key tiles this warpgroup needs: none past its last row (causal), none
  // at all when its rows lie past Tq
  const int wg_end = p.causal ? min(p.tk, row0 + 64) : p.tk;
  const int nt = row0 >= p.tq ? 0 : (wg_end + BN - 1) / BN;
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
    float s[BN / 2], dp[BN / 2];
    wgmma_fence();
    nt_product<HD, BN>(s, qa, BM, ks);             // S = Q K^T
    nt_product<HD, BN>(dp, doa, BM, ks + C::TILE);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    const int k0 = j * BN;
    const float* const bl = stats + slot * 2 * BN;
    if (p.causal && k0 + BN - 1 > row0)  // the tile crosses the diagonal
      dq_ds<true>(s, dp, bl, p.scale_log2, k0, row, lse, delta, t);
    else
      dq_ds<false>(s, dp, bl, p.scale_log2, k0, row, lse, delta, t);
    uint32_t da[BN / 16][4];
    pack_frags<BN>(da, s);
    wgmma_fence();
    pn_product<HD, BN>(dq, da, ks);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq);
    mbar_arrive(bar.empty + 8 * slot);
  }

  unsigned char* const stage = smem + wg * 64 * ROW_BYTES;  // the warpgroup's rows of Q
  stage_rows<HD>(stage, dq, p.scale, warp, g, t);
  consumer_sync(wg);
  if (row0 < p.tq) write_rows<HD>(stage, p.dq + (qrow + row0) * HD, p.tq - row0);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap domap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int h = blockIdx.x, b = blockIdx.y;
  // causal q tiles longest first: the last tile sees the most keys
  const int q0 = (p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BM;
  const int k_end = p.causal ? min(p.tk, q0 + BM) : p.tk;
  const int ntiles = (k_end + BN - 1) / BN;
  init_barriers<HD>(base);
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) >= CONSUMERS) {
    if constexpr (HD == 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x / 32 == 4 * CONSUMERS)
      dq_produce<HD>(&qmap, &domap, &kmap, &vmap, p, smem, h, b, q0, ntiles);
    return;
  }
  // at hd = 128 a consumer thread holds dQ (64), S and dP (32 each) and dS
  if constexpr (HD == 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  dq_consume<HD>(p, smem, h, b, q0, ntiles);
}

// ---------------------------------------------------------------- dk, dv

// One warp: K and V of the block once (lane 0), then per step ``it`` query
// head kvh * G + it / nqt, query tile qt_start + it % nqt: its Q and dO tiles
// (lane 0) and its rows' lse (log2 units, +inf past Tq) and delta (every
// lane) into the step's stage. A stage is full after 33 arrivals: lane 0's
// with the copies' bytes, then every lane's after its stores.
template <int HD>
__device__ __forceinline__ void dkv_produce(const CUtensorMap* qmap, const CUtensorMap* domap,
                                            const CUtensorMap* kmap, const CUtensorMap* vmap,
                                            const BwdParams& p, unsigned char* smem, int kvh,
                                            int b, int k0, int qt_start, int nqt, int total) {
  using C = Cfg<HD>;
  const uint32_t base = smem_u32(smem);
  const Bars<HD> bar(base);
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_arrive_tx(bar.res_full, 2 * C::RES);
    load_rows<HD>(base, kmap, p.kfold, bar.res_full, k0, kvh, b, BM);
    load_rows<HD>(base + C::RES, vmap, p.kfold, bar.res_full, k0, kvh, b, BM);
  }
  for (int it = 0; it < total; ++it) {
    const int slot = it % C::STAGES;
    if (it >= C::STAGES) mbar_wait(bar.empty + 8 * slot, ((it / C::STAGES) - 1) & 1);
    const int hq = kvh * p.group + it / nqt;
    const int q0 = (qt_start + it % nqt) * BN;
    if (lane == 0) {
      const uint32_t qs = base + 2 * C::RES + slot * C::STAGE;
      mbar_arrive_tx(bar.full + 8 * slot, C::STAGE);
      load_rows<HD>(qs, qmap, p.qfold, bar.full + 8 * slot, q0, hq, b, BN);
      load_rows<HD>(qs + C::TILE, domap, p.qfold, bar.full + 8 * slot, q0, hq, b, BN);
    }
    const long long qrow = (static_cast<long long>(b) * p.H + hq) * p.tq + q0;
    float* const st = reinterpret_cast<float*>(smem + C::STAT_OFF) + slot * 2 * BN;
    for (int i = lane; i < BN; i += 32) {
      const bool in = q0 + i < p.tq;
      st[i] = in ? __fmul_rn(p.lse[qrow + i], LOG2E) : INFINITY;
      st[BN + i] = in ? p.delta[qrow + i] : 0.f;
    }
    mbar_arrive(bar.full + 8 * slot);
  }
}

// p^T and ds^T of one query tile in registers, s becoming p^T and dp ds^T:
// s[4c + 2hh + e] is key key[hh], query row q0 + 8c + 2t + e, whose lse and
// delta are st[8c + 2t + e] and st[BN + 8c + 2t + e]. DIAG adds the causal
// mask (keys after the row).
template <bool DIAG>
__device__ __forceinline__ void dkv_ds(float (&s)[BN / 2], float (&dp)[BN / 2], const float* st,
                                       const BwdParams& p, int q0, const int (&key)[2],
                                       const float (&bk)[2], int t) {
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const float2 l = *reinterpret_cast<const float2*>(st + 8 * c + 2 * t);
    const float2 d = *reinterpret_cast<const float2*>(st + BN + 8 * c + 2 * t);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * c + 2 * hh + e;
        float x = fmaf(s[i], p.scale_log2, bk[hh]);
        if (DIAG) x = key[hh] > q0 + 8 * c + 2 * t + e ? MASKED : x;
        const float pr = ex2(x - (e ? l.y : l.x));
        s[i] = pr;
        dp[i] = pr * (dp[i] - (e ? d.y : d.x));
      }
  }
}

template <int HD>
__device__ __forceinline__ void dkv_consume(const BwdParams& p, unsigned char* smem, int kvh,
                                            int b, int k0, int qt_start, int nqt, int total) {
  using C = Cfg<HD>;
  const uint32_t base = smem_u32(smem);
  const Bars<HD> bar(base);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key0 = k0 + 64 * wg;  // the warpgroup's first key
  const int key[2] = {key0 + 16 * warp + g, key0 + 16 * warp + g + 8};
  float bk[2];  // the bias of the thread's keys, log2 units; -inf past Tk (p = 0)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    bk[hh] = key[hh] >= p.tk ? -INFINITY
             : p.bias ? __fmul_rn(p.bias[static_cast<long long>(b) * p.tk + key[hh]], LOG2E)
                      : 0.f;
  const uint32_t ka = base + wg * 64 * ROW_BYTES, va = ka + C::RES;
  const float* const stats = reinterpret_cast<const float*>(smem + C::STAT_OFF);

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar.res_full, 0);
  for (int it = 0; it < total; ++it) {
    const int slot = it % C::STAGES;
    mbar_wait(bar.full + 8 * slot, (it / C::STAGES) & 1);
    const int q0 = (qt_start + it % nqt) * BN;
    // nothing to add: the warpgroup's keys lie past Tk, or (causal) every
    // row of the tile lies before its first key
    if (key0 >= p.tk || (p.causal && q0 + BN - 1 < key0)) {
      mbar_arrive(bar.empty + 8 * slot);
      continue;
    }
    const uint32_t qs = base + 2 * C::RES + slot * C::STAGE, dos = qs + C::TILE;
    float s[BN / 2], dp[BN / 2];
    wgmma_fence();
    nt_product<HD, BN>(s, ka, BM, qs);    // S^T = K Q^T
    nt_product<HD, BN>(dp, va, BM, dos);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    const float* const st = stats + slot * 2 * BN;
    if (p.causal && key0 + 63 > q0)  // the tile crosses the diagonal
      dkv_ds<true>(s, dp, st, p, q0, key, bk, t);
    else
      dkv_ds<false>(s, dp, st, p, q0, key, bk, t);
    uint32_t pa[BN / 16][4], da[BN / 16][4];
    pack_frags<BN>(pa, s);
    pack_frags<BN>(da, dp);
    wgmma_fence();
    pn_product<HD, BN>(dv, pa, dos);  // dV += P^T dO
    pn_product<HD, BN>(dk, da, qs);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dk);
    fence_operands(dv);
    mbar_arrive(bar.empty + 8 * slot);
  }

  unsigned char* const stage = smem + wg * 64 * ROW_BYTES;  // the warpgroup's rows of K, then V
  stage_rows<HD>(stage, dk, p.scale, warp, g, t);
  stage_rows<HD>(stage + C::RES, dv, 1.f, warp, g, t);
  consumer_sync(wg);
  if (key0 < p.tk) {
    const long long off =
        ((static_cast<long long>(b) * (p.H / p.group) + kvh) * p.tk + key0) * HD;
    write_rows<HD>(stage, p.dk + off, p.tk - key0);
    write_rows<HD>(stage + C::RES, p.dv + off, p.tk - key0);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap domap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BM;  // causal: key tile 0 sees the most rows and goes first
  // query tiles whose last row lies before the block's first key are
  // causally masked for every key of the block
  const int qt_start = p.causal ? k0 / BN : 0;
  const int nqt = (p.tq + BN - 1) / BN - qt_start;
  const int total = nqt > 0 ? p.group * nqt : 0;
  init_barriers<HD>(base);
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) >= CONSUMERS) {
    if constexpr (HD == 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x / 32 == 4 * CONSUMERS)
      dkv_produce<HD>(&qmap, &domap, &kmap, &vmap, p, smem, kvh, b, k0, qt_start, nqt, total);
    return;
  }
  // at hd = 128 a consumer thread holds dK and dV (64 each), S^T and dP^T
  // (32 each)
  if constexpr (HD == 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  dkv_consume<HD>(p, smem, kvh, b, k0, qt_start, nqt, total);
}

// delta[row] = sum_c do[row, c] * o[row, c] in fp32, one warp per row, the
// lanes' partial sums added in a fixed order
__global__ void attn_bwd_delta_kernel(const bf16* o, const bf16* d_o, float* delta,
                                      long long rows, int hd) {
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32)
                        + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const bf16* a = o + row * hd;
  const bf16* d = d_o + row * hd;
  float sum = 0.f;
  for (int c = 2 * lane; c < hd; c += 64) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + c));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + c));
    sum += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

struct Operands {
  const void *q, *k, *v, *d_o;
  int B;
};

// One launch of the dq (DQ) or the dk/dv kernel: tensor maps of the
// contiguous q, do [B, H, Tq, hd] and k, v [B, H / group, Tk, hd] with boxes
// of the rows each kernel keeps resident (BM) or streams (BN)
template <int HD, bool DQ>
int launch(BwdParams p, const Operands& a, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int hkv = p.H / p.group;
  const int qrows = DQ ? BM : BN, krows = DQ ? BN : BM;
  const long long qh = static_cast<long long>(p.tq) * HD, kh = static_cast<long long>(p.tk) * HD;
  CUtensorMap qmap, domap, kmap, vmap;
  int err = make_map(&qmap, &p.qfold, a.q, HD, p.H, p.tq, a.B, p.H * qh, qh, HD, qrows);
  if (err == 0)
    err = make_map(&domap, &p.qfold, a.d_o, HD, p.H, p.tq, a.B, p.H * qh, qh, HD, qrows);
  if (err == 0) err = make_map(&kmap, &p.kfold, a.k, HD, hkv, p.tk, a.B, hkv * kh, kh, HD, krows);
  if (err == 0) err = make_map(&vmap, &p.kfold, a.v, HD, hkv, p.tk, a.B, hkv * kh, kh, HD, krows);
  if (err != 0) return err;
  const auto kernel = DQ ? attn_bwd_dq_kernel<HD> : attn_bwd_dkv_kernel<HD>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid = DQ ? dim3(p.H, a.B, (p.tq + BM - 1) / BM) : dim3(hkv, a.B, (p.tk + BM - 1) / BM);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(qmap, domap, kmap, vmap, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool DQ>
int launch_hd(const BwdParams& p, const Operands& a, int hd, cudaStream_t stream) {
  if (a.B < 1 || p.H < 1 || p.group < 1 || p.H % p.group || p.tq < 1 || p.tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 128) return launch<128, DQ>(p, a, stream);
  if (hd == 64) return launch<64, DQ>(p, a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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

extern "C" int attn_bwd_delta_bf16(const void* o, const void* d_o, float* delta,
                                   long long rows, int hd, void* stream) {
  if (hd % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = 8;
  const unsigned blocks = static_cast<unsigned>((rows + warps - 1) / warps);
  attn_bwd_delta_kernel<<<blocks, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(d_o), delta, rows, hd);
  return static_cast<int>(cudaGetLastError());
}

// All tensors contiguous and 16-byte aligned: q, d_o, dq [B, H, Tq, hd];
// k, v [B, H / group, Tk, hd]; bias [B, Tk] or null; lse, delta [B, H, Tq].
extern "C" int attn_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const float* bias, const void* d_o,
    const float* lse, const float* delta, void* dq, int B, int H, int group, int tq,
    int tk, int hd, int causal, float scale, void* stream) {
  BwdParams p = make_params(bias, lse, delta, H, group, tq, tk, causal, scale);
  p.dq = static_cast<bf16*>(dq);
  const Operands a = {q, k, v, d_o, B};
  return launch_hd<true>(p, a, hd, static_cast<cudaStream_t>(stream));
}

// As attn_bwd_dq_bf16; dk, dv [B, H / group, Tk, hd], summed over each kv
// head's ``group`` query heads.
extern "C" int attn_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const float* bias, const void* d_o,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H, int group,
    int tq, int tk, int hd, int causal, float scale, void* stream) {
  BwdParams p = make_params(bias, lse, delta, H, group, tq, tk, causal, scale);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  const Operands a = {q, k, v, d_o, B};
  return launch_hd<false>(p, a, hd, static_cast<cudaStream_t>(stream));
}
