// Attention forward for Hopper (sm_90a): bf16 in, bf16 out, fp32 softmax
// statistics and accumulators.
//
// One kernel serves three TPU kernels:
//   * flash_attention (_attn_kernel) of trace_tpu/kernels/flash_attention.py:
//     causal GQA prefill attention over [B, H, T, hd] with an additive fp32
//     [B, Tk] padding bias; with a query offset for a chunk of a chunked
//     prefill (query row r sits at position q_offset + r of the cache stripe
//     and sees the keys j <= q_offset + r; 0 for a whole prefill);
//   * vit_attention_btd (_btd_kernel), same file: bidirectional ViT attention
//     read and written in place in the [B, P, D] layout (head h = columns
//     h*hd..), keys >= kv_len masked;
//   * flash_attention_fwd_res (_fwd_res_kernel) of
//     trace_tpu/kernels/flash_backward.py: the same forward, which with an
//     ``lse`` pointer also writes each query row's fp32 natural-log
//     logsumexp m + log(sum exp(s - m)), the residual of attention_bwd.cu.
// The caller passes element strides for (batch, head, token) of q, k, v and
// o; the operands are read through TMA tensor maps built from them: a
// [B, H, T, hd] operand as a 4-D map (column, token, head, batch), the ViT's
// column slices of the fused [B, P, 3D] projection, whose heads are
// neighbouring 64- or 128-column blocks of a row, as a 3-D map (h*hd +
// column, token, batch) with the slice's own row stride and base pointer.
//
// Bound on an H100: operations at the prefill shape (~59 GFLOP of visible
// causal pairs, 0.060 ms at the bf16 peak); the ViT chunk sits at the ridge
// (~22 GFLOP over ~76 MB, 0.023 ms by bytes), and there the exponentials
// (one per score, 16 a cycle on an SM) take as long as the products.
//
// Design (FlashAttention-3's shape, without its ping-pong scheduling): a block
// owns 128 query rows of one (head, batch row) and has three warpgroups.
//   * The producer: one thread issues TMA copies, Q once, then K and V tiles
//     of 128 keys into a ring of 2 stages at hd = 128 (all the shared memory
//     there is) and 3 at hd = 64, with full and empty mbarriers per stage;
//     at hd = 256 tiles of 64 keys, 2 stages (Q alone is 64 KB there, and a
//     stage of 128-key tiles 128 KB). Every tile sits in shared memory in
//     the 128-byte swizzle as 64-column boxes (HD / 64 per row).
//     Rows past Tk arrive zero-filled and are masked below.
//   * Two consumer warpgroups of 64 query rows each. Per key tile:
//     S = Q K^T as wgmma.mma_async m64n128k16 (Q and K both K-major from
//     shared memory), then the online softmax on the accumulator registers
//     (a thread holds rows 16w+g and 16w+g+8; scores prescaled by
//     scale * log2(e), ex2; the row max reduced over the quad, the row sum
//     kept per thread until the end), O rescaled, and O += P V as wgmma
//     m64nHDk16 with P from registers: the S accumulator layout is the A
//     fragment layout, so P is the accumulator packed to bf16 pairs, and V is
//     read MN-major through the transpose bit. Then the stage is released.
//     At hd = 128 that is 160 accumulator and fragment registers a thread,
//     at hd = 256 (S of 64 keys, O m64n256k16) 192 with the tile's bias:
//     setmaxnreg moves registers from the producer warpgroup (24) to the
//     consumers (240).
//   * Causal blocks are issued longest first (the q-tile index is the
//     slowest grid dimension, reversed), key tiles past a warpgroup's last
//     row are skipped, and a warpgroup whose rows all lie past Tq does no
//     work. The epilogue stages O through the warpgroup's own rows of the Q
//     tile so that each thread writes 16-byte rows of o.
// What sets the pace (PERF.md): the softmax between a warpgroup's two
// products; with it cut out, the products and copies alone run much faster.
// Each form of the softmax (with or without a bias, with or without
// masks) is one straight block of code: with a branch per score the compiler
// scheduled dozens of small blocks and the kernel ran markedly slower. The
// two consumer warpgroups are not ordered against each other, so they tend
// to reach their softmax together; a ping-pong order between them and an S
// product issued ahead of the softmax inside a warpgroup were tried (with
// 64-key tiles at hd = 128), and each gained a few percent at hd = 128 and
// lost at hd = 64 (registers), so neither is kept. The sums run in a fixed
// order and nothing is atomic: a repeat gives the same bits.
//
// Masks use the finite -1e30 of the JAX package, never -inf (keys past Tk,
// which the tensor does not hold, are dropped). A query row that sees no key
// (with a bias: every key it may reach has a bias <= -1e29; a left-padded
// prefill's pad rows) gets the mean of v over the Tk keys, as the plain
// version gives it: every score of such a row is the same -1e30, so its
// softmax is uniform (and so is the Pallas kernel's over its 128-key tiles
// when Tk is a multiple of 128). The main kernel leaves such rows to a second
// launch, unseen_rows_kernel, which writes that mean over them. Their values
// matter: a routed MoE layer gives pad rows bucket slots before the real
// tokens. The lse of such a row is written as -1e30 + log(l), exactly -1e30,
// as the plain version's.

#include "attention_common.cuh"

namespace {

constexpr int BQ = 128;         // query rows of a block
constexpr int CONSUMERS = 2;    // consumer warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr float M_INIT = -1e38f;  // running-max start, below any masked score
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Cfg {
  // keys per tile: 128, and 64 at hd = 256, where a stage of 128-key K and V
  // tiles (128 KB) would leave room beside Q's 64 KB for one stage alone
  static constexpr int BK = HD == 256 ? 64 : 128;
  // K/V tiles in flight: at hd = 128 two stages of 64 KB fill the shared
  // memory beside Q's 32 KB; at hd = 256 two stages of 64 KB (64 keys)
  // beside Q's 64 KB
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  static constexpr int Q_BYTES = BQ * HD * 2;      // [HD / 64][BQ rows][128 B]
  static constexpr int KV_BYTES = BK * HD * 2;     // a K or a V tile, [HD / 64][BK rows][128 B]
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;  // + alignment
};
static_assert(Cfg<256>::SMEM <= 232448 && Cfg<128>::SMEM <= 232448 &&
                  Cfg<64>::SMEM <= 232448, "shared memory");

struct Params {
  const float* bias;  // [B, Tk] additive, or null
  bf16* o;
  float* lse;         // [B, H, Tq] natural-log logsumexp per query row, or null
  int H, group, tq, tk, kv_len, causal;
  int q_offset;       // causal: query row r sits at position q_offset + r
  float scale_log2;   // hd^-0.5 * log2(e)
  long long sob, soh, sot, sbias;
  int qfold, kfold, vfold;  // the operand's map is (h*hd + column, token, batch)
};

template <int HD>
__device__ __forceinline__ void produce(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, const Params& p, uint32_t base,
                                        int h, int b, int q0, int ntiles) {
  using C = Cfg<HD>;
  const uint32_t q_full = base + C::BAR_OFF;
  constexpr int STAGES = C::STAGES;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;
  const int kvh = h / p.group;
  mbar_arrive_tx(q_full, C::Q_BYTES);
  load_rows<HD>(base, qmap, p.qfold, q_full, q0, h, b, BQ);
  for (int j = 0; j < ntiles; ++j) {
    const int slot = j % STAGES;
    if (j >= STAGES) mbar_wait(empty + 8 * slot, ((j / STAGES) - 1) & 1);
    const uint32_t ks = base + C::Q_BYTES + slot * C::STAGE;
    mbar_arrive_tx(k_full + 8 * slot, C::KV_BYTES);
    load_rows<HD>(ks, kmap, p.kfold, k_full + 8 * slot, j * C::BK, kvh, b, C::BK);
    mbar_arrive_tx(v_full + 8 * slot, C::KV_BYTES);
    load_rows<HD>(ks + C::KV_BYTES, vmap, p.vfold, v_full + 8 * slot, j * C::BK, kvh, b, C::BK);
  }
}

// epilogue: o / l through the warpgroup's own rows of the Q tile (its
// wgmma reads of them are done), then 16-byte rows of o; lse
template <int HD>
__device__ __forceinline__ void finish(const Params& p, unsigned char* smem, int h, int b,
                                       int row0, const int (&row)[2], const float (&m)[2],
                                       const float (&l)[2], const float (&o)[HD / 2], int warp,
                                       int g, int t) {
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  unsigned char* const stage = smem + wg * 64 * ROW_BYTES;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int r = 16 * warp + g + 8 * hh;
    if (p.lse && t == 0 && row[hh] < p.tq) {
      // a row that saw no key keeps m = -1e30 in natural-log units too
      const float mn = m[hh] <= NEG_INF ? NEG_INF : m[hh] * LN2;
      p.lse[(static_cast<long long>(b) * p.H + h) * p.tq + row[hh]] = mn + logf(fmaxf(lt, 1e-30f));
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(stage + (n / 8) * BQ * ROW_BYTES + r * ROW_BYTES +
                                   (((n % 8) ^ (r & 7)) << 4) + 4 * t) =
          pack(o[4 * n + 2 * hh] * inv, o[4 * n + 2 * hh + 1] * inv);
  }
  consumer_sync(wg);
  bf16* const og = p.o + b * p.sob + h * p.soh;
  for (int i = threadIdx.x % 128; i < 64 * (HD / 8); i += 128) {
    const int r = i / (HD / 8), n = i % (HD / 8);
    if (row0 + r >= p.tq) break;  // rows only grow with i
    *reinterpret_cast<uint4*>(og + static_cast<long long>(row0 + r) * p.sot + 8 * n) =
        *reinterpret_cast<const uint4*>(stage + (n / 8) * BQ * ROW_BYTES + r * ROW_BYTES +
                                        (((n % 8) ^ (r & 7)) << 4));
  }
}


// The bias of the thread's keys of a tile, log2 units (loaded while the
// tile's S product runs)
template <int BK>
__device__ __forceinline__ void load_bias(float (&bl)[BK / 4], const Params& p,
                                          const float* bias, int k0, int t) {
  if (!bias) return;
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) {
    const int jj = k0 + 8 * (i / 2) + 2 * t + (i % 2);
    bl[i] = jj < p.tk ? bias[jj] * LOG2E : 0.f;
  }
}

// The online softmax of one S tile in registers: scale (log2 units), bias,
// masks, the running max and the thread's share of the row sums; s becomes
// the unnormalized probabilities, alpha the factor O must be rescaled by.
// Max and sum run as four interleaved chains, not one. EDGE and BIAS are
// template arguments so that each form is one straight block of code:
// a branch per score would cut the compiler's scheduling into pieces.
// lim: the keys j < lim[hh] that row hh may see (kv_len, and the diagonal).
template <int HD, bool EDGE, bool BIAS>
__device__ __forceinline__ void softmax_tile(float (&s)[Cfg<HD>::BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const float (&bl)[Cfg<HD>::BK / 4],
                                             const Params& p, int k0, const int (&lim)[2],
                                             int t) {
  constexpr int BK = Cfg<HD>::BK;
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
template <int HD>
__device__ __forceinline__ void softmax_any(float (&s)[Cfg<HD>::BK / 2], float (&m)[2],
                                            float (&l)[2], float (&alpha)[2],
                                            const float (&bl)[Cfg<HD>::BK / 4],
                                            const Params& p, bool bias, int k0, bool edge,
                                            const int (&lim)[2], int t) {
  if (bias) {
    if (edge) softmax_tile<HD, true, true>(s, m, l, alpha, bl, p, k0, lim, t);
    else softmax_tile<HD, false, true>(s, m, l, alpha, bl, p, k0, lim, t);
  } else {
    if (edge) softmax_tile<HD, true, false>(s, m, l, alpha, bl, p, k0, lim, t);
    else softmax_tile<HD, false, false>(s, m, l, alpha, bl, p, k0, lim, t);
  }
}

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    o[4 * n] *= alpha[0];
    o[4 * n + 1] *= alpha[0];
    o[4 * n + 2] *= alpha[1];
    o[4 * n + 3] *= alpha[1];
  }
}

template <int HD>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, int h, int b,
                                        int q0, int ntiles) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  const uint32_t base = smem_u32(smem);
  const uint32_t q_full = base + C::BAR_OFF;
  constexpr int STAGES = C::STAGES;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
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
  const uint32_t qa = base + wg * 64 * ROW_BYTES;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {M_INIT, M_INIT};  // running max, log2 units
  float l[2] = {0.f, 0.f};        // this thread's share of the row sums

  mbar_wait(q_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int slot = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    mbar_wait(k_full + 8 * slot, parity);
    if (j >= nt) {  // past the warpgroup's rows: release the stage unread
      mbar_arrive(empty + 8 * slot);
      continue;
    }
    const uint32_t ks = base + C::Q_BYTES + slot * C::STAGE;
    float s[BK / 2];  // s[4c + 2hh + e]: row row[hh], key k0 + 8c + 2t + e
    wgmma_fence();
    nt_product<HD, BK>(s, qa, BQ, ks);  // S = Q K^T
    wgmma_commit();
    const int k0 = j * BK;
    float bl[BK / 4];
    load_bias<BK>(bl, p, bias, k0, t);
    wgmma_wait<0>();
    fence_operands(s);
    // masks only on tiles that reach past the keys or above a row's diagonal
    const bool edge = k0 + BK > kv_lim || (p.causal && k0 + BK - 1 > p.q_offset + row0);
    float alpha[2];
    softmax_any<HD>(s, m, l, alpha, bl, p, bias != nullptr, k0, edge, lim, t);
    rescale<HD>(o, alpha);
    uint32_t pa[BK / 16][4];
    pack_frags<BK>(pa, s);
    mbar_wait(v_full + 8 * slot, parity);
    wgmma_fence();
    pn_product<HD, BK>(o, pa, ks + C::KV_BYTES);  // O += P V
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    mbar_arrive(empty + 8 * slot);
  }

  finish<HD>(p, smem, h, b, row0, row, m, l, o, warp, g, t);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    attn_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = Cfg<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int h = blockIdx.x, b = blockIdx.y;
  // causal q tiles longest first: the last tile holds the most keys
  const int q0 = (p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BQ;
  const int k_end = p.causal ? min(p.tk, p.q_offset + q0 + BQ) : p.tk;
  const int ntiles = (k_end + C::BK - 1) / C::BK;
  constexpr int STAGES = C::STAGES;
  if (threadIdx.x == 0) {
    const uint32_t q_full = base + C::BAR_OFF;
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(q_full + 8 + 8 * i, 1);                   // K full
      mbar_init(q_full + 8 + 8 * (STAGES + i), 1);        // V full
      mbar_init(q_full + 8 + 8 * (2 * STAGES + i), 128 * CONSUMERS);  // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) >= CONSUMERS) {
    // at hd = 128 a consumer thread holds S (64), O (64) and P (32) of a
    // tile, at hd = 256 S (32), O (128), P (16) and the tile's bias (16):
    // the producer warpgroup gives up its registers to the consumers
    if constexpr (HD >= 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * CONSUMERS) produce<HD>(&qmap, &kmap, &vmap, p, base, h, b, q0, ntiles);
    return;
  }
  if constexpr (HD >= 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  consume<HD>(p, smem, h, b, q0, ntiles);
}

// One consumer warpgroup's P V on a single tile: P [64, BK] row-major bf16
// into the A fragments as the forward forms them, V [BK, HD] through the
// forward's tensor map, load and descriptor; O [64, HD] fp32. Checks the
// MN-major descriptor alone.
template <int HD>
__global__ void __launch_bounds__(128, 1)
    pv_tile_kernel(const __grid_constant__ CUtensorMap vmap, const bf16* P, float* O) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem), bar = base + C::KV_BYTES;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_tx(bar, C::KV_BYTES);
    load_rows<HD>(base, &vmap, 0, bar, 0, 0, 0, BK);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * warp + g + 8 * (i & 1), c = 16 * kk + 8 * (i >> 1) + 2 * t;
      __nv_bfloat162 v = __halves2bfloat162(P[r * BK + c], P[r * BK + c + 1]);
      pa[kk][i] = *reinterpret_cast<uint32_t*>(&v);
    }
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  mbar_wait(bar, 0);
  wgmma_fence();
  pn_product<HD, BK>(o, pa, base);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);
#pragma unroll
  for (int i = 0; i < HD / 2; ++i)
    O[(16 * warp + g + 8 * ((i / 2) % 2)) * HD + 8 * (i / 4) + 2 * t + i % 2] = o[i];
}

// unseen_rows_kernel: a block sums FILL_COLS columns of v over the Tk keys
// of one (kv head, batch row), 16 column pairs x 16 key groups, each key
// group in key order and the groups in group order: a fixed order, so a
// repeat gives the same bits.
constexpr int FILL_COLS = 32;
constexpr int FILL_THREADS = 256;

// The rows of batch row b that see no key get the mean of v over the Tk keys
// (see the note on masks above), in each query head of kv head blockIdx.x.
// Causal, a row r sees the keys j <= q_offset + r below kv_len whose bias is
// above -1e29: the rows with q_offset + r below the first such key see none;
// not causal, every row sees none when no key is visible. Launched after the
// main kernel, only with a bias.
__global__ void __launch_bounds__(FILL_THREADS)
    unseen_rows_kernel(const bf16* v, long long svb, long long svh, long long svt,
                       const Params p) {
  const int kvh = blockIdx.x, b = blockIdx.y, c0 = blockIdx.z * FILL_COLS;
  const float* bias = p.bias + b * p.sbias;
  const int lim = min(p.tk, p.kv_len);
  __shared__ int first;  // the first visible key, lim if none
  __shared__ float2 part[16][16];
  if (threadIdx.x == 0) first = lim;
  __syncthreads();
  for (int j = threadIdx.x; j < lim; j += FILL_THREADS)
    if (bias[j] > -1e29f) {
      atomicMin(&first, j);
      break;
    }
  __syncthreads();
  const int rows = first >= lim ? p.tq : p.causal ? max(0, min(first - p.q_offset, p.tq)) : 0;
  if (rows == 0) return;
  const int cp = threadIdx.x % 16, grp = threadIdx.x / 16;
  const bf16* vb = v + b * svb + kvh * svh + c0 + 2 * cp;
  float2 s = make_float2(0.f, 0.f);
#pragma unroll 8
  for (int j = grp; j < p.tk; j += 16) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(vb + static_cast<long long>(j) * svt));
    s.x += f.x;
    s.y += f.y;
  }
  part[grp][cp] = s;
  __syncthreads();
  if (grp == 0) {
    for (int g = 1; g < 16; ++g) {
      s.x += part[g][cp].x;
      s.y += part[g][cp].y;
    }
    part[0][cp] = make_float2(s.x / p.tk, s.y / p.tk);
  }
  __syncthreads();
  const __nv_bfloat162 mean = __floats2bfloat162_rn(part[0][cp].x, part[0][cp].y);
  for (int i = grp; i < p.group * rows; i += 16) {
    const int h = kvh * p.group + i / rows, r = i % rows;
    *reinterpret_cast<__nv_bfloat162*>(p.o + b * p.sob + h * p.soh +
                                       static_cast<long long>(r) * p.sot + c0 + 2 * cp) = mean;
  }
}

struct Operands {
  const void *q, *k, *v;
  int B, tq, tk;
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt;
};

template <int HD>
int launch(Params p, const Operands& a, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap qmap, kmap, vmap;
  const int hkv = p.H / p.group;
  int err = make_map(&qmap, &p.qfold, a.q, HD, p.H, a.tq, a.B, a.sqb, a.sqh, a.sqt, BQ);
  if (err == 0)
    err = make_map(&kmap, &p.kfold, a.k, HD, hkv, a.tk, a.B, a.skb, a.skh, a.skt, C::BK);
  if (err == 0)
    err = make_map(&vmap, &p.vfold, a.v, HD, hkv, a.tk, a.B, a.svb, a.svh, a.svt, C::BK);
  if (err != 0) return err;
  const auto kernel = attn_fwd_kernel<HD>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(p.H, a.B, (a.tq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(qmap, kmap, vmap, p);
  if (p.bias) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    unseen_rows_kernel<<<dim3(hkv, a.B, HD / FILL_COLS), FILL_THREADS, 0, stream>>>(
        static_cast<const bf16*>(a.v), a.svb, a.svh, a.svt, p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_pv_tile(const void* P, const void* V, float* O, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap vmap;
  int fold;
  const long long tile = static_cast<long long>(C::BK) * HD;
  int err = make_map(&vmap, &fold, V, HD, 1, C::BK, 1, tile, tile, HD, C::BK);
  if (err != 0) return err;
  const int bytes = C::KV_BYTES + 8 + 1024;
  const cudaError_t attr = cudaFuncSetAttribute(
      pv_tile_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  pv_tile_kernel<HD><<<1, 128, bytes, stream>>>(vmap, static_cast<const bf16*>(P), O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int attn_fwd_bf16(
    const void* q, const void* k, const void* v, const float* bias, void* o,
    float* lse, int B, int H, int group, int tq, int tk, int hd, int kv_len, int causal,
    int q_offset, float scale, long long sqb, long long sqh, long long sqt, long long skb,
    long long skh, long long skt, long long svb, long long svh, long long svt,
    long long sob, long long soh, long long sot, long long sbias,
    void* stream) {
  if (B < 1 || H < 1 || group < 1 || H % group || tq < 1 || tk < 1 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.bias = bias;
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.H = H;
  p.group = group;
  p.tq = tq;
  p.tk = tk;
  p.kv_len = kv_len;
  p.causal = causal;
  p.q_offset = q_offset;
  p.scale_log2 = scale * LOG2E;
  p.sob = sob; p.soh = soh; p.sot = sot;
  p.sbias = sbias;
  p.qfold = p.kfold = p.vfold = 0;
  const Operands a = {q, k, v, B, tq, tk, sqb, sqh, sqt, skb, skh, skt, svb, svh, svt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch<128>(p, a, s);
  if (hd == 64) return launch<64>(p, a, s);
  if (hd == 256) return launch<256>(p, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// keys per tile of the forward at head dim hd (the P V test's tile), 0 if
// the forward does not take hd
extern "C" int attn_fwd_tile_keys(int hd) {
  return hd == 128 ? Cfg<128>::BK : hd == 64 ? Cfg<64>::BK : hd == 256 ? Cfg<256>::BK : 0;
}

// O [64, hd] fp32 = P [64, BK] V [BK, hd], both bf16 row-major and 16-byte
// aligned, BK = attn_fwd_tile_keys(hd): the forward's P V on one tile
extern "C" int attn_pv_tile_bf16(const void* P, const void* V, float* O, int hd,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_pv_tile<128>(P, V, O, s);
  if (hd == 64) return launch_pv_tile<64>(P, V, O, s);
  if (hd == 256) return launch_pv_tile<256>(P, V, O, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
