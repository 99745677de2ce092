// One decode step of GQA attention over one layer's int8 KV-cache stripe, for
// Hopper (sm_90a): bf16 q, int8 K/V with one bf16 scale per (row, kv head,
// slot), bf16 out; or, for a model served in fp32, fp32 q and out
// (decode_attn_int8_f32_*), the same kernel with q read as fp32.
//
// Replaces the int8 bodies of decode_attention of
// trace_tpu/kernels/decode_attention.py, in two modes:
//   s8dot   (_kernel_int8_s8dot and _kernel_int8_s8dot_stacked, which compute
//           the same function): the q rows and the post-softmax p * vs are
//           quantized to int8 and both products run s8 x s8 -> s32;
//   dequant (_kernel_int8): K/V are converted to bf16 values, the products
//           sum in fp32, the weights (bf16(p) * vs) are rounded to bf16.
// With an fp32 q, s8dot quantizes q from its fp32 values and dequant rounds
// q to bf16 as it loads it; the output is written in fp32 (the TPU kernel
// computes in q's dtype).
// The caller passes layer li's stripes (contiguous views of the stacked
// cache), where the TPU kernel selects them through a scalar-prefetch index.
//
// The step is bound by bytes: each (row, kv head) stripe is read once for G
// query rows. A single online pass over the slots, as the bf16 kernel makes,
// cannot be used: s8dot's probability scale ps is the maximum of
// exp(s - m) * vs over ALL slots of the row, so no probability can be
// quantized before every score is known (and dequant rounds exp(s - m) to
// bf16 under the final m). So the row's statistics are exchanged between the
// blocks that share it: one launch, one cluster of C <= 8 blocks per (kv
// head, batch row), block r of the cluster owning a contiguous share of the
// slots, and no workspace in device memory. C is 8 at serving lengths, less
// where a share would hold under MIN_SHARE slots or the grid would pass the
// blocks the SMs hold at once (four an SM, two above G = 4: C = 2 at decode
// batch 32 and 8 kv heads).
// G, the query rows of a kv head, is 1 ... 8 at hd 128 and 256 (1, 2 or 4 at
// hd 64; s8dot's HD / 16 lanes of a K row and one warp per query row bound
// it).
// Pass 1's reduce-scatter runs on the rows padded with zero rows to
// pow2_ceil(G) (a padded row's dot is never stored); the P.V reduction
// reuses the ring, which holds RW x HD partial sums for four query rows, so
// it runs in passes of at most four rows.
//   pass 1:     the block loads q and its share of the bias and of the K and
//               V scales (contiguous) together, and lists the slots it takes:
//               the visible ones only (bias above -1e30; a masked slot adds
//               exactly 0 once one slot of its row is visible, since
//               exp(-1e30 - m) underflows), so masked K and V rows are never
//               read. Its K rows stream through a ring of NSTAGE shared-memory
//               stages (cp.async; a tile lands while the one before is
//               scored). The G query rows sit in registers (s8dot quantizes
//               them to packed int8 first); HD / 16 (s8dot, __dp4a) or HD / 8
//               (dequant, fp32) lanes share a K row and sum their partial
//               dots with a reduce-scatter. Then the first V tile's copy
//               starts, to land during the exchanges;
//   exchange 1: every block writes its max and slot count into every rank's
//               shared memory (distributed shared memory) before a cluster
//               barrier, then reads them in rank order: the row max m. A row
//               with no visible slot at all (the count is 0) repeats pass 1
//               and exchange 1 over every slot: its scores are then exactly
//               the bias and p = 1 on every slot, as in the plain version;
//   pass 2:     p = expf(s - m), the block's share of l and, for s8dot, of
//               max(p * vs);
//   exchange 2: l and ps = max(max(p * vs), 1e-30) / 127, the same way;
//   pass 3:     the block quantizes p * vs (s8dot) or rounds bf16(bf16(p) *
//               vs) (dequant) and runs P.V over its V rows through the ring,
//               HD / 4 threads a row (4 bytes each); s8dot transposes 4 slots
//               x 4 columns with byte permutes so that __dp4a contracts over
//               the slots; partial sums [G, HD] (int32, or fp32 for dequant);
//   exchange 3: every block writes slice r of its partial sums into rank r's
//               shared memory before a cluster barrier; rank r sums its slice
//               over the ranks in rank order, scales, divides by max(l,
//               1e-30), casts and writes. After that barrier no block touches
//               another's shared memory, so none waits for the others to
//               leave. (The first barrier, that every block of the cluster
//               runs before any writes into it, completes while q loads.)
// A block whose share is empty takes part in every exchange with neutral
// values (max -inf, sums 0). Nothing is summed with atomics, so a call
// repeats bit for bit. Integer sums are exact in any order; every fp32 step
// that feeds a rounding (q / qs, the score chain, p * vs, pv / ps) is written
// with the _rn intrinsics so that the compiler fuses no multiply with an add,
// and the values equal the plain version's bit for bit wherever expf and the
// plain version's exp agree (only l's summation order differs besides).
// Head dims: built at HD = 64 and 128, and for a bf16 q at 256 (a K row of
// 256 bytes: 16 lanes in s8dot, 32 in dequant; 32 rows a stage); any other
// hd that is a multiple of 4 up to 256 (128 for an fp32 q) runs at the next
// of the widths (PAD), as the bf16 kernel does: rows
// of hd values (bytes, for K and V) in device memory, the ring's rows HD
// with zero columns past hd filled by the copies themselves (4-byte pieces
// where a row is not a multiple of 8 bytes), q's columns past hd read as 0
// (s8dot's amax over the real hd only: zeros do not change it), and only
// the output's first hd columns written. The cache is read in place. The
// instances at 64 and 128 are the library of decode_attention_int8.cu, the
// padded ones up to 128 that of decode_attention_int8_pad.cu, those at width
// 256 the libraries of decode_attention_int8_256.cu (hd 256) and
// decode_attention_int8_256_pad.cu.
// Shared memory (the same for either q): RING (16 KB) plus 28 bytes a slot of
// the share at G = 4
// (24 KB at S = 2304 and C = 8, 48 KB at C = 2), so four blocks fit an SM at
// serving lengths. C grows where a share would not fit; past 8 x ~7400 slots
// (S past ~59000) none does, and the launch fails.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "decode_common.cuh"

typedef __nv_bfloat16 bf16;
namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;           // threads per block
constexpr int NW = NT / 32;       // warps per block
constexpr int MIN_SHARE = 128;    // slots a block takes at least, where C > 1
constexpr int STAGE = 8 * 1024;   // bytes of K or V rows in one stage of the ring
constexpr int NSTAGE = 2;         // stages of the ring, NSTAGE - 1 in flight
constexpr int RING = NSTAGE * STAGE;
constexpr int MAX_DYNAMIC_SMEM = 220 * 1024;  // of the 227 KB a block may have, beside static
// at width 256 the static arrays take up to ~20 KB (q as fp32 and packed
// int8, the partial sums rx_part [G x 256] at G = 8): the dynamic part stops at
// 204 KB there
template <int HD>
constexpr int max_dynamic_smem() {
  return HD == 256 ? 204 * 1024 : MAX_DYNAMIC_SMEM;
}
constexpr int S8DOT = 0;
constexpr int DEQUANT = 1;
#define INV127 (static_cast<float>(1.0 / 127.0))

template <int MODE>
using acc_t = typename std::conditional<MODE == S8DOT, int, float>::type;

// the four int8 of w as exact floats
__device__ __forceinline__ void unpack4(unsigned w, float (&f)[4]) {
  const unsigned biased = w ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + b)) - 8388736.f;
}

// word i of a 16- or 8-byte vector
__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ unsigned word(const uint2& v, int i) { return i == 0 ? v.x : v.y; }

__device__ __forceinline__ float clip127(float r) {
  return fminf(fmaxf(r, -127.f), 127.f);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// a value of q as fp32
__device__ __forceinline__ float q_value(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float q_value(float x) { return x; }

// dequant: a value of q as the bf16 value it multiplies
__device__ __forceinline__ float q_bf16_value(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float q_bf16_value(float x) { return bf16_round(x); }

// dequant: the 8 values of q from p (16-byte aligned) as bf16 values
__device__ __forceinline__ void load_q8(const bf16* p, float (&f)[8]) {
  const uint4 h = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned hw = word(h, i);
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hw));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load_q8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = bf16_round(x[i]);
}

// dynamic shared memory of a block, in bytes: the ring of staged K or V rows
// (later the P.V reduction), then per slot of the share (cap = share rounded
// up to 16): scores [G][cap] fp32, bias [cap] fp32 (in pass 3 s8dot's
// quantized weights [G][cap] int8: max(4, G) bytes a slot), the slot list
// [cap] int32, K and V scales [cap] bf16
template <int G>
__host__ __device__ constexpr int bias_bytes() {
  return G > 4 ? G : 4;
}
template <int G>
__host__ __device__ constexpr int smem_per_slot() {
  return G * 4 + bias_bytes<G>() + 4 + 2 * 2;
}

// hd: the values of a row of q, K, V and o in device memory (HD unless PAD)
template <typename TQ, int HD, int G, int MODE, bool PAD>
__global__ void __launch_bounds__(NT, blocks_per_sm(G))
    decode_int8_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ kq,
                       const bf16* __restrict__ ks, const int8_t* __restrict__ vq,
                       const bf16* __restrict__ vs, const float* __restrict__ bias,
                       TQ* __restrict__ o, int nkv, int S, int share, float scale, int hd) {
  constexpr int BPL = MODE == S8DOT ? 16 : 8;  // pass 1: bytes of a K row per lane
  constexpr int LPS = HD / BPL;  // pass 1: lanes per K row
  constexpr int SPI = NT / LPS;  // pass 1: rows per block iteration
  constexpr int R = 2;           // pass 1: rows a lane group scores together
  constexpr int LPR = HD / 4;    // pass 3: threads per V row
  constexpr int RW = NT / LPR;   // pass 3: rows per block iteration
  constexpr int TR = STAGE / HD;  // rows per tile of the ring
  typedef acc_t<MODE> A;
  typedef typename std::conditional<BPL == 16, uint4, uint2>::type kvec;
  constexpr int GP = pow2_ceil(G);  // pass 1: query rows padded for the reduce-scatter
  constexpr int GR = RING / (RW * HD * sizeof(A)) < G  // query rows a reduction pass takes
      ? RING / (RW * HD * sizeof(A)) : G;
  static_assert(GR >= 1, "the P.V reduction of one query row must fit the ring");
  static_assert(LPS >= GP && G <= NW, "a K row's lanes hold every query row's dot, "
                "and s8dot quantizes each query row with a warp");

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long bn = static_cast<long long>(blockIdx.z) * nkv + blockIdx.y;
  // no block writes into another's shared memory before every block of the
  // cluster runs; this barrier completes while the first loads are in flight
  cluster_arrive_relaxed();

  extern __shared__ __align__(16) unsigned char dyn[];
  const int cap = (share + 15) & ~15;
  int8_t* ring = reinterpret_cast<int8_t*>(dyn);
  A* red = reinterpret_cast<A*>(dyn);                   // [RW][GR][HD], after the last V tile
  float* sc = reinterpret_cast<float*>(dyn + RING);     // scores, then p * vs or weights
  float* bsh = sc + G * cap;                            // the share's bias (pass 1)
  int* idx = reinterpret_cast<int*>(                    // the slots taken, ascending
      reinterpret_cast<unsigned char*>(bsh) + bias_bytes<G>() * cap);
  bf16* kss = reinterpret_cast<bf16*>(idx + cap);       // the share's K scales
  bf16* vss = kss + cap;                                // and V scales
  int8_t* pq = reinterpret_cast<int8_t*>(bsh);          // s8dot: quantized p * vs, in pass 3

  __shared__ float qf[G][HD];
  __shared__ int qq[G][HD / 4];
  __shared__ float qsc[G];
  // what the other ranks write here (rank r's values at [r]), before the
  // barrier of each exchange
  __shared__ float rx_m[2][MAX_CLUSTER][G];
  __shared__ int rx_n[2][MAX_CLUSTER];
  __shared__ float rx_l[MAX_CLUSTER][G], rx_pa[MAX_CLUSTER][G];
  __shared__ A rx_part[G * HD + MAX_CLUSTER];
  __shared__ float wr[NW][G], wr2[NW][G];
  __shared__ int wcnt[NW];

  // q and the share's bias and scales (contiguous) in flight together
  const int j0 = min(S, rank * share), j1 = min(S, j0 + share);
  const int sub = tid % LPS, grp = tid / LPS;
  // the G query rows, in registers: a lane holds the BPL columns of every
  // row that it multiplies with its part of a K row (fp32, or s8dot's
  // packed int8 after the rows are quantized, one warp a row)
  float qr[G][MODE == S8DOT ? 1 : BPL];
  int qi[G][MODE == S8DOT ? BPL / 4 : 1];
  constexpr int QPT = (G * HD + NT - 1) / NT;  // s8dot: q values a thread loads
  float qv[MODE == S8DOT ? QPT : 1];
  if constexpr (MODE == S8DOT) {
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int i = tid + u * NT;
      if constexpr (PAD)
        qv[u] = i < G * HD && i % HD < hd ? q_value(q[(bn * G + i / HD) * hd + i % HD]) : 0.f;
      else
        qv[u] = i < G * HD ? q_value(q[bn * G * HD + i]) : 0.f;
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if constexpr (PAD) {
#pragma unroll
        for (int e = 0; e < BPL; ++e) {
          const int col = sub * BPL + e;
          qr[g][e] = col < hd ? q_bf16_value(q[(bn * G + g) * hd + col]) : 0.f;
        }
      } else {
        load_q8(q + bn * G * HD + g * HD + sub * BPL, qr[g]);
      }
    }
  }
  {
    const float* bb = bias + static_cast<long long>(blockIdx.z) * S;
#pragma unroll 2
    for (int i = tid; i < j1 - j0; i += NT) {
      bsh[i] = bb[j0 + i];
      kss[i] = ks[bn * S + j0 + i];
      vss[i] = vs[bn * S + j0 + i];
    }
  }
  if constexpr (MODE == S8DOT) {
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int i = tid + u * NT;
      if (i < G * HD) qf[i / HD][i % HD] = qv[u];
    }
    __syncthreads();
    if (warp < G) {
      float a = 0.f;
      for (int d = lane; d < HD; d += 32) a = fmaxf(a, fabsf(qf[warp][d]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
      const float qs = __fmul_rn(fmaxf(a, 1e-8f), INV127);
      for (int w = lane; w < HD / 4; w += 32) {
        unsigned p = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float r = clip127(rintf(__fdiv_rn(qf[warp][4 * w + e], qs)));
          p |= (static_cast<unsigned>(static_cast<int>(r)) & 0xffu) << (8 * e);
        }
        qq[warp][w] = static_cast<int>(p);
      }
      if (lane == 0) qsc[warp] = __fmul_rn(qs, scale);
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < BPL / 4; ++i) qi[g][i] = qq[g][sub * (BPL / 4) + i];
  }
  cluster_wait();

  // pass 1 and exchange 1, in up to two rounds: first over the visible
  // slots only, then, only if the whole row has no visible slot, over every
  // slot
  const int gbytes = PAD ? hd : HD;  // a K or V row in device memory
  const int8_t* kb = kq + bn * S * gbytes;
  const int8_t* vb = vq + bn * S * gbytes;
  int nv = 0;
  float m[G];
  for (int round = 0;; ++round) {
    const bool dense = round == 1;
    // the slots this block takes, in order
    nv = list_slots<NT>(idx, wcnt, bsh, j0, j1, dense);

    // their scores: K rows through the ring, LPS lanes a row, R rows a
    // lane group at once
    float mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) mx[g] = -INFINITY;
    const int ntile = (nv + TR - 1) / TR;
    const int gown = sub / (LPS / GP);  // the query row whose dot this lane ends with
    for (int t = 0; t < NSTAGE - 1; ++t)
      stage_rows<PAD, HD, STAGE, NSTAGE, NT>(ring, kb, idx, t, nv, gbytes);
    for (int t = 0; t < ntile; ++t) {
      cp_async_wait<NSTAGE - 2>();  // tile t has landed
      __syncthreads();              // everywhere, and stage (t - 1) % NSTAGE is free
      stage_rows<PAD, HD, STAGE, NSTAGE, NT>(ring, kb, idx, t + NSTAGE - 1, nv, gbytes);
      const int k0 = t * TR, k1 = min(nv, k0 + TR);
      const int8_t* tile = ring + (t % NSTAGE) * STAGE;
      for (int kk = k0; kk < k1; kk += R * SPI) {
        kvec kv[R];
        A a[R][GP];  // rows G .. GP - 1 stay 0
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int k = kk + u * SPI + grp;
          kv[u] = k < k1 ? *reinterpret_cast<const kvec*>(tile + (k - k0) * HD + sub * BPL)
                         : kvec{};
#pragma unroll
          for (int g = 0; g < GP; ++g) a[u][g] = 0;
        }
#pragma unroll
        for (int i = 0; i < BPL / 4; ++i)
#pragma unroll
          for (int u = 0; u < R; ++u) {
            if constexpr (MODE == S8DOT) {
#pragma unroll
              for (int g = 0; g < G; ++g)
                a[u][g] = __dp4a(static_cast<int>(word(kv[u], i)), qi[g][i],
                                 static_cast<int>(a[u][g]));
            } else {
              float kf[4];
              unpack4(word(kv[u], i), kf);
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int e = 0; e < 4; ++e) a[u][g] += qr[g][4 * i + e] * kf[e];
            }
          }
        // the LPS lanes of a row sum their GP partial dots: the first
        // log2(GP) steps halve the values a lane holds (it keeps one half
        // and sends the other), the rest add the one value left, so lane
        // sub ends with the whole dot of query row sub / (LPS / GP)
#pragma unroll
        for (int u = 0; u < R; ++u) reduce_scatter<GP, LPS>(a[u], sub);
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int k = kk + u * SPI + grp;
          if (sub % (LPS / GP) == 0 && k < k1 && gown < G) {
            const int jj = idx[k] - j0;
            const float ksj = __bfloat162float(kss[jj]), bj = bsh[jj];
            const float dot = static_cast<float>(a[u][0]);
            const float x = (MODE == S8DOT)
                ? __fmul_rn(__fmul_rn(dot, qsc[gown]), ksj)    // s32 * (qs * scale) * ks
                : __fmul_rn(__fmul_rn(dot, ksj), scale);       // dot * ks * scale
            const float s = __fadd_rn(x, bj);
            sc[gown * cap + k] = s;
#pragma unroll
            for (int g = 0; g < G; ++g)
              if (g == gown) mx[g] = fmaxf(mx[g], s);
          }
        }
      }
    }
    __syncthreads();  // the ring is free again
    // the first V tiles land while the statistics are exchanged
    for (int t = 0; t < NSTAGE - 1; ++t)
      stage_rows<PAD, HD, STAGE, NSTAGE, NT>(ring, vb, idx, t, nv, gbytes);

    // exchange 1: every block writes its max and slot count into every
    // rank's shared memory; after the barrier each reads them in rank order
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
      if (lane == 0) wr[warp][g] = mx[g];
    }
    __syncthreads();
    if (tid < C * G) {
      const int g = tid % G;
      float bm = wr[0][g];
      for (int w = 1; w < NW; ++w) bm = fmaxf(bm, wr[w][g]);
      *cluster.map_shared_rank(&rx_m[round][rank][g], tid / G) = bm;
    }
    if (tid < C) *cluster.map_shared_rank(&rx_n[round][rank], tid) = nv;
    cluster_arrive();
    cluster_wait();
    int n = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) m[g] = rx_m[round][0][g];
    for (int r = 0; r < C; ++r) {
      n += rx_n[round][r];
#pragma unroll
      for (int g = 0; g < G; ++g) m[g] = fmaxf(m[g], rx_m[round][r][g]);
    }
    if (n > 0 || dense) break;  // the same in every block of the cluster
  }

  // pass 2: p = exp(s - m), this block's share of l and of max(p * vs)
  float ls[G], pa[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    ls[g] = 0.f;
    pa[g] = 0.f;
  }
  for (int k = tid; k < nv; k += NT) {
    const float vsj = __bfloat162float(vss[idx[k] - j0]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = expf(sc[g * cap + k] - m[g]);
      ls[g] += p;
      if constexpr (MODE == S8DOT) {
        const float pv = __fmul_rn(p, vsj);
        sc[g * cap + k] = pv;
        pa[g] = fmaxf(pa[g], pv);
      } else {
        sc[g * cap + k] = bf16_round(__fmul_rn(bf16_round(p), vsj));
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ls[g] += __shfl_xor_sync(0xffffffffu, ls[g], off);
      pa[g] = fmaxf(pa[g], __shfl_xor_sync(0xffffffffu, pa[g], off));
    }
    if (lane == 0) {
      wr[warp][g] = ls[g];
      wr2[warp][g] = pa[g];
    }
  }
  __syncthreads();

  // exchange 2: l and ps, the same way
  if (tid < C * G) {
    const int g = tid % G;
    float l = 0.f, a = 0.f;
    for (int w = 0; w < NW; ++w) {
      l += wr[w][g];
      a = fmaxf(a, wr2[w][g]);
    }
    *cluster.map_shared_rank(&rx_l[rank][g], tid / G) = l;
    *cluster.map_shared_rank(&rx_pa[rank][g], tid / G) = a;
  }
  cluster_arrive();
  cluster_wait();
  float l[G], ps[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float a = 0.f;
    l[g] = 0.f;
    for (int r = 0; r < C; ++r) {
      l[g] += rx_l[r][g];
      a = fmaxf(a, rx_pa[r][g]);
    }
    ps[g] = __fmul_rn(fmaxf(a, 1e-30f), INV127);
  }

  // pass 3: the weights, then P.V over this block's V rows through the ring
  const int nv4 = (nv + 3) & ~3;
  if constexpr (MODE == S8DOT) {
    for (int i = tid; i < G * nv4; i += NT) {
      const int g = i / nv4, k = i % nv4;
      float psg = ps[0];
#pragma unroll
      for (int h = 1; h < G; ++h) psg = g == h ? ps[h] : psg;
      const float r = k < nv ? clip127(rintf(__fdiv_rn(sc[g * cap + k], psg))) : 0.f;
      pq[g * cap + k] = static_cast<int8_t>(static_cast<int>(r));
    }
  }
  const int worker = tid / LPR, d0 = (tid % LPR) * 4;
  A acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0;
  const int ntile = (nv + TR - 1) / TR;
  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    stage_rows<PAD, HD, STAGE, NSTAGE, NT>(ring, vb, idx, t + NSTAGE - 1, nv, gbytes);
    const int k0 = t * TR, k1 = min(nv, k0 + TR);
    const int8_t* tile = ring + (t % NSTAGE) * STAGE;
    if constexpr (MODE == S8DOT) {
      // 4 slots a step; TR is a multiple of 4, so a step never straddles two
      // tiles, and the weights past nv are 0
      for (int kk = k0 + worker * 4; kk < k1; kk += RW * 4) {
        unsigned w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[r] = kk + r < k1 ? *reinterpret_cast<const unsigned*>(tile + (kk + r - k0) * HD + d0)
                             : 0u;
        // 4 slots x 4 columns -> 4 columns x 4 slots
        const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
        const unsigned t1 = __byte_perm(w[0], w[1], 0x7362);
        const unsigned u0 = __byte_perm(w[2], w[3], 0x5140);
        const unsigned u1 = __byte_perm(w[2], w[3], 0x7362);
        const unsigned col[4] = {__byte_perm(t0, u0, 0x5410), __byte_perm(t0, u0, 0x7632),
                                 __byte_perm(t1, u1, 0x5410), __byte_perm(t1, u1, 0x7632)};
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int pk = *reinterpret_cast<const int*>(pq + g * cap + kk);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[g][e] = __dp4a(static_cast<int>(col[e]), pk, static_cast<int>(acc[g][e]));
        }
      }
    } else {
      for (int k = k0 + worker; k < k1; k += RW) {
        float f[4];
        unpack4(*reinterpret_cast<const unsigned*>(tile + (k - k0) * HD + d0), f);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float wv = sc[g * cap + k];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] += wv * f[e];
        }
      }
    }
  }

  // exchange 3: output i belongs to rank i / per; every block writes its
  // partial sums into the owners' shared memory, then each owner sums its
  // slice over the ranks in rank order, scales, divides and writes. After
  // this barrier no block touches another's shared memory, so none waits
  // for the others to leave. The block's partial sums are summed over its
  // RW row workers in the ring, GR query rows a pass.
  const int per = (G * HD + C - 1) / C;
#pragma unroll
  for (int g0 = 0; g0 < G; g0 += GR) {
    __syncthreads();  // the ring, or the pass before, is free again
#pragma unroll
    for (int g = 0; g < G; ++g)  // g constant, so acc stays in registers
      if (g >= g0 && g < g0 + GR) {
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(worker * GR + g - g0) * HD + d0 + e] = acc[g][e];
      }
    __syncthreads();
    const int n = (G - g0 < GR ? G - g0 : GR) * HD;
    for (int i = tid; i < n; i += NT) {
      A sum = 0;
#pragma unroll
      for (int w = 0; w < RW; ++w) sum += red[w * GR * HD + i];
      const int out = g0 * HD + i, owner = out / per;
      *cluster.map_shared_rank(&rx_part[rank * per + out - owner * per], owner) = sum;
    }
  }
  cluster_arrive();
  cluster_wait();
  for (int t = tid; t < per; t += NT) {
    const int i = rank * per + t;
    if (i >= G * HD) break;
    A sum = 0;
    for (int r = 0; r < C; ++r) sum += rx_part[r * per + t];
    const int g = i / HD;
    float lg = l[0], psg = ps[0];
#pragma unroll
    for (int h = 1; h < G; ++h) {
      lg = g == h ? l[h] : lg;
      psg = g == h ? ps[h] : psg;
    }
    float v = static_cast<float>(sum);
    if constexpr (MODE == S8DOT) v = __fmul_rn(v, psg);
    const float out = __fdiv_rn(v, fmaxf(lg, 1e-30f));
    if constexpr (PAD) {
      if (i % HD < hd) store_out(o + (bn * G + g) * hd + i % HD, out);
    } else {
      store_out(o + bn * G * HD + i, out);
    }
  }
}

template <typename TQ>
struct Args {
  const TQ* q; const int8_t* kq; const bf16* ks; const int8_t* vq; const bf16* vs;
  const float* bias; TQ* o;
  int B, nkv, S; float scale; int hd; cudaStream_t stream;
};

template <typename TQ, int HD, int G, int MODE, bool PAD>
int launch(const Args<TQ>& a) {
  const int C = cluster_blocks(a.S, a.B * a.nkv, MIN_SHARE, SMS * blocks_per_sm(G),
                               max_dynamic_smem<HD>(), RING, smem_per_slot<G>());
  const int share = (a.S + C - 1) / C;
  const size_t smem =
      RING + static_cast<size_t>((share + 15) & ~15) * smem_per_slot<G>();
  return launch_clusters(decode_int8_kernel<TQ, HD, G, MODE, PAD>, C, a.nkv, a.B, NT, smem,
                         a.stream, a.q, a.kq, a.ks, a.vq, a.vs, a.bias, a.o, a.nkv, a.S, share,
                         a.scale, a.hd);
}

template <typename TQ, int HD, int MODE, bool PAD>
int dispatch_group(const Args<TQ>& a, int G) {
  switch (G) {
    case 1: return launch<TQ, HD, 1, MODE, PAD>(a);
    case 2: return launch<TQ, HD, 2, MODE, PAD>(a);
    case 4: return launch<TQ, HD, 4, MODE, PAD>(a);
    default: break;
  }
  if constexpr (HD >= 128) {
    switch (G) {
      case 3: return launch<TQ, HD, 3, MODE, PAD>(a);
      case 5: return launch<TQ, HD, 5, MODE, PAD>(a);
      case 6: return launch<TQ, HD, 6, MODE, PAD>(a);
      case 7: return launch<TQ, HD, 7, MODE, PAD>(a);
      case 8: return launch<TQ, HD, 8, MODE, PAD>(a);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the instances of one library: PAD false those at hd 64 and 128
// (decode_attention_int8.cu), PAD true those at the other head dims up to 128
// (decode_attention_int8_pad.cu); WIDE those at width 256, bf16 q alone, at
// hd 256 (decode_attention_int8_256.cu) and at 132 ... 252
// (decode_attention_int8_256_pad.cu); a head dim of another library is
// refused
template <typename TQ, int MODE, bool PAD, bool WIDE>
int dispatch(const Args<TQ>& a, int G) {
  bool pad;
  const int width = decode_width(a.hd, &pad);
  if (a.S < 1 || width == 0 || pad != PAD || (width == 256) != WIDE)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (WIDE) {
    return dispatch_group<TQ, 256, MODE, PAD>(a, G);
  } else {
    if (width == 128) return dispatch_group<TQ, 128, MODE, PAD>(a, G);
    return dispatch_group<TQ, 64, MODE, PAD>(a, G);
  }
}

}  // namespace

// q, o [B, nkv * G, hd] in TQ (bf16, or fp32 for the *_f32_* entries); kq, vq
// [B, nkv, S, hd] int8; ks, vs [B, nkv, 1, S] bf16; bias [B, S] fp32; all
// contiguous. The entries of a library whose instances DECODE_INT8_PAD and
// DECODE_INT8_WIDE select; a library at width 256 holds the bf16-q entries
// alone (DECODE_ATTN_INT8_BF16_ENTRIES)
#define DECODE_ATTN_INT8_ENTRY(NAME, TQ, MODE)                                        \
  extern "C" int NAME(const void* q, const void* kq, const void* ks, const void* vq, \
                      const void* vs, const float* bias, void* o, int B, int nkv,    \
                      int G, int S, int hd, float scale, void* stream) {             \
    const Args<TQ> a = {static_cast<const TQ*>(q), static_cast<const int8_t*>(kq),   \
                        static_cast<const bf16*>(ks), static_cast<const int8_t*>(vq),\
                        static_cast<const bf16*>(vs), bias, static_cast<TQ*>(o), B,  \
                        nkv, S, scale, hd, static_cast<cudaStream_t>(stream)};       \
    return dispatch<TQ, MODE, DECODE_INT8_PAD, DECODE_INT8_WIDE>(a, G);              \
  }

#define DECODE_ATTN_INT8_BF16_ENTRIES                                       \
  DECODE_ATTN_INT8_ENTRY(decode_attn_int8_s8dot, bf16, S8DOT)               \
  DECODE_ATTN_INT8_ENTRY(decode_attn_int8_dequant, bf16, DEQUANT)

#define DECODE_ATTN_INT8_ENTRIES                                            \
  DECODE_ATTN_INT8_BF16_ENTRIES                                             \
  DECODE_ATTN_INT8_ENTRY(decode_attn_int8_f32_s8dot, float, S8DOT)          \
  DECODE_ATTN_INT8_ENTRY(decode_attn_int8_f32_dequant, float, DEQUANT)
