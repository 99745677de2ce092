// One decode step of GQA attention over one layer's KV-cache stripe, for
// Hopper (sm_90a): bf16 in, bf16 out, fp32 softmax statistics; or, for a
// model served in fp32, fp32 in and out (decode_attn_f32), the same kernel
// on 4-byte elements.
//
// Replaces decode_attention (_kernel_bf16) of
// trace_tpu/kernels/decode_attention.py, which computes in the operands'
// dtype, so in fp32 for fp32 operands. The TPU kernel receives the layer
// index as a scalar-prefetch operand to select the stripe of the stacked
// [L, B, NKV, S, hd] cache; here the caller passes the stripe itself, a
// contiguous [B, NKV, S, hd] view, so the kernel reads it in place. Per
// (batch row, kv head), for its G query rows:
//   s = (q . k^T) * scale + bias,  m = max(s),  p = exp(s - m),  l = sum(p),
//   o = (bf16(p) . v) / max(l, 1e-30),
// the products and l summed in fp32. p is rounded to bf16 under the row's
// final max, before the division, as the TPU kernel rounds it; over an fp32
// cache p stays unrounded (the TPU kernel casts p to v's dtype).
//
// The step is bound by bytes: each (row, kv head) stripe is read once for G
// query rows, about 2 flops per byte. So the kernel reads only the K and V
// rows of the visible slots, once, and keeps everything else on the chip.
// One launch, one cluster of C <= 8 blocks per (kv head, batch row), block r
// of the cluster owning a contiguous share of the slots, no workspace in
// device memory. C is 8 at serving lengths, less where a share would hold
// under MIN_SHARE slots or the grid would pass the blocks the SMs hold at
// once (four an SM, two above G = 4: C = 2 at decode batch 32 and 8 kv
// heads), but never fewer than hold the row in shared memory
// (decode_common.cuh, shared with the int8 kernel).
// G, the query rows of a kv head, is 1 ... 8 at hd 128 and 256 (1, 2 or 4 at
// hd 64).
// Pass 1's reduce-scatter halves a power of two of values, so the rows are
// padded with zero rows to pow2_ceil(G) there (a constant 0 the compiler
// folds; a padded row's dot is never stored). The P.V reduction reuses the
// ring, which holds RW x HD partial sums for up to six query rows, so it
// runs in passes of at most six rows (one pass up to G = 6).
//   pass 1:     the block loads q (into registers: a lane holds 8 columns of
//               each of the G rows) and its share of the bias together, and
//               lists the slots it takes: the visible ones only (bias above
//               -1e30; a masked slot adds exactly 0 once one slot of its row
//               is visible, since exp(-1e30 - m) underflows). Their K rows
//               stream through a ring of NSTAGE shared-memory stages (16-byte
//               cp.async; NSTAGE - 1 tiles in flight while one is scored);
//               HD / 8 lanes (fp32: HD / 4) share a K row, 16 bytes each,
//               and sum their G
//               partial dots with a reduce-scatter (padded to a power of two
//               rows); the scores stay in shared
//               memory. Then the first V tiles' copies start, to land during
//               the exchange;
//   exchange 1: every block writes its max and slot count into every rank's
//               shared memory (distributed shared memory) before a cluster
//               barrier, then reads them in rank order: the row max m. A row
//               with no visible slot at all (the count is 0) repeats pass 1
//               and exchange 1 over every slot: its scores are then exactly
//               the bias and p = 1 on every slot, as in the TPU kernel;
//   pass 2:     p = expf(s - m), the block's share of l over the unrounded p,
//               and P.V with bf16(p) (fp32: p) over its V rows through the
//               ring, HD / 4 threads a row (4 values each), fp32 partial sums
//               [G, HD];
//   exchange 2: every block writes its l into every rank's shared memory and
//               slice r of its partial sums into rank r's, before a cluster
//               barrier; rank r sums its slice over the ranks in rank order,
//               divides by max(l, 1e-30), casts and writes. After that
//               barrier no block touches another's shared memory, so none
//               waits for the others to leave. (The first barrier, that every
//               block of the cluster runs before any writes into it,
//               completes while q and the bias load.)
// The max goes first, in an exchange of its own, so that every p is rounded
// under the row's final max as the TPU kernel rounds it (an online softmax
// would round each block's p under its own running max). A block whose share
// is empty takes part in both exchanges with neutral values (max -inf, sums
// 0). Nothing is summed with atomics, so a call repeats bit for bit.
// Shared memory: RING plus 4 G + 8 bytes a slot of the share (scores, bias,
// slot index), in fp32 as in bf16: 31 KB at S = 2304, G = 4 and C = 8, 51 KB
// at C = 2, so four blocks fit an SM at serving lengths. C grows where a share
// would not fit; past 8 x ~8350 slots (S past ~66000 at G = 4) none does, and
// the launch fails.
// Head dims: the kernel is built at HD = 64 and 128, and in bf16 at 256 (a
// K row of 512 bytes: a warp's 32 lanes of 16 bytes in pass 1, 16 rows a
// stage); any other hd that is a multiple of 4 up to 256 (128 in fp32) runs
// at the next of the widths (PAD): the rows of q,
// K and V hold hd values in device memory, the ring's rows HD, the columns
// past hd zero-filled by the copies themselves (cp.async's source size, in
// pieces of 16, 8 or 4 bytes as the rows' alignment allows), so the
// arithmetic is the HD instance's over zero columns, and only the output's
// first hd columns are written. The cache is read in place. The instances
// at 64 and 128 are the library of decode_attention.cu, the padded ones up to
// 128 that of decode_attention_pad.cu, those at width 256 the libraries of
// decode_attention_256.cu (hd 256) and decode_attention_256_pad.cu (each
// source's entries dispatch only its own; libraries of their own so that
// they compile in parallel).
// The fp32 instance keeps the ring's 3 stages of 8 KB: a stage holds 16 fp32
// K or V rows of hd 128 (bf16: 32), so the bytes in flight a block are the
// bf16 instance's, and a larger ring would cost the fourth block an SM at
// C = 2 (decode batch 32), where the block's share of the row already needs
// 27 KB.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

typedef __nv_bfloat16 bf16;
namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;           // threads per block
constexpr int NW = NT / 32;       // warps per block
constexpr int MIN_SHARE = 128;    // slots a block takes at least, where C > 1
constexpr int STAGE = 8 * 1024;   // bytes of K or V rows in one stage of the ring
constexpr int NSTAGE = 3;         // stages of the ring, NSTAGE - 1 in flight
constexpr int RING = NSTAGE * STAGE;
constexpr int MAX_DYNAMIC_SMEM = 220 * 1024;  // of the 227 KB a block may have, beside static
// at width 256 the static arrays take up to ~9 KB (the partial sums rx_part
// [G x 256] at G = 8): the dynamic part stops at 204 KB there
template <int HD>
constexpr int max_dynamic_smem() {
  return HD == 256 ? 204 * 1024 : MAX_DYNAMIC_SMEM;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the bf16 pair in word w as two floats
__device__ __forceinline__ float2 unpack2(unsigned w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// the cache's element (also q's and o's): what differs between the bf16 and
// the fp32 instance
template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  static constexpr int VEC = 8;  // values in 16 bytes
  // the VEC values of a 16-byte vector as floats
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[VEC]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = unpack2(w[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  // four values from p (8 bytes)
  static __device__ __forceinline__ void load4(const unsigned char* p, float (&f)[4]) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const float2 f01 = unpack2(w.x), f23 = unpack2(w.y);
    f[0] = f01.x;
    f[1] = f01.y;
    f[2] = f23.x;
    f[3] = f23.y;
  }
  // the weight of v's row in P.V: p cast to v's type
  static __device__ __forceinline__ float weight(float p) { return bf16_round(p); }
  static __device__ __forceinline__ float value(bf16 x) { return __bfloat162float(x); }
};

template <>
struct Elem<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[VEC]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ void load4(const unsigned char* p, float (&f)[4]) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    f[0] = w.x;
    f[1] = w.y;
    f[2] = w.z;
    f[3] = w.w;
  }
  static __device__ __forceinline__ float weight(float p) { return p; }
  static __device__ __forceinline__ float value(float x) { return x; }
};

// dynamic shared memory of a block, in bytes: the ring of staged K or V rows
// (later the P.V reduction), then per slot of the share (cap = share rounded
// up to 16): scores [G][cap] fp32 (in pass 2 the weights), bias [cap] fp32, the
// slot list [cap] int32
template <int G>
__host__ __device__ constexpr int smem_per_slot() {
  return G * 4 + 4 + 4;
}

// hd: the values of a row of q, K, V and o in device memory (HD unless PAD)
template <typename T, int HD, int G, bool PAD>
__global__ void __launch_bounds__(NT, blocks_per_sm(G))
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ bias, T* __restrict__ o, int nkv, int S, int share,
                  float scale, int hd) {
  typedef Elem<T> E;
  constexpr int VEC = E::VEC;      // values of a 16-byte piece of a row
  constexpr int ROW = HD * sizeof(T);  // bytes of a K or V row
  constexpr int LPS = HD / VEC;    // pass 1: lanes per K row, 16 bytes each
  constexpr int SPI = NT / LPS;    // pass 1: rows per block iteration
  constexpr int R = 2;             // pass 1: rows a lane group scores together
  constexpr int LPR = HD / 4;      // pass 2: threads per V row, 4 values each
  constexpr int RW = NT / LPR;     // pass 2: rows per block iteration
  constexpr int TR = STAGE / ROW;  // rows per tile of the ring
  constexpr int GP = pow2_ceil(G);  // pass 1: query rows padded for the reduce-scatter
  constexpr int GR = RING / (RW * HD * sizeof(float)) < G  // query rows a reduction pass takes
      ? RING / (RW * HD * sizeof(float)) : G;
  static_assert(GR >= 1, "the P.V reduction of one query row must fit the ring");
  static_assert(LPS >= GP && LPS <= 32, "a K row's lanes hold every query row's dot");

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
  unsigned char* ring = dyn;
  float* red = reinterpret_cast<float*>(dyn);        // [RW][GR][HD], after the last V tile
  float* sc = reinterpret_cast<float*>(dyn + RING);  // scores, then the weights
  float* bsh = sc + G * cap;                         // the share's bias
  int* idx = reinterpret_cast<int*>(bsh + cap);      // the slots taken, ascending

  // what the other ranks write here (rank r's values at [r]), before the
  // barrier of each exchange
  __shared__ float rx_m[2][MAX_CLUSTER][G];
  __shared__ int rx_n[2][MAX_CLUSTER];
  __shared__ float rx_l[MAX_CLUSTER][G];
  __shared__ float rx_part[G * HD + MAX_CLUSTER];
  __shared__ float wr[NW][G];
  __shared__ int wcnt[NW];

  // q and the share's bias (contiguous) in flight together
  const int j0 = min(S, rank * share), j1 = min(S, j0 + share);
  const int sub = tid % LPS, grp = tid / LPS;
  float qr[G][VEC];  // columns sub * VEC .. sub * VEC + VEC - 1 of every query row
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if constexpr (PAD) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int col = sub * VEC + e;
        qr[g][e] = col < hd ? E::value(q[(bn * G + g) * hd + col]) : 0.f;
      }
    } else {
      E::unpack(*reinterpret_cast<const uint4*>(q + (bn * G + g) * HD + sub * VEC), qr[g]);
    }
  }
  {
    const float* bb = bias + static_cast<long long>(blockIdx.z) * S;
#pragma unroll 2
    for (int i = tid; i < j1 - j0; i += NT) bsh[i] = bb[j0 + i];
  }
  cluster_wait();

  // pass 1 and exchange 1, in up to two rounds: first over the visible
  // slots only, then, only if the whole row has no visible slot, over every
  // slot
  const int gbytes = (PAD ? hd : HD) * static_cast<int>(sizeof(T));  // a row in device memory
  const T* kb = k + bn * S * (PAD ? hd : HD);
  const T* vb = v + bn * S * (PAD ? hd : HD);
  int nv = 0;
  float m[G];
  for (int round = 0;; ++round) {
    const bool dense = round == 1;
    nv = list_slots<NT>(idx, wcnt, bsh, j0, j1, dense);

    // their scores: K rows through the ring, LPS lanes a row, R rows a
    // lane group at once
    float mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) mx[g] = -INFINITY;
    const int ntile = (nv + TR - 1) / TR;
    const int gown = sub / (LPS / GP);  // the query row whose dot this lane ends with
    for (int t = 0; t < NSTAGE - 1; ++t)
      stage_rows<PAD, ROW, STAGE, NSTAGE, NT>(ring, kb, idx, t, nv, gbytes);
    for (int t = 0; t < ntile; ++t) {
      cp_async_wait<NSTAGE - 2>();  // tile t has landed
      __syncthreads();              // everywhere, and stage (t - 1) % NSTAGE is free
      stage_rows<PAD, ROW, STAGE, NSTAGE, NT>(ring, kb, idx, t + NSTAGE - 1, nv, gbytes);
      const int k0 = t * TR, k1 = min(nv, k0 + TR);
      const unsigned char* tile = ring + (t % NSTAGE) * STAGE;
      for (int kk = k0; kk < k1; kk += R * SPI) {
        float a[R][GP];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int kr = kk + u * SPI + grp;
          const uint4 kv = kr < k1
              ? *reinterpret_cast<const uint4*>(tile + (kr - k0) * ROW + sub * 16)
              : make_uint4(0, 0, 0, 0);
          float kf[VEC];
          E::unpack(kv, kf);
#pragma unroll
          for (int g = 0; g < GP; ++g) {
            a[u][g] = 0.f;
            if (g < G) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) a[u][g] += qr[g][e] * kf[e];
            }
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
          const int kr = kk + u * SPI + grp;
          if (sub % (LPS / GP) == 0 && kr < k1 && gown < G) {
            const float s = a[u][0] * scale + bsh[idx[kr] - j0];
            sc[gown * cap + kr] = s;
#pragma unroll
            for (int g = 0; g < G; ++g)
              if (g == gown) mx[g] = fmaxf(mx[g], s);
          }
        }
      }
    }
    __syncthreads();  // the ring is free again
    // the first V tiles land while the max is exchanged
    for (int t = 0; t < NSTAGE - 1; ++t)
      stage_rows<PAD, ROW, STAGE, NSTAGE, NT>(ring, vb, idx, t, nv, gbytes);

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

  // pass 2: p = exp(s - m) and this block's share of l over the unrounded
  // p; the weights (p cast to v's type) replace the scores
  float ls[G];
#pragma unroll
  for (int g = 0; g < G; ++g) ls[g] = 0.f;
  for (int kr = tid; kr < nv; kr += NT) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = expf(sc[g * cap + kr] - m[g]);
      ls[g] += p;
      sc[g * cap + kr] = E::weight(p);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ls[g] += __shfl_xor_sync(0xffffffffu, ls[g], off);
    if (lane == 0) wr[warp][g] = ls[g];
  }

  // P.V over this block's V rows through the ring (the first tile's
  // barrier also publishes the weights)
  const int worker = tid / LPR, d0 = (tid % LPR) * 4;
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  const int ntile = (nv + TR - 1) / TR;
  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    stage_rows<PAD, ROW, STAGE, NSTAGE, NT>(ring, vb, idx, t + NSTAGE - 1, nv, gbytes);
    const int k0 = t * TR, k1 = min(nv, k0 + TR);
    const unsigned char* tile = ring + (t % NSTAGE) * STAGE;
    for (int kr = k0 + worker; kr < k1; kr += RW) {
      float f[4];
      E::load4(tile + (kr - k0) * ROW + d0 * sizeof(T), f);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pw = sc[g * cap + kr];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] += pw * f[e];
      }
    }
  }

  // exchange 2: every block writes l into every rank's shared memory and
  // output i's partial sum into its owner's, rank i / per; then each owner
  // sums its slice over the ranks in rank order, divides and writes. After
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
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < RW; ++w) sum += red[w * GR * HD + i];
      const int out = g0 * HD + i, owner = out / per;
      *cluster.map_shared_rank(&rx_part[rank * per + out - owner * per], owner) = sum;
    }
  }
  if (tid < C * G) {  // wr is published by the barriers of the passes
    const int g = tid % G;
    float l = 0.f;
    for (int w = 0; w < NW; ++w) l += wr[w][g];
    *cluster.map_shared_rank(&rx_l[rank][g], tid / G) = l;
  }
  cluster_arrive();
  cluster_wait();
  for (int t = tid; t < per; t += NT) {
    const int i = rank * per + t;
    if (i >= G * HD) break;
    const int g = i / HD;
    float sum = 0.f, l = 0.f;
    for (int r = 0; r < C; ++r) {
      sum += rx_part[r * per + t];
      l += rx_l[r][g];
    }
    const float out = __fdiv_rn(sum, fmaxf(l, 1e-30f));
    if constexpr (PAD) {
      if (i % HD < hd) store_out(o + (bn * G + g) * hd + i % HD, out);
    } else {
      store_out(o + bn * G * HD + i, out);
    }
  }
}

template <typename T, int HD, int G, bool PAD>
int launch(const T* q, const T* k, const T* v, const float* bias, T* o, int B, int nkv, int S,
           float scale, int hd, cudaStream_t stream) {
  const int C = cluster_blocks(S, B * nkv, MIN_SHARE, SMS * blocks_per_sm(G),
                               max_dynamic_smem<HD>(), RING, smem_per_slot<G>());
  const int share = (S + C - 1) / C;
  const size_t smem = RING + static_cast<size_t>((share + 15) & ~15) * smem_per_slot<G>();
  return launch_clusters(decode_kernel<T, HD, G, PAD>, C, nkv, B, NT, smem, stream, q, k, v,
                         bias, o, nkv, S, share, scale, hd);
}

template <typename T, int HD, bool PAD>
int dispatch_group(const T* q, const T* k, const T* v, const float* bias, T* o, int B, int nkv,
                   int G, int S, float scale, int hd, cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, HD, 1, PAD>(q, k, v, bias, o, B, nkv, S, scale, hd, s);
    case 2: return launch<T, HD, 2, PAD>(q, k, v, bias, o, B, nkv, S, scale, hd, s);
    case 4: return launch<T, HD, 4, PAD>(q, k, v, bias, o, B, nkv, S, scale, hd, s);
    default: break;
  }
  if constexpr (HD >= 128) {
    switch (G) {
      case 3: return launch<T, HD, 3, PAD>(q, k, v, bias, o, B, nkv, S, scale, hd, s);
      case 5: return launch<T, HD, 5, PAD>(q, k, v, bias, o, B, nkv, S, scale, hd, s);
      case 6: return launch<T, HD, 6, PAD>(q, k, v, bias, o, B, nkv, S, scale, hd, s);
      case 7: return launch<T, HD, 7, PAD>(q, k, v, bias, o, B, nkv, S, scale, hd, s);
      case 8: return launch<T, HD, 8, PAD>(q, k, v, bias, o, B, nkv, S, scale, hd, s);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the instances of one library: PAD false those at hd 64 and 128
// (decode_attention.cu), PAD true those at the other head dims up to 128
// (decode_attention_pad.cu); WIDE those at width 256, bf16 alone, at hd 256
// (decode_attention_256.cu) and at 132 ... 252 (decode_attention_256_pad.cu);
// a head dim of another library is refused
template <typename T, bool PAD, bool WIDE = false>
int dispatch(const void* q, const void* k, const void* v, const float* bias, void* o, int B,
             int nkv, int G, int S, int hd, float scale, void* stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool pad;
  const int width = decode_width(hd, &pad);
  if (S < 1 || width == 0 || pad != PAD || (width == 256) != WIDE)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (WIDE) {
    return dispatch_group<T, 256, PAD>(qt, kt, vt, bias, ot, B, nkv, G, S, scale, hd, s);
  } else {
    if (width == 128)
      return dispatch_group<T, 128, PAD>(qt, kt, vt, bias, ot, B, nkv, G, S, scale, hd, s);
    return dispatch_group<T, 64, PAD>(qt, kt, vt, bias, ot, B, nkv, G, S, scale, hd, s);
  }
}

}  // namespace
