// One decode step of GQA attention over one layer's int8 KV-cache stripe, for
// Hopper (sm_90a): bf16 q, int8 K/V with one bf16 scale per (row, kv head,
// slot), bf16 out.
//
// Replaces the int8 bodies of decode_attention of
// trace_tpu/kernels/decode_attention.py, in two modes:
//   s8dot   (_kernel_int8_s8dot and _kernel_int8_s8dot_stacked, which compute
//           the same function): the q rows and the post-softmax p * vs are
//           quantized to int8 and both products run s8 x s8 -> s32;
//   dequant (_kernel_int8): K/V are converted to bf16 values, the products
//           sum in fp32, the weights (bf16(p) * vs) are rounded to bf16.
// The caller passes layer li's stripes (contiguous views of the stacked
// cache), where the TPU kernel selects them through a scalar-prefetch index.
//
// The step is bound by bytes: each (row, kv head) stripe is read once for G
// query rows. The bf16 kernel's single pass over the slots cannot be used:
// s8dot's probability scale ps is the maximum of exp(s - m) * vs over ALL
// slots of the row, so no probability can be quantized before every score is
// known (and dequant rounds exp(s - m) to bf16 under the final m). The score
// matrix is tiny (B x H x S fp32), so the work runs in four launches, the
// slots split into chunks of CHUNK over blocks:
//   1. scores:  one block per (kv head, row, chunk); HD / 16 lanes share a
//               slot (16-byte loads of K), s8dot with __dp4a on the packed
//               int8 q, scores to a workspace [B, NKV, G, S];
//   2. stats:   one block per (kv head, row): m, p = expf(s - m) written over
//               the scores, l, and for s8dot ps;
//   3. pv:      one block per (kv head, row, chunk) quantizes its slots'
//               weights into shared memory, then HD / 4 threads share a V
//               row (4 bytes each); s8dot transposes 4 slots x 4 columns
//               with byte permutes so that __dp4a contracts over the slots;
//               the chunk's partial output (int32, or fp32 for dequant) goes
//               to a workspace;
//   4. finish:  sums the chunks, scales, divides by max(l, 1e-30), casts.
// Integer sums are exact, so splitting the slots changes nothing in s8dot;
// every fp32 step that feeds a rounding (q / qs, the score chain, p * vs,
// pv / ps) is written with the _rn intrinsics so that the compiler fuses no
// multiply with an add and the values equal the plain version's bit for bit
// wherever expf and the plain version's exp agree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;     // threads per block
constexpr int CHUNK = 256;  // slots per block in the scores and pv launches
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

__device__ __forceinline__ float clip127(float r) {
  return fminf(fmaxf(r, -127.f), 127.f);
}

template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* sm) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  if (threadIdx.x % 32 == 0) sm[threadIdx.x / 32] = v;
  __syncthreads();
  float r = sm[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) r = MAX ? fmaxf(r, sm[w]) : r + sm[w];
  __syncthreads();
  return r;
}

template <int HD, int G, int MODE>
__global__ void __launch_bounds__(NT)
    scores_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ kq,
                  const bf16* __restrict__ ks, const float* __restrict__ bias,
                  float* __restrict__ ws_s, int nkv, int S, float scale) {
  constexpr int LPS = HD / 16;   // lanes per slot
  constexpr int SPI = NT / LPS;  // slots per block iteration
  __shared__ float qf[G][HD];
  __shared__ int qq[G][HD / 4];
  __shared__ float qsc[G];

  const int n = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const long long bn = static_cast<long long>(b) * nkv + n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < G * HD; i += NT)
    qf[i / HD][i % HD] = __bfloat162float(q[bn * G * HD + i]);
  __syncthreads();
  if constexpr (MODE == S8DOT) {
    if (warp < G) {  // one warp quantizes one query row
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
  }

  const int sub = threadIdx.x % LPS, grp = threadIdx.x / LPS;
  const int j_end = min(S, (c + 1) * CHUNK);
  const int8_t* kb = kq + bn * S * HD;
  const bf16* ksb = ks + bn * S;
  const float* bb = bias + static_cast<long long>(b) * S;

  for (int j0 = c * CHUNK; j0 < j_end; j0 += SPI) {
    const int j = j0 + grp;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (j < j_end)
      v = *reinterpret_cast<const uint4*>(kb + static_cast<long long>(j) * HD + sub * 16);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    acc_t<MODE> a[G];
#pragma unroll
    for (int g = 0; g < G; ++g) a[g] = 0;
    if constexpr (MODE == S8DOT) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[g] = __dp4a(static_cast<int>(w[i]), qq[g][sub * 4 + i], static_cast<int>(a[g]));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float kf[4];
        unpack4(w[i], kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[g] += qf[g][sub * 16 + 4 * i + e] * kf[e];
      }
    }
#pragma unroll
    for (int off = LPS / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g) a[g] += __shfl_xor_sync(0xffffffffu, a[g], off);
    if (sub == 0 && j < j_end) {
      const float ksj = __bfloat162float(ksb[j]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float dot = static_cast<float>(a[g]);
        const float x = (MODE == S8DOT)
            ? __fmul_rn(__fmul_rn(dot, qsc[g]), ksj)    // s32 * (qs * scale) * ks
            : __fmul_rn(__fmul_rn(dot, ksj), scale);    // dot * ks * scale
        ws_s[(bn * G + g) * S + j] = __fadd_rn(x, bb[j]);
      }
    }
  }
}

template <int G, int MODE>
__global__ void __launch_bounds__(NT)
    stats_kernel(float* __restrict__ ws_s, const bf16* __restrict__ vs,
                 float* __restrict__ ws_stat, int nkv, int S) {
  __shared__ float sm[NT / 32];
  const long long bn = static_cast<long long>(blockIdx.y) * nkv + blockIdx.x;
  const bf16* vsb = vs + bn * S;
  for (int g = 0; g < G; ++g) {
    float* row = ws_s + (bn * G + g) * S;
    float m = -3.0e38f;
    for (int j = threadIdx.x; j < S; j += NT) m = fmaxf(m, row[j]);
    m = block_reduce<true>(m, sm);
    float l = 0.f, pa = 0.f;
    for (int j = threadIdx.x; j < S; j += NT) {
      const float p = expf(row[j] - m);
      row[j] = p;
      l += p;
      if constexpr (MODE == S8DOT) pa = fmaxf(pa, __fmul_rn(p, __bfloat162float(vsb[j])));
    }
    l = block_reduce<false>(l, sm);
    pa = block_reduce<true>(pa, sm);
    if (threadIdx.x == 0) {
      ws_stat[(bn * G + g) * 2] = l;
      ws_stat[(bn * G + g) * 2 + 1] = __fmul_rn(fmaxf(pa, 1e-30f), INV127);
    }
  }
}

template <int HD, int G, int MODE>
__global__ void __launch_bounds__(NT)
    pv_kernel(const float* __restrict__ ws_p, const float* __restrict__ ws_stat,
              const int8_t* __restrict__ vq, const bf16* __restrict__ vs,
              acc_t<MODE>* __restrict__ ws_o, int nkv, int S) {
  constexpr int LPR = HD / 4;   // threads per V row, 4 bytes each
  constexpr int RW = NT / LPR;  // rows in flight per block
  typedef acc_t<MODE> A;
  __shared__ __align__(16) int8_t pq[G][CHUNK];  // s8dot: quantized p * vs
  __shared__ float wf[G][CHUNK];                 // dequant: bf16(bf16(p) * vs)
  __shared__ A red[RW][G][HD];

  const int n = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int nchunk = gridDim.z;
  const long long bn = static_cast<long long>(b) * nkv + n;
  const int j0 = c * CHUNK;
  const int j_end = min(S, j0 + CHUNK);
  const bf16* vsb = vs + bn * S;
  const int8_t* vb = vq + bn * S * HD;

  for (int i = threadIdx.x; i < G * CHUNK; i += NT) {
    const int g = i / CHUNK, jj = i % CHUNK;
    const int j = j0 + jj;
    float p = 0.f, vsj = 0.f;
    if (j < j_end) {
      p = ws_p[(bn * G + g) * S + j];
      vsj = __bfloat162float(vsb[j]);
    }
    if constexpr (MODE == S8DOT) {
      const float ps = ws_stat[(bn * G + g) * 2 + 1];
      const float r = clip127(rintf(__fdiv_rn(__fmul_rn(p, vsj), ps)));
      pq[g][jj] = static_cast<int8_t>(static_cast<int>(r));
    } else {
      const float pb = __bfloat162float(__float2bfloat16(p));
      wf[g][jj] = __bfloat162float(__float2bfloat16(__fmul_rn(pb, vsj)));
    }
  }
  __syncthreads();

  const int worker = threadIdx.x / LPR;
  const int d0 = (threadIdx.x % LPR) * 4;
  A acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0;

  if constexpr (MODE == S8DOT) {
    for (int jj = worker * 4; jj < CHUNK; jj += RW * 4) {
      unsigned w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + jj + r;
        w[r] = (j < j_end)
            ? *reinterpret_cast<const unsigned*>(vb + static_cast<long long>(j) * HD + d0)
            : 0u;
      }
      // 4 slots x 4 columns -> 4 columns x 4 slots
      const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
      const unsigned t1 = __byte_perm(w[0], w[1], 0x7362);
      const unsigned u0 = __byte_perm(w[2], w[3], 0x5140);
      const unsigned u1 = __byte_perm(w[2], w[3], 0x7362);
      const unsigned col[4] = {__byte_perm(t0, u0, 0x5410), __byte_perm(t0, u0, 0x7632),
                               __byte_perm(t1, u1, 0x5410), __byte_perm(t1, u1, 0x7632)};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int pk = *reinterpret_cast<const int*>(&pq[g][jj]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[g][e] = __dp4a(static_cast<int>(col[e]), pk, static_cast<int>(acc[g][e]));
      }
    }
  } else {
    for (int jj = worker; jj < CHUNK; jj += RW) {
      const int j = j0 + jj;
      if (j >= j_end) break;
      float f[4];
      unpack4(*reinterpret_cast<const unsigned*>(vb + static_cast<long long>(j) * HD + d0), f);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float wv = wf[g][jj];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] += wv * f[e];
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[worker][g][d0 + e] = acc[g][e];
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += NT) {
    A sum = 0;
#pragma unroll
    for (int w = 0; w < RW; ++w) sum += red[w][i / HD][i % HD];
    ws_o[(bn * nchunk + c) * G * HD + i] = sum;
  }
}

template <int HD, int G, int MODE>
__global__ void finish_kernel(const acc_t<MODE>* __restrict__ ws_o,
                              const float* __restrict__ ws_stat,
                              bf16* __restrict__ o, int nkv, int nchunk) {
  const long long bn = static_cast<long long>(blockIdx.y) * nkv + blockIdx.x;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD;
    acc_t<MODE> sum = 0;
    for (int c = 0; c < nchunk; ++c) sum += ws_o[(bn * nchunk + c) * G * HD + i];
    const float l = fmaxf(ws_stat[(bn * G + g) * 2], 1e-30f);
    float v = static_cast<float>(sum);
    if constexpr (MODE == S8DOT) v = __fmul_rn(v, ws_stat[(bn * G + g) * 2 + 1]);
    o[bn * G * HD + i] = __float2bfloat16(__fdiv_rn(v, l));
  }
}

struct Args {
  const bf16* q; const int8_t* kq; const bf16* ks; const int8_t* vq; const bf16* vs;
  const float* bias; bf16* o; float* ws_s; float* ws_stat; void* ws_o;
  int B, nkv, S; float scale; cudaStream_t stream;
};

template <int HD, int G, int MODE>
int launch(const Args& a) {
  const int nchunk = (a.S + CHUNK - 1) / CHUNK;
  const dim3 per_chunk(a.nkv, a.B, nchunk), per_row(a.nkv, a.B);
  scores_kernel<HD, G, MODE><<<per_chunk, NT, 0, a.stream>>>(
      a.q, a.kq, a.ks, a.bias, a.ws_s, a.nkv, a.S, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_kernel<G, MODE><<<per_row, NT, 0, a.stream>>>(a.ws_s, a.vs, a.ws_stat, a.nkv, a.S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pv_kernel<HD, G, MODE><<<per_chunk, NT, 0, a.stream>>>(
      a.ws_s, a.ws_stat, a.vq, a.vs, static_cast<acc_t<MODE>*>(a.ws_o), a.nkv, a.S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<HD, G, MODE><<<per_row, G * HD, 0, a.stream>>>(
      static_cast<const acc_t<MODE>*>(a.ws_o), a.ws_stat, a.o, a.nkv, nchunk);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int MODE>
int dispatch_group(const Args& a, int G) {
  switch (G) {
    case 1: return launch<HD, 1, MODE>(a);
    case 2: return launch<HD, 2, MODE>(a);
    case 4: return launch<HD, 4, MODE>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int MODE>
int dispatch(const Args& a, int G, int hd) {
  if (hd == 128) return dispatch_group<128, MODE>(a, G);
  if (hd == 64) return dispatch_group<64, MODE>(a, G);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Slots per block; the caller sizes the workspaces from it: ws_s [B, nkv, G, S]
// fp32, ws_stat [B, nkv, G, 2] fp32, ws_o [B, nkv, ceil(S / chunk), G, hd] of
// 32-bit words.
extern "C" int decode_attn_int8_chunk() { return CHUNK; }

#define DECODE_ATTN_INT8_ENTRY(NAME, MODE)                                          \
  extern "C" int NAME(const void* q, const void* kq, const void* ks, const void* vq, \
                      const void* vs, const float* bias, void* o, float* ws_s,       \
                      float* ws_stat, void* ws_o, int B, int nkv, int G, int S,      \
                      int hd, float scale, void* stream) {                           \
    const Args a = {static_cast<const bf16*>(q), static_cast<const int8_t*>(kq),     \
                    static_cast<const bf16*>(ks), static_cast<const int8_t*>(vq),    \
                    static_cast<const bf16*>(vs), bias, static_cast<bf16*>(o), ws_s, \
                    ws_stat, ws_o, B, nkv, S, scale,                                 \
                    static_cast<cudaStream_t>(stream)};                              \
    return dispatch<MODE>(a, G, hd);                                                 \
  }

DECODE_ATTN_INT8_ENTRY(decode_attn_int8_s8dot, S8DOT)
DECODE_ATTN_INT8_ENTRY(decode_attn_int8_dequant, DEQUANT)
