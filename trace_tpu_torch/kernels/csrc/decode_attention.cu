// One decode step of GQA attention over one layer's KV-cache stripe, for
// Hopper (sm_90a): bf16 in, bf16 out, fp32 softmax statistics.
//
// Replaces decode_attention (_kernel_bf16) of
// trace_tpu/kernels/decode_attention.py. The TPU kernel receives the layer
// index as a scalar-prefetch operand to select the stripe of the stacked
// [L, B, NKV, S, hd] cache; here the caller passes the stripe itself, a
// contiguous [B, NKV, S, hd] view, so the kernel reads it in place.
//
// The step is bound by bytes: each (batch row, kv head) stripe is read once
// and carries only G (= 4 for Mistral) query rows, about 2 flops per byte.
// One block per (kv head, batch row) would leave most of the 132 SMs idle
// at serving batch (B x NKV = 16 blocks at B = 2), so the slots are split
// into chunks of CHUNK and the work runs in two launches:
//   1. decode_attn_partial: one block per (kv head, batch row, chunk) holds
//      its G query rows in registers; 8 warps split the chunk's slots, each
//      warp reads whole 256-byte K and V rows (lane l holds elements
//      l*hd/32..), four slots per step to keep loads in flight, and keeps a
//      running max, sum and output accumulator per query row in fp32
//      (online softmax). The warps merge in shared memory and the block
//      writes its chunk's (max, sum, unnormalised output) to a workspace.
//   2. decode_attn_combine: one block per (kv head, batch row) merges the
//      chunks and divides by max(sum, 1e-30), as the TPU kernel does.
// Probabilities are rounded to bf16 before they weight V, as the TPU kernel
// does (p.astype(v.dtype)); their sum stays fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NW = 8;            // warps per partial block
constexpr int KPI = 4;           // slots a warp loads per step
constexpr int CHUNK = 256;       // slots per partial block
constexpr float M_INIT = -1e38f;  // running-max start, below any masked score

template <int EPL>
__device__ __forceinline__ void load_row(const bf16* src, float* dst) {
#pragma unroll
  for (int e = 0; e < EPL; e += 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + e));
    dst[e] = f.x;
    dst[e + 1] = f.y;
  }
}

template <int HD, int G>
__global__ void __launch_bounds__(NW * 32)
    decode_attn_partial(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias,
                        float* __restrict__ ws_ml, float* __restrict__ ws_acc,
                        int nkv, int S, float scale) {
  constexpr int EPL = HD / 32;  // elements of a row per lane
  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];
  __shared__ float sm_acc[NW][G][HD];

  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int nchunk = gridDim.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long bn = static_cast<long long>(b) * nkv + n;
  const bf16* qb = q + bn * G * HD;  // heads n*G .. n*G+G-1 of batch row b
  const bf16* kb = k + bn * S * HD;
  const bf16* vb = v + bn * S * HD;
  const float* bb = bias + static_cast<long long>(b) * S;
  const int j_end = min(S, (c + 1) * CHUNK);

  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) load_row<EPL>(qb + g * HD + lane * EPL, qr[g]);

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = M_INIT;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int j0 = c * CHUNK + warp * KPI; j0 < j_end; j0 += NW * KPI) {
    float kr[KPI][EPL], vr[KPI][EPL], bj[KPI];
#pragma unroll
    for (int u = 0; u < KPI; ++u) {
      const int j = j0 + u;
      if (j < j_end) {
        load_row<EPL>(kb + static_cast<long long>(j) * HD + lane * EPL, kr[u]);
        load_row<EPL>(vb + static_cast<long long>(j) * HD + lane * EPL, vr[u]);
        bj[u] = bb[j];
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
        bj[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < KPI; ++u) {
      if (j0 + u >= j_end) break;  // the same for every lane of the warp
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d += qr[g][e] * kr[u][e];
        s[g] = d;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float x = s[g] * scale + bj[u];
        const float m_new = fmaxf(m[g], x);
        const float alpha = expf(m[g] - m_new);
        const float pe = expf(x - m_new);
        l[g] = l[g] * alpha + pe;
        const float pb = __bfloat162float(__float2bfloat16(pe));
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + pb * vr[u][e];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();

  // merge the warps; the chunk's partial stays unnormalised
  const long long slot = bn * nchunk + c;
  for (int t = threadIdx.x; t < G * HD; t += NW * 32) {
    const int g = t / HD, d = t % HD;
    float M = M_INIT;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w][g]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm_m[w][g] - M);
      lsum += sm_l[w][g] * f;
      out += sm_acc[w][g][d] * f;
    }
    ws_acc[slot * G * HD + t] = out;
    if (d == 0) {
      ws_ml[(slot * G + g) * 2] = M;
      ws_ml[(slot * G + g) * 2 + 1] = lsum;
    }
  }
}

template <int HD, int G>
__global__ void decode_attn_combine(const float* __restrict__ ws_ml,
                                    const float* __restrict__ ws_acc,
                                    bf16* __restrict__ o, int nkv, int nchunk) {
  const long long bn = static_cast<long long>(blockIdx.y) * nkv + blockIdx.x;
  for (int t = threadIdx.x; t < G * HD; t += blockDim.x) {
    const int g = t / HD;
    float M = M_INIT;
    for (int c = 0; c < nchunk; ++c)
      M = fmaxf(M, ws_ml[((bn * nchunk + c) * G + g) * 2]);
    float lsum = 0.f, out = 0.f;
    for (int c = 0; c < nchunk; ++c) {
      const long long slot = bn * nchunk + c;
      const float f = expf(ws_ml[(slot * G + g) * 2] - M);
      lsum += ws_ml[(slot * G + g) * 2 + 1] * f;
      out += ws_acc[slot * G * HD + t] * f;
    }
    o[bn * G * HD + t] = __float2bfloat16(out / fmaxf(lsum, 1e-30f));
  }
}

template <int HD, int G>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, float* ws_ml, float* ws_acc, int B, int nkv, int S,
           float scale, cudaStream_t stream) {
  const int nchunk = (S + CHUNK - 1) / CHUNK;
  decode_attn_partial<HD, G><<<dim3(nkv, B, nchunk), NW * 32, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, ws_ml, ws_acc, nkv, S, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attn_combine<HD, G><<<dim3(nkv, B), G * HD, 0, stream>>>(
      ws_ml, ws_acc, static_cast<bf16*>(o), nkv, nchunk);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch_group(const void* q, const void* k, const void* v,
                   const float* bias, void* o, float* ws_ml, float* ws_acc,
                   int B, int nkv, int G, int S, float scale, cudaStream_t s) {
  switch (G) {
    case 1: return launch<HD, 1>(q, k, v, bias, o, ws_ml, ws_acc, B, nkv, S, scale, s);
    case 2: return launch<HD, 2>(q, k, v, bias, o, ws_ml, ws_acc, B, nkv, S, scale, s);
    case 4: return launch<HD, 4>(q, k, v, bias, o, ws_ml, ws_acc, B, nkv, S, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Slots per partial block; the caller sizes the workspace from it:
// ws_ml [B, nkv, ceil(S / chunk), G, 2], ws_acc [B, nkv, ceil(S / chunk), G, hd].
extern "C" int decode_attn_chunk() { return CHUNK; }

extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v,
                                const float* bias, void* o, float* ws_ml,
                                float* ws_acc, int B, int nkv, int G, int S,
                                int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return dispatch_group<128>(q, k, v, bias, o, ws_ml, ws_acc, B, nkv, G, S, scale, s);
  if (hd == 64)
    return dispatch_group<64>(q, k, v, bias, o, ws_ml, ws_acc, B, nkv, G, S, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
