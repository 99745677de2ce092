// One decode step of GQA attention with an fp32 query, on the CUDA cores:
// the fp32 forms of decode_attention.cu and decode_attention_int8.cu, for a
// model served in fp32 (``model_init(dtype=torch.float32)``). Replaces, in
// fp32, trace_tpu/kernels/decode_attention.py decode_attention, which
// computes in the operand's dtype, with its bodies:
//   * _kernel_bf16 (:47) over an fp32 cache (decode_attn_f32):
//       s = (q . k) * scale + bias, m = max(s), p = exp(s - m), l = sum(p),
//       o = (p . v) / max(l, 1e-30), all in fp32;
//   * _kernel_int8_s8dot / _kernel_int8_s8dot_stacked (:97, :145) over the
//     int8 cache with bf16 per-slot scales (decode_attn_int8_f32_s8dot): the
//     q rows quantized from fp32 (qs = max|q| * (1/127), q8 = rint(q / qs)),
//     integer q8 . k8, s = ((s32 * (qs * scale)) * ks) + bias; then
//     pv = p * vs quantized by ps = max(pv) * (1/127), the integer p8 . v8,
//     o = (o32 * ps) / max(l, 1e-30): the plain version's fp32 steps in its
//     order, the integer sums exact in int32;
//   * _kernel_int8 (:68), the dequantizing body (decode_attn_int8_f32_dequant):
//     q rounded to bf16, s = ((q . k8) * ks) * scale + bias, the weights
//     bf16(bf16(p) * vs) times v8 summed in fp32, divided by max(l, 1e-30).
// The output is fp32.
//
// Bound on an H100: bytes; each (batch row, kv head) stripe is read once for
// its G query rows. A block owns one (kv head, batch row) and 8 warps; a warp
// takes one slot at a time (slots w, w + 8, ...), a lane HD / 32 columns of
// it. Pass 1 reads the K rows of the visible slots (bias above -1e29; a
// masked slot's score is exactly its bias, since |q . k * scale| is far below
// half an ulp of 1e30) and writes the G scores of the slot to the scratch
// [B, NKV * G, S] that the wrapper allocates; the block reduces the row
// maxima. Pass 2 reads the scores back, forms p (and, for s8dot, the max of
// p * vs, then a third pass the quantized weights), and reads the V rows of
// the slots whose weight is not 0 for some row (all slots of a row with no
// visible slot, whose p is 1 everywhere, as the TPU kernel gives it). The
// warps' partial sums reduce through shared memory in warp order: a call
// repeats bit for bit. G is 1 ... 8 (the wrapper splits a larger group).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int WARPS = 8;
constexpr int MAXG = 8;

enum Mode { F32 = 0, S8DOT = 1, DEQUANT = 2 };

struct Params {
  const float* q;        // [B, NKV * G, hd]
  const void* k;         // fp32 or int8 [B, NKV, S, hd]
  const void* v;
  const bf16* ks;        // [B, NKV, 1, S] (int8 cache) or null
  const bf16* vs;
  const float* bias;     // [B, S]
  float* o;              // [B, NKV * G, hd]
  float* sc;             // scratch [B, NKV * G, S]
  int NKV, G, S;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

__device__ __forceinline__ int warp_sum_i(int x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

// a value per (warp, row) reduced over the warps in warp order, into red[row]
template <bool MAX>
__device__ __forceinline__ void block_reduce(float (&part)[WARPS][MAXG], float* red, int G) {
  __syncthreads();
  if (threadIdx.x < G) {
    float x = part[0][threadIdx.x];
    for (int w = 1; w < WARPS; ++w)
      x = MAX ? fmaxf(x, part[w][threadIdx.x]) : x + part[w][threadIdx.x];
    red[threadIdx.x] = x;
  }
  __syncthreads();
}

template <int MODE, int HD>
__global__ void __launch_bounds__(WARPS * 32) decode_f32_kernel(const Params p) {
  constexpr int E = HD / 32;  // columns a lane
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = p.G, S = p.S;
  const long long row0 = (static_cast<long long>(b) * p.NKV + kvh) * G;  // first q row
  const long long stripe = (static_cast<long long>(b) * p.NKV + kvh) * S;  // first slot
  const float* bias = p.bias + static_cast<long long>(b) * S;
  float* sc = p.sc + row0 * S;
  __shared__ float part[WARPS][MAXG];
  __shared__ float red_m[MAXG], red_l[MAXG], red_x[MAXG];
  __shared__ float acc_f[WARPS][MAXG][HD];  // the warps' partial outputs (s8dot: ints)

  // the lane's columns of the q rows (s8dot: quantized; dequant: rounded to bf16)
  float qf[MAXG][E];
  int qi[MAXG][E];
  float qs[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    qs[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float x = g < G ? p.q[(row0 + g) * HD + lane * E + e] : 0.f;
      if (MODE == DEQUANT) x = __bfloat162float(__float2bfloat16_rn(x));
      qf[g][e] = x;
      qi[g][e] = 0;
    }
    if (MODE == S8DOT && g < G) {
      float mx = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) mx = fmaxf(mx, fabsf(qf[g][e]));
      qs[g] = fmaxf(warp_max(mx), 1e-8f) * (1.0f / 127.0f);
#pragma unroll
      for (int e = 0; e < E; ++e)
        qi[g][e] = static_cast<int>(fminf(fmaxf(rintf(qf[g][e] / qs[g]), -127.f), 127.f));
    }
  }

  // pass 1: scores of the visible slots, the row maxima
  float mx[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) mx[g] = -INFINITY;
  for (int s = warp; s < S; s += WARPS) {
    const float bs = bias[s];
    float x[MAXG];
    if (bs > -1e29f) {
      if (MODE == F32) {
        const float* kr = static_cast<const float*>(p.k) + (stripe + s) * HD + lane * E;
        float kv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) kv[e] = kr[e];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) d = fmaf(qf[g][e], kv[e], d);
          x[g] = g < G ? warp_sum(d) * p.scale + bs : 0.f;
        }
      } else {
        const int8_t* kr = static_cast<const int8_t*>(p.k) + (stripe + s) * HD + lane * E;
        int kv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) kv[e] = kr[e];
        const float ksv = __bfloat162float(p.ks[stripe + s]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) {
            x[g] = 0.f;
            continue;
          }
          if (MODE == S8DOT) {
            int d = 0;
#pragma unroll
            for (int e = 0; e < E; ++e) d += qi[g][e] * kv[e];
            x[g] = static_cast<float>(warp_sum_i(d)) * (qs[g] * p.scale) * ksv + bs;
          } else {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) d = fmaf(qf[g][e], static_cast<float>(kv[e]), d);
            x[g] = warp_sum(d) * ksv * p.scale + bs;
          }
        }
      }
    } else {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) x[g] = bs;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        mx[g] = fmaxf(mx[g], x[g]);
        if (lane == g) sc[static_cast<long long>(g) * S + s] = x[g];
      }
    }
  }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < MAXG; ++g) part[warp][g] = mx[g];
  block_reduce<true>(part, red_m, G);

  // pass 2: p, l (and for s8dot the max of p * vs); P.V for fp32 and dequant
  float m[MAXG], l[MAXG], pvmax[MAXG], acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = g < G ? red_m[g] : 0.f;
    l[g] = 0.f;
    pvmax[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  for (int s = warp; s < S; s += WARPS) {
    float pe[MAXG];
    bool any = false;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      pe[g] = g < G ? expf(sc[static_cast<long long>(g) * S + s] - m[g]) : 0.f;
      l[g] += pe[g];
      any |= pe[g] != 0.f;
    }
    if (MODE == S8DOT) {
      const float vsv = __bfloat162float(p.vs[stripe + s]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) pvmax[g] = fmaxf(pvmax[g], pe[g] * vsv);
      continue;
    }
    if (!any) continue;
    if (MODE == F32) {
      const float* vr = static_cast<const float*>(p.v) + (stripe + s) * HD + lane * E;
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = vr[e];
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pe[g], vv[e], acc[g][e]);
    } else {  // dequant: w = bf16(bf16(p) * vs)
      const int8_t* vr = static_cast<const int8_t*>(p.v) + (stripe + s) * HD + lane * E;
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = static_cast<float>(vr[e]);
      const float vsv = __bfloat162float(p.vs[stripe + s]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        const float w = __bfloat162float(__float2bfloat16_rn(
            __bfloat162float(__float2bfloat16_rn(pe[g])) * vsv));
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(w, vv[e], acc[g][e]);
      }
    }
  }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < MAXG; ++g) part[warp][g] = l[g];
  block_reduce<false>(part, red_l, G);

  if (MODE == S8DOT) {
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < MAXG; ++g) part[warp][g] = pvmax[g];
    block_reduce<true>(part, red_x, G);
    float ps[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) ps[g] = g < G ? fmaxf(red_x[g], 1e-30f) * (1.0f / 127.0f) : 1.f;
    // pass 3: the quantized weights p8 = rint(p * vs / ps) and the integer p8 . v8
    int acci[MAXG][E];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) acci[g][e] = 0;
    for (int s = warp; s < S; s += WARPS) {
      const float vsv = __bfloat162float(p.vs[stripe + s]);
      int pq[MAXG];
      bool any = false;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        const float pe = g < G ? expf(sc[static_cast<long long>(g) * S + s] - m[g]) : 0.f;
        pq[g] = static_cast<int>(fminf(fmaxf(rintf((pe * vsv) / ps[g]), -127.f), 127.f));
        any |= pq[g] != 0;
      }
      if (!any) continue;
      const int8_t* vr = static_cast<const int8_t*>(p.v) + (stripe + s) * HD + lane * E;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int vv = vr[e];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) acci[g][e] += pq[g] * vv;
      }
    }
    // the warps' integer sums, added in int: exact
    int (*acc_i)[MAXG][HD] = reinterpret_cast<int (*)[MAXG][HD]>(acc_f);
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (g < G) acc_i[warp][g][lane * E + e] = acci[g][e];
    __syncthreads();
    for (int i = threadIdx.x; i < G * HD; i += WARPS * 32) {
      const int g = i / HD, c = i % HD;
      int t = 0;
      for (int w = 0; w < WARPS; ++w) t += acc_i[w][g][c];
      const float psg = fmaxf(red_x[g], 1e-30f) * (1.0f / 127.0f);
      p.o[(row0 + g) * HD + c] = (static_cast<float>(t) * psg) / fmaxf(red_l[g], 1e-30f);
    }
    return;
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (g < G) acc_f[warp][g][lane * E + e] = acc[g][e];
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += WARPS * 32) {
    const int g = i / HD, c = i % HD;
    float t = acc_f[0][g][c];
    for (int w = 1; w < WARPS; ++w) t += acc_f[w][g][c];
    p.o[(row0 + g) * HD + c] = t / fmaxf(red_l[g], 1e-30f);
  }
}

template <int MODE>
int launch(const Params& p, int B, int hd, cudaStream_t stream) {
  if (p.G < 1 || p.G > MAXG || p.S < 1 || B < 1 || p.NKV < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.NKV, B);
  if (hd == 128)
    decode_f32_kernel<MODE, 128><<<grid, WARPS * 32, 0, stream>>>(p);
  else if (hd == 64)
    decode_f32_kernel<MODE, 64><<<grid, WARPS * 32, 0, stream>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o [B, NKV * G, hd] fp32; k, v [B, NKV, S, hd] fp32; bias [B, S]; scratch
// [B, NKV * G, S] fp32; all contiguous
extern "C" int decode_attn_f32(const float* q, const float* k, const float* v,
                               const float* bias, float* o, float* scratch, int B, int NKV,
                               int G, int S, int hd, float scale, void* stream) {
  const Params p = {q, k, v, nullptr, nullptr, bias, o, scratch, NKV, G, S, scale};
  return launch<F32>(p, B, hd, static_cast<cudaStream_t>(stream));
}

// the int8 stripe: kq, vq [B, NKV, S, hd] int8, ks, vs [B, NKV, 1, S] bf16
extern "C" int decode_attn_int8_f32_s8dot(const float* q, const void* kq, const void* ks,
                                          const void* vq, const void* vs, const float* bias,
                                          float* o, float* scratch, int B, int NKV, int G,
                                          int S, int hd, float scale, void* stream) {
  const Params p = {q, kq, vq, static_cast<const bf16*>(ks), static_cast<const bf16*>(vs),
                    bias, o, scratch, NKV, G, S, scale};
  return launch<S8DOT>(p, B, hd, static_cast<cudaStream_t>(stream));
}

extern "C" int decode_attn_int8_f32_dequant(const float* q, const void* kq, const void* ks,
                                            const void* vq, const void* vs, const float* bias,
                                            float* o, float* scratch, int B, int NKV, int G,
                                            int S, int hd, float scale, void* stream) {
  const Params p = {q, kq, vq, static_cast<const bf16*>(ks), static_cast<const bf16*>(vs),
                    bias, o, scratch, NKV, G, S, scale};
  return launch<DEQUANT>(p, B, hd, static_cast<cudaStream_t>(stream));
}
