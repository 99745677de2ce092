// y[M, N] = (x[M, K] @ q[K, N]) * s[N] for Hopper (sm_90a): bf16 x, int8 q,
// bf16 per-column scale s, bf16 or fp32 y; the sum is fp32 over the exact
// values of the int8 weights, scaled once after the whole K sum.
//
// Replaces quant_matmul (_qmm_kernel) and quant_matmul_stacked
// (_qmm_stacked_kernel) of trace_tpu/kernels/quant_matmul.py. The stacked
// TPU kernel receives the layer index as a scalar-prefetch operand and
// selects the stripe of the [L, K, N] weight in its index map; here the
// stacked entry point adds li * K * N to the weight pointer (li * N to the
// scale pointer), so one kernel serves both and layer li is read in place.
//
// At decode (M = batch, a few rows) the product is bound by bytes: K x N
// int8 streamed once, under one flop per byte and row. N is the contiguous
// axis, so a thread's 16-byte load is 16 columns of one k and a block owns
// a strip of 512 columns; N = 4096 has only 8 strips for 132 SMs, so K is
// split over blocks as well:
//   1. qmm_partial: one block per (strip, K chunk, tile of up to 4 rows).
//      Its x rows sit in shared memory as fp32; 8 warps take the chunk's
//      weight rows in turn (4 rows in flight per warp), convert each byte to
//      fp32 (a byte permute into the mantissa of 2^23, one subtract) and
//      multiply-add into 16 x rows registers. The warps merge in shared
//      memory in a fixed order and the block writes its partial sums to a
//      workspace [K chunks, M, N].
//   2. qmm_finish: sums the chunks in order, multiplies by the scale and
//      casts. No atomics: the result is the same from run to run.
// Any M, K, N is right (ragged edges are masked; rows that are not 16-byte
// aligned are read byte by byte). A large M re-reads the weight once per 4
// rows, which is slow and left so: prefill takes the s8 x s8 path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NW = 8;            // warps per block
constexpr int CPT = 16;          // columns per thread: one 16-byte load
constexpr int STRIP = 32 * CPT;  // columns per block
constexpr int KCH_MAX = 1024;    // most rows of a K chunk (x tile in shared memory)
constexpr int KU = 4;            // weight rows a warp loads before it multiplies

__device__ __forceinline__ void load16(const int8_t* row, int col0, int N,
                                       int vec, unsigned (&w)[4]) {
  if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + col0);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned p = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = col0 + 4 * i + b;
        if (c < N) p |= static_cast<unsigned>(static_cast<uint8_t>(row[c])) << (8 * b);
      }
      w[i] = p;
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(NW * 32, 2)
    qmm_partial(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                float* __restrict__ ws, int M, int K, int N, int kchunk, int vec) {
  __shared__ float xs[MT][KCH_MAX];
  __shared__ float red[MT][CPT][33];

  const int strip = blockIdx.x, ks = blockIdx.y, m0 = blockIdx.z * MT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kbeg = ks * kchunk;
  const int klen = min(kchunk, K - kbeg);

  for (int i = threadIdx.x; i < MT * klen; i += NW * 32) {
    const int m = i / klen, k = i % klen;
    xs[m][k] = (m0 + m < M)
        ? __bfloat162float(x[static_cast<long long>(m0 + m) * K + kbeg + k]) : 0.f;
  }
  __syncthreads();

  const int col0 = strip * STRIP + lane * CPT;
  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;

  if (col0 < N) {
    for (int k0 = warp; k0 < klen; k0 += NW * KU) {
      unsigned w[KU][4];
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int k = k0 + u * NW;
        if (k < klen) {
          load16(q + static_cast<long long>(kbeg + k) * N, col0, N, vec, w[u]);
        } else {
          w[u][0] = w[u][1] = w[u][2] = w[u][3] = 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int k = k0 + u * NW;
        if (k >= klen) break;  // the same for every lane of the warp
        float xv[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) xv[m] = xs[m][k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // byte b + 128 into the mantissa of 2^23, minus (2^23 + 128): exact
          const unsigned biased = w[u][i] ^ 0x80808080u;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float wf = __uint_as_float(
                __byte_perm(biased, 0x4B000000u, 0x7540 + b)) - 8388736.f;
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][4 * i + b] = fmaf(xv[m], wf, acc[m][4 * i + b]);
          }
        }
      }
    }
  }

  // merge the warps in a fixed order
  for (int turn = 0; turn < NW; ++turn) {
    if (warp == turn) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          if (turn == 0) red[m][c][lane] = acc[m][c];
          else red[m][c][lane] += acc[m][c];
        }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < MT * STRIP; i += NW * 32) {
    const int m = i / STRIP, c = i % STRIP;
    const int col = strip * STRIP + c;
    if (m0 + m < M && col < N)
      ws[(static_cast<long long>(ks) * M + m0 + m) * N + col] = red[m][c % CPT][c / CPT];
  }
}

template <typename OUT> __device__ __forceinline__ OUT cast_out(float v);
template <> __device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 cast_out<bf16>(float v) {
  return __float2bfloat16(v);
}

template <typename OUT>
__global__ void qmm_finish(const float* __restrict__ ws, const bf16* __restrict__ s,
                           OUT* __restrict__ y, int ksplit, long long MN, int N) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= MN) return;
  float acc = 0.f;
  for (int ks = 0; ks < ksplit; ++ks) acc += ws[ks * MN + idx];
  y[idx] = cast_out<OUT>(acc * __bfloat162float(s[idx % N]));
}

template <int MT>
int launch_partial(const bf16* x, const int8_t* q, float* ws, int M, int K, int N,
                   int kchunk, int ksplit, int vec, cudaStream_t stream) {
  const dim3 grid((N + STRIP - 1) / STRIP, ksplit, (M + MT - 1) / MT);
  qmm_partial<MT><<<grid, NW * 32, 0, stream>>>(x, q, ws, M, K, N, kchunk, vec);
  return static_cast<int>(cudaGetLastError());
}

int run(const void* x, const int8_t* q, const bf16* s, void* y, float* ws, int M,
        int K, int N, int kchunk, int out_f32, cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1 || kchunk < 1 || kchunk > KCH_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ksplit = (K + kchunk - 1) / kchunk;
  const int vec = (N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) ? 1 : 0;
  const bf16* xb = static_cast<const bf16*>(x);
  int err;
  if (M == 1) err = launch_partial<1>(xb, q, ws, M, K, N, kchunk, ksplit, vec, stream);
  else if (M == 2) err = launch_partial<2>(xb, q, ws, M, K, N, kchunk, ksplit, vec, stream);
  else err = launch_partial<4>(xb, q, ws, M, K, N, kchunk, ksplit, vec, stream);
  if (err != 0) return err;
  const long long MN = static_cast<long long>(M) * N;
  const unsigned blocks = static_cast<unsigned>((MN + 255) / 256);
  if (out_f32)
    qmm_finish<float><<<blocks, 256, 0, stream>>>(ws, s, static_cast<float*>(y), ksplit, MN, N);
  else
    qmm_finish<bf16><<<blocks, 256, 0, stream>>>(ws, s, static_cast<bf16*>(y), ksplit, MN, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The caller chooses kchunk (rows of K per block, at most quant_matmul_kchunk_max)
// and sizes the workspace: ws [ceil(K / kchunk), M, N] fp32.
extern "C" int quant_matmul_kchunk_max() { return KCH_MAX; }
extern "C" int quant_matmul_strip() { return STRIP; }

extern "C" int quant_matmul_i8(const void* x, const void* q, const void* s, void* y,
                               float* ws, int M, int K, int N, int kchunk,
                               int out_f32, void* stream) {
  return run(x, static_cast<const int8_t*>(q), static_cast<const bf16*>(s), y, ws,
             M, K, N, kchunk, out_f32, static_cast<cudaStream_t>(stream));
}

// q [L, K, N] and s [L, N] whole; layer li is read in place.
extern "C" int quant_matmul_stacked_i8(const void* x, const void* q, const void* s,
                                       int li, int L, void* y, float* ws, int M,
                                       int K, int N, int kchunk, int out_f32,
                                       void* stream) {
  if (li < 0 || li >= L) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* ql = static_cast<const int8_t*>(q) + static_cast<long long>(li) * K * N;
  const bf16* sl = static_cast<const bf16*>(s) + static_cast<long long>(li) * N;
  return run(x, ql, sl, y, ws, M, K, N, kchunk, out_f32,
             static_cast<cudaStream_t>(stream));
}
