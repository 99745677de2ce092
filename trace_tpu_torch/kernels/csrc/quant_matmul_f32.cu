// Weight products of quantized leaves with fp32 activations, on the CUDA
// cores: the fp32 forms of quant_matmul.cu and quant_matmul_p4.cu, for a
// model served in fp32. Replaces, in fp32, trace_tpu/kernels/quant_matmul.py
// quant_matmul (:320) and quant_matmul_stacked (:418) (int8 q, FORM_I8),
// quant_matmul_p4 (:133) (nibble-packed int4, per-channel s, FORM_P4) and
// quant_matmul_p4_grouped (:239) (groups of K / G rows, FORM_P4G), which
// compute in x's dtype:
//     FORM_I8, FORM_P4:  y = (x @ q) * s     (the scale once, on the fp32 sum)
//     FORM_P4G:          y = x @ (q * s[k / (K / G)])
// Every weight is exact in fp32 (an int8, a nibble, or a nibble times a bf16
// scale), so the products are exact and only the order of the fp32 sums
// differs from the plain version. A packed byte qp[k, n] holds weight rows k
// (low nibble, sign-extended) and k + K / 2 (high nibble). The stacked entry
// points are these with the layer's weight and scale pointers (the wrapper
// offsets them; nothing is copied).
//
// Two forms, as the bf16 kernels have:
//   * up to 8 rows of x (a decode step), split K: bound by bytes, one
//     streaming read of the weight. A block takes 256 columns (8 a lane, one
//     8-byte load a weight row) and a chunk of the weight rows, its 8 warps
//     taking every eighth row of it (a packed row: both its nibbles, weight
//     rows r and r + K / 2), each multiply-adding MT rows of x (read from
//     L1, the same address in every lane) into MT x 8 fp32 sums. The
//     warps' sums reduce through shared memory in warp order into the
//     split's partial [M, N] of a workspace the wrapper allocates; a second
//     launch adds the splits in order and applies the scale. The wrapper
//     picks the splits so that about two waves of blocks stream the weight.
//   * more rows (a prefill), a tiled fp32 GEMM: 128 x 128 output tiles, 8 k a
//     step, each of 256 threads an 8 x 8 block of outputs, x transposed and
//     the weights converted to fp32 in shared memory; bound by operations at
//     the fp32 CUDA-core peak (67 TFLOP/s).
// The products are fp32 FMA, not TF32 mma. Nothing is atomic: a call
// repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
enum Form { FORM_I8 = 0, FORM_P4 = 1, FORM_P4G = 2 };
constexpr int WARPS = 8;
constexpr int COLS = 256;  // columns of a split-K block: 8 a lane

struct Params {
  const float* x;   // [M, K]
  const int8_t* w;  // [K, N] int8, or [K / 2, N] packed
  const bf16* s;    // [N] or [G, N]
  float* ws;        // split partials [splits, M, N]
  void* y;          // [M, N] fp32 or bf16
  int M, K, N, groups, chunk, out_f32;
};

// the weights of stored row r at columns n .. n + 7 in fp32 (grouped ones
// times their scale): w0 of weight row r, and, packed, w1 of row r + K / 2
template <int FORM>
__device__ __forceinline__ void weights8(const Params& p, int r, int n, float (&w0)[8],
                                         float (&w1)[8]) {
  const int8_t* row = p.w + static_cast<long long>(r) * p.N + n;
  __align__(8) int8_t b[8];
  if (n + 8 <= p.N && p.N % 8 == 0 && reinterpret_cast<uintptr_t>(p.w) % 8 == 0) {
    *reinterpret_cast<uint2*>(b) = *reinterpret_cast<const uint2*>(row);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) b[e] = n + e < p.N ? row[e] : 0;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int v = b[e];
    w0[e] = FORM == FORM_I8 ? static_cast<float>(v)
                            : static_cast<float>(static_cast<int>(static_cast<int8_t>(v << 4)) >> 4);
    w1[e] = FORM == FORM_I8 ? 0.f : static_cast<float>(v >> 4);
  }
  if (FORM == FORM_P4G) {
    const int gsize = p.K / p.groups, half = p.K / 2;
    const bf16* s0 = p.s + static_cast<long long>(r / gsize) * p.N + n;
    const bf16* s1 = p.s + static_cast<long long>((r + half) / gsize) * p.N + n;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      w0[e] *= n + e < p.N ? __bfloat162float(s0[e]) : 0.f;
      w1[e] *= n + e < p.N ? __bfloat162float(s1[e]) : 0.f;
    }
  }
}

// one weight, for a ragged column edge and the tiled form
template <int FORM>
__device__ __forceinline__ float weight1(const Params& p, int k, int n) {
  const int half = p.K / 2;
  const int v = p.w[static_cast<long long>(FORM == FORM_I8 ? k : k % half) * p.N + n];
  float w = FORM == FORM_I8 ? static_cast<float>(v)
          : static_cast<float>(k < half ? static_cast<int>(static_cast<int8_t>(v << 4)) >> 4
                                        : v >> 4);
  if (FORM == FORM_P4G)
    w *= __bfloat162float(p.s[static_cast<long long>(k / (p.K / p.groups)) * p.N + n]);
  return w;
}

template <int FORM, int MT>
__global__ void __launch_bounds__(WARPS * 32) splitk_kernel(const Params p) {
  extern __shared__ float red[];  // [WARPS][MT][COLS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * COLS + lane * 8;
  const int rows = FORM == FORM_I8 ? p.K : p.K / 2;  // stored weight rows
  const int r_begin = blockIdx.y * p.chunk, r_end = min(rows, r_begin + p.chunk);
  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[m][e] = 0.f;
  if (n < p.N) {
#pragma unroll 4
    for (int r = r_begin + warp; r < r_end; r += WARPS) {
      float w0[8], w1[8];
      weights8<FORM>(p, r, n, w0, w1);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* xr = p.x + static_cast<long long>(m) * p.K;
        const float x0 = m < p.M ? __ldg(xr + r) : 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[m][e] = fmaf(x0, w0[e], acc[m][e]);
        if (FORM != FORM_I8) {
          const float x1 = m < p.M ? __ldg(xr + rows + r) : 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[m][e] = fmaf(x1, w1[e], acc[m][e]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(warp * MT + m) * COLS + lane * 8 + e] = acc[m][e];
  __syncthreads();
  float* part = p.ws + static_cast<long long>(blockIdx.y) * p.M * p.N;
  for (int i = threadIdx.x; i < MT * COLS; i += WARPS * 32) {
    const int m = i / COLS, c = i % COLS, col = blockIdx.x * COLS + c;
    if (m >= p.M || col >= p.N) continue;
    float t = red[m * COLS + c];
    for (int w = 1; w < WARPS; ++w) t += red[(w * MT + m) * COLS + c];
    part[static_cast<long long>(m) * p.N + col] = t;
  }
}

// y = (sum of the splits' partials, in split order) [* s], cast
template <int FORM>
__global__ void finish_kernel(const Params p, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(p.M) * p.N;
  if (i >= total) return;
  float t = p.ws[i];
  for (int sp = 1; sp < splits; ++sp) t += p.ws[sp * total + i];
  if (FORM != FORM_P4G) t *= __bfloat162float(p.s[i % p.N]);
  if (p.out_f32)
    static_cast<float*>(p.y)[i] = t;
  else
    static_cast<bf16*>(p.y)[i] = __float2bfloat16_rn(t);
}

constexpr int TM = 128, TN = 128, TK = 8;

template <int FORM>
__global__ void __launch_bounds__(256) tiled_kernel(const Params p) {
  __shared__ __align__(16) float As[TK][TM];  // x, transposed
  __shared__ __align__(16) float Bs[TK][TN];  // weights in fp32
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // loads: x rows m0 + t / 2, k k0 + 4 (t % 2) .. + 3; weights row k0 + t / 32,
  // columns n0 + 4 (t % 32) .. + 3
  const int ar = threadIdx.x / 2, ak = 4 * (threadIdx.x % 2);
  const int bk = threadIdx.x / 32, bn = 4 * (threadIdx.x % 32);
  for (int k0 = 0; k0 < p.K; k0 += TK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + ar, k = k0 + ak + e;
      As[ak + e][ar] = m < p.M && k < p.K ? p.x[static_cast<long long>(m) * p.K + k] : 0.f;
      const int kk = k0 + bk, nn = n0 + bn + e;
      Bs[bk][bn + e] = kk < p.K && nn < p.N ? weight1<FORM>(p, kk, nn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(&As[k][8 * ty]);
      *reinterpret_cast<float4*>(a + 4) = *reinterpret_cast<const float4*>(&As[k][8 * ty + 4]);
      *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(&Bs[k][8 * tx]);
      *reinterpret_cast<float4*>(b + 4) = *reinterpret_cast<const float4*>(&Bs[k][8 * tx + 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 8 * ty + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * tx + j;
      if (n >= p.N) continue;
      float t = acc[i][j];
      if (FORM != FORM_P4G) t *= __bfloat162float(p.s[n]);
      const long long o = static_cast<long long>(m) * p.N + n;
      if (p.out_f32)
        static_cast<float*>(p.y)[o] = t;
      else
        static_cast<bf16*>(p.y)[o] = __float2bfloat16_rn(t);
    }
  }
}

template <int FORM, int MT>
int launch_splitk(const Params& p, int splits, cudaStream_t stream) {
  const int bytes = WARPS * MT * COLS * 4;
  const cudaError_t attr = cudaFuncSetAttribute(
      splitk_kernel<FORM, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  splitk_kernel<FORM, MT><<<dim3((p.N + COLS - 1) / COLS, splits), WARPS * 32, bytes, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = static_cast<long long>(p.M) * p.N;
  finish_kernel<FORM><<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(p, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int FORM>
int launch(const Params& p, int splits, cudaStream_t stream) {
  if (p.M <= 8)  // two row tiles: a decode step at B <= 2, and up to 8
    return p.M <= 2 ? launch_splitk<FORM, 2>(p, splits, stream)
                    : launch_splitk<FORM, 8>(p, splits, stream);
  tiled_kernel<FORM><<<dim3((p.N + TN - 1) / TN, (p.M + TM - 1) / TM), 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] fp32; w [K, N] int8 (form 0) or [K / 2, N] packed (forms 1, 2);
// s [N] (forms 0, 1) or [groups, N] (form 2) bf16; y [M, N] fp32 (out_f32)
// or bf16; for M <= 8 a workspace of splits x M x N fp32 and the stored
// weight rows of a split (chunk: of K rows, packed of K / 2), all
// contiguous. M > 8 reads neither.
extern "C" int quant_matmul_f32(const float* x, const void* w, const void* s, float* ws,
                                void* y, int M, int K, int N, int form, int groups,
                                int splits, int chunk, int out_f32, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (form != FORM_I8 && K % 2) ||
      (form == FORM_P4G && (groups < 1 || K % groups)) ||
      (M <= 8 && (splits < 1 || chunk < 1 ||
                  static_cast<long long>(splits) * chunk < (form == FORM_I8 ? K : K / 2))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = {x, static_cast<const int8_t*>(w), static_cast<const bf16*>(s), ws, y,
                    M, K, N, groups, chunk, out_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == FORM_I8) return launch<FORM_I8>(p, splits, st);
  if (form == FORM_P4) return launch<FORM_P4>(p, splits, st);
  if (form == FORM_P4G) return launch<FORM_P4G>(p, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
