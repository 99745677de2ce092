// Attention forward in fp32 on the CUDA cores (any sm_90a card): fp32 in,
// fp32 out, fp32 products, statistics and accumulators. The fp32 form of
// attention.cu, for a model served or trained in fp32
// (``model_init(dtype=torch.float32)``, an fp32 TraceConfig); the wrappers of
// kernels/flash_attention.py and kernels/flash_backward.py choose it by
// dtype.
//
// One kernel serves the fp32 forms of three TPU kernels, as attention.cu
// does for bf16:
//   * flash_attention (_attn_kernel) of trace_tpu/kernels/flash_attention.py:
//     causal GQA attention over [B, H, T, hd] with an additive fp32 [B, Tk]
//     bias; with a query offset (chunked prefill: query row r sits at
//     position q_offset + r and sees the keys j <= q_offset + r);
//   * vit_attention_btd (_btd_kernel), same file: bidirectional, read and
//     written through (batch, head, token) element strides, so that q, k and
//     v may be column slices of the fused [B, P, 3D] projection; keys >=
//     kv_len masked;
//   * flash_attention_fwd_res (_fwd_res_kernel) of
//     trace_tpu/kernels/flash_backward.py: with an ``lse`` pointer also each
//     query row's natural-log logsumexp, which attention_bwd_f32.cu reads.
// The Pallas kernels compute in the operand's dtype, fp32 here: the products
// run as fp32 FMA, not as TF32 mma, which would round the operands to 10
// mantissa bits (exactness is what an fp32 model is served for).
//
// Bound on an H100: operations, at the fp32 CUDA-core peak (67 TFLOP/s): the
// prefill shape's ~59 GFLOP of visible causal pairs take at least 0.9 ms.
// Design: a block owns 64 query rows of one (head, batch row) and 256
// threads; Q sits in shared memory, and tiles of 32 keys of K and V pass
// through it (hd = 128: 73 KB, three blocks an SM). A thread owns 4 query
// rows (ty + 16 i) and, of the score tile, 2 keys (tx + 16 j), of the output
// HD / 16 columns (tx + 16 c): its rows' statistics stay in registers, the
// row max and sum reduce over the 16 threads of a half-warp. Rows are padded
// by one word so that the 16 threads reading 16 rows of K hit 16 banks. The
// scores use expf in natural-log units, as the plain version. Masks use the
// finite -1e30 of the JAX package; keys past Tk weigh 0. Causal blocks are
// issued longest first, and key tiles past a block's last row are skipped.
// A query row that sees no key gets the mean of v over the Tk keys, as the
// plain version gives it (its softmax is uniform over scores that are all
// -1e30): unseen_rows_f32_kernel, a second launch where there is a bias,
// writes it, as attention.cu does for bf16. Nothing is atomic, and a call
// repeats bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows of a block
constexpr int BK = 32;        // keys of a tile
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;
constexpr float M_INIT = -1e38f;  // running-max start, below any masked score

struct Params {
  const float *q, *k, *v, *bias;  // bias: [B, Tk] additive, or null
  float* o;
  float* lse;  // [B, H, Tq] or null
  int H, group, tq, tk, kv_len, causal, q_offset;
  float scale;
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot, sbias;
};

template <int HD>
constexpr int smem_bytes() {
  return 4 * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(THREADS) attn_fwd_f32_kernel(const Params p) {
  constexpr int RS = HD + 1;       // padded row stride of the Q and K tiles
  constexpr int NC = HD / 16;      // output columns a thread
  extern __shared__ float smem[];
  float* const Qs = smem;                 // [BQ][RS]
  float* const Ks = Qs + BQ * RS;         // [BK][RS]
  float* const Vs = Ks + BK * RS;         // [BK][HD]
  float* const Ps = Vs + BK * HD;         // [BQ][BK + 1]
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BQ;
  const int kvh = h / p.group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* qg = p.q + b * p.sqb + h * p.sqh;
  const float* kg = p.k + b * p.skb + kvh * p.skh;
  const float* vg = p.v + b * p.svb + kvh * p.svh;
  const float* bias = p.bias ? p.bias + b * p.sbias : nullptr;

  for (int i = threadIdx.x; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    Qs[r * RS + d] = q0 + r < p.tq ? qg[static_cast<long long>(q0 + r) * p.sqt + d] : 0.f;
  }
  int lim[4];
  float m[4], l[4], o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lim[i] = p.causal ? min(p.kv_len, p.q_offset + row + 1) : p.kv_len;
    m[i] = M_INIT;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }
  const int k_end = p.causal ? min(p.tk, p.q_offset + q0 + BQ) : p.tk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < p.tk;
      const long long j = k0 + r;
      Ks[r * RS + d] = in ? kg[j * p.skt + d] : 0.f;
      Vs[r * HD + d] = in ? vg[j * p.svt + d] : 0.f;
    }
    __syncthreads();
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float k0v = Ks[tx * RS + d], k1v = Ks[(tx + 16) * RS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = Qs[(ty + 16 * i) * RS + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
      }
    }
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = M_INIT;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int jj = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (bias && jj < p.tk) x += bias[jj];
        x = jj < lim[i] ? x : NEG_INF;
        x = jj < p.tk ? x : -INFINITY;  // no such key: weight 0, not in the max
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float pe = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = pe;
        sum += pe;
      }
      l[i] = l[i] * alpha[i] + half_warp_sum(sum);
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha[i];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = Ps[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) o[i][c] = fmaf(pv, vv[c], o[i][c]);
      }
    }
  }

  float* const og = p.o + b * p.sob + h * p.soh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.tq) continue;
    const float lt = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      og[static_cast<long long>(row) * p.sot + tx + 16 * c] = o[i][c] / lt;
    if (p.lse && tx == 0)  // a row that saw no key keeps m = -1e30: lse is exactly -1e30
      p.lse[(static_cast<long long>(b) * p.H + h) * p.tq + row] = m[i] + logf(lt);
  }
}

// The rows of batch row b that see no key get the mean of v over the Tk keys
// in each query head of kv head blockIdx.x; 32 columns a block, 8 key groups
// of 32 threads summed in group order (a fixed order). Causal, row r sees
// the keys j <= q_offset + r below kv_len whose bias is above -1e29: the
// rows with q_offset + r below the first such key see none; not causal,
// every row sees none when no key is visible. Launched after the main
// kernel, only with a bias.
__global__ void __launch_bounds__(THREADS) unseen_rows_f32_kernel(const Params p) {
  const int kvh = blockIdx.x, b = blockIdx.y, c = blockIdx.z * 32 + threadIdx.x % 32;
  const int grp = threadIdx.x / 32;
  const float* bias = p.bias + b * p.sbias;
  const int lim = min(p.tk, p.kv_len);
  __shared__ int first;
  __shared__ float part[8][32];
  if (threadIdx.x == 0) first = lim;
  __syncthreads();
  for (int j = threadIdx.x; j < lim; j += THREADS)
    if (bias[j] > -1e29f) {
      atomicMin(&first, j);
      break;
    }
  __syncthreads();
  const int rows = first >= lim ? p.tq : p.causal ? max(0, min(first - p.q_offset, p.tq)) : 0;
  if (rows == 0) return;
  const float* vb = p.v + b * p.svb + kvh * p.svh + c;
  float s = 0.f;
  for (int j = grp; j < p.tk; j += 8) s += vb[static_cast<long long>(j) * p.svt];
  part[grp][threadIdx.x % 32] = s;
  __syncthreads();
  if (grp == 0) {
    for (int g = 1; g < 8; ++g) s += part[g][threadIdx.x];
    part[0][threadIdx.x] = s / p.tk;
  }
  __syncthreads();
  const float mean = part[0][threadIdx.x % 32];
  for (int i = grp; i < p.group * rows; i += 8) {
    const int h = kvh * p.group + i / rows, r = i % rows;
    p.o[b * p.sob + h * p.soh + static_cast<long long>(r) * p.sot + c] = mean;
  }
}

template <int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attn_fwd_f32_kernel<HD><<<dim3(p.H, B, (p.tq + BQ - 1) / BQ), THREADS, bytes, stream>>>(p);
  if (p.bias) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    unseen_rows_f32_kernel<<<dim3(p.H / p.group, B, HD / 32), THREADS, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements; the last dim of q, k, v and o has unit stride.
extern "C" int attn_fwd_f32(
    const float* q, const float* k, const float* v, const float* bias, float* o, float* lse,
    int B, int H, int group, int tq, int tk, int hd, int kv_len, int causal, int q_offset,
    float scale, long long sqb, long long sqh, long long sqt, long long skb, long long skh,
    long long skt, long long svb, long long svh, long long svt, long long sob, long long soh,
    long long sot, long long sbias, void* stream) {
  if (B < 1 || H < 1 || group < 1 || H % group || tq < 1 || tk < 1 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = {q, k, v, bias, o, lse, H, group, tq, tk, kv_len, causal, q_offset, scale,
                    sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot, sbias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch<128>(p, B, s);
  if (hd == 64) return launch<64>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
