// Attention backward in fp32 on the CUDA cores: the fp32 form of
// attention_bwd.cu, for training an fp32 model. From the forward's residuals
// o and lse (attention_f32.cu),
//
//     p = exp(s - lse)        delta = rowsum(do * o)
//     dv = p^T do             ds = p * (do v^T - delta)
//     dq = ds k * scale       dk = ds^T q * scale
//
// with dk and dv summed over the G query heads of a kv head. Replaces, in
// fp32, trace_tpu/kernels/flash_backward.py flash_attention_bwd: _dq_kernel
// and _dkv_kernel (with the group sum after them), which compute in the
// operand's dtype. Three kernels, each a launch of its own:
//   * attn_bwd_delta_f32_kernel: a warp per query row;
//   * attn_bwd_dq_f32_kernel: a block owns 64 query rows of one (head, batch
//     row), with their Q and dO in shared memory, and streams tiles of 32
//     keys of K and V; a thread owns 4 rows (ty + 16 i) and 2 keys of a tile
//     (tx + 16 j), recomputes s, p, dp and ds for them, writes ds to shared
//     memory and adds ds K into its rows' HD / 16 columns of dq (fp32
//     registers);
//   * attn_bwd_dkv_f32_kernel: a block owns 64 keys of one (kv head, batch
//     row), with their K and V in shared memory, and streams tiles of 16
//     query rows of Q and dO (with their lse and delta) over the G query
//     heads of its kv head in a fixed order; a thread owns 4 keys (ty + 16 i)
//     and one query row of a tile (tx), recomputes p^T and ds^T for them, and
//     adds p^T dO and ds^T Q into its keys' HD / 16 columns of dv and dk.
// The products are fp32 FMA, not TF32 mma. Bound on an H100: operations at
// the fp32 CUDA-core peak (67 TFLOP/s): dq takes 3 products over the visible
// pairs and dk/dv 4. The group sum runs in registers in a fixed order, with
// no atomics: a step repeats bit for bit. Causal key tiles past a block's
// last row (dq) and query tiles before a block's first key (dk/dv) are
// skipped; a row that sees no key (lse = -1e30) then differs from the plain
// version, which visits every key, unless its do is zero, as it is in
// training (padding carries no label): the same rule as the bf16 form.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;
constexpr int DQ_ROWS = 64, DQ_KEYS = 32;    // dq: query rows a block, keys a tile
constexpr int KV_KEYS = 64, KV_ROWS = 16;    // dk/dv: keys a block, query rows a tile

struct Params {
  const float *q, *k, *v, *bias, *d_o, *lse, *delta;
  float *dq, *dk, *dv;
  int H, group, tq, tk, causal;
  float scale;
};

__global__ void attn_bwd_delta_f32_kernel(const float* o, const float* d_o, float* delta,
                                          long long rows, int hd) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s = fmaf(o[row * hd + d], d_o[row * hd + d], s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) delta[row] = s;
}

// s = (q . k) * scale + bias, the causal mask replacing it with -1e30, as
// the plain version forms it
__device__ __forceinline__ float score(float dot, const Params& p, const float* bias, int row,
                                       int key) {
  float x = dot * p.scale;
  if (bias) x += bias[key];
  return p.causal && key > row ? NEG_INF : x;
}

template <int HD>
constexpr int dq_smem() {
  return 4 * (2 * DQ_ROWS * (HD + 1) + 2 * DQ_KEYS * (HD + 1) + DQ_ROWS * (DQ_KEYS + 1));
}

template <int HD>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq_f32_kernel(const Params p) {
  constexpr int RS = HD + 1, NC = HD / 16, PS = DQ_KEYS + 1;
  extern __shared__ float smem[];
  float* const Qs = smem;                   // [DQ_ROWS][RS]
  float* const Os = Qs + DQ_ROWS * RS;      // dO, [DQ_ROWS][RS]
  float* const Ks = Os + DQ_ROWS * RS;      // [DQ_KEYS][RS]
  float* const Vs = Ks + DQ_KEYS * RS;      // [DQ_KEYS][RS]
  float* const Ds = Vs + DQ_KEYS * RS;      // ds, [DQ_ROWS][PS]
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * DQ_ROWS;
  const int kvh = h / p.group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long qbase = (static_cast<long long>(b) * p.H + h) * p.tq;
  const long long kbase = (static_cast<long long>(b) * (p.H / p.group) + kvh) * p.tk;
  const float* bias = p.bias ? p.bias + static_cast<long long>(b) * p.tk : nullptr;

  for (int i = threadIdx.x; i < DQ_ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const bool in = q0 + r < p.tq;
    Qs[r * RS + d] = in ? p.q[(qbase + q0 + r) * HD + d] : 0.f;
    Os[r * RS + d] = in ? p.d_o[(qbase + q0 + r) * HD + d] : 0.f;
  }
  float lse[4], dlt[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse[i] = row < p.tq ? p.lse[qbase + row] : 0.f;
    dlt[i] = row < p.tq ? p.delta[qbase + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int k_end = p.causal ? min(p.tk, q0 + DQ_ROWS) : p.tk;

  for (int k0 = 0; k0 < k_end; k0 += DQ_KEYS) {
    __syncthreads();
    for (int i = threadIdx.x; i < DQ_KEYS * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < p.tk;
      Ks[r * RS + d] = in ? p.k[(kbase + k0 + r) * HD + d] : 0.f;
      Vs[r * RS + d] = in ? p.v[(kbase + k0 + r) * HD + d] : 0.f;
    }
    __syncthreads();
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float ka = Ks[tx * RS + d], kb = Ks[(tx + 16) * RS + d];
      const float va = Vs[tx * RS + d], vb = Vs[(tx + 16) * RS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = Qs[(ty + 16 * i) * RS + d], ov = Os[(ty + 16 * i) * RS + d];
        s[i][0] = fmaf(qv, ka, s[i][0]);
        s[i][1] = fmaf(qv, kb, s[i][1]);
        dp[i][0] = fmaf(ov, va, dp[i][0]);
        dp[i][1] = fmaf(ov, vb, dp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + tx + 16 * j;
        float ds = 0.f;  // no such key: nothing
        if (key < p.tk) {
          const float pe = expf(score(s[i][j], p, bias, q0 + ty + 16 * i, key) - lse[i]);
          ds = pe * (dp[i][j] - dlt[i]);
        }
        Ds[(ty + 16 * i) * PS + tx + 16 * j] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < DQ_KEYS; ++j) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[j * RS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dsv = Ds[(ty + 16 * i) * PS + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(dsv, kv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.tq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) p.dq[(qbase + row) * HD + tx + 16 * c] = acc[i][c] * p.scale;
  }
}

template <int HD>
constexpr int dkv_smem() {
  return 4 * (2 * KV_KEYS * (HD + 1) + 2 * KV_ROWS * (HD + 1) + 2 * KV_KEYS * (KV_ROWS + 1));
}

template <int HD>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkv_f32_kernel(const Params p) {
  constexpr int RS = HD + 1, NC = HD / 16, PS = KV_ROWS + 1;
  extern __shared__ float smem[];
  float* const Ks = smem;                   // [KV_KEYS][RS]
  float* const Vs = Ks + KV_KEYS * RS;
  float* const Qs = Vs + KV_KEYS * RS;      // [KV_ROWS][RS]
  float* const Os = Qs + KV_ROWS * RS;      // dO
  float* const Pt = Os + KV_ROWS * RS;      // p^T, [KV_KEYS][PS]
  float* const Dt = Pt + KV_KEYS * PS;      // ds^T
  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * KV_KEYS;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int hkv = p.H / p.group;
  const long long kbase = (static_cast<long long>(b) * hkv + kvh) * p.tk;
  const float* bias = p.bias ? p.bias + static_cast<long long>(b) * p.tk : nullptr;

  for (int i = threadIdx.x; i < KV_KEYS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const bool in = k0 + r < p.tk;
    Ks[r * RS + d] = in ? p.k[(kbase + k0 + r) * HD + d] : 0.f;
    Vs[r * RS + d] = in ? p.v[(kbase + k0 + r) * HD + d] : 0.f;
  }
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;
  // causal: rows before the block's first key see none of its keys
  const int r_begin = p.causal ? (k0 / KV_ROWS) * KV_ROWS : 0;

  for (int g = 0; g < p.group; ++g) {
    const int h = kvh * p.group + g;
    const long long qbase = (static_cast<long long>(b) * p.H + h) * p.tq;
    for (int r0 = r_begin; r0 < p.tq; r0 += KV_ROWS) {
      __syncthreads();
      for (int i = threadIdx.x; i < KV_ROWS * HD; i += THREADS) {
        const int r = i / HD, d = i % HD;
        const bool in = r0 + r < p.tq;
        Qs[r * RS + d] = in ? p.q[(qbase + r0 + r) * HD + d] : 0.f;
        Os[r * RS + d] = in ? p.d_o[(qbase + r0 + r) * HD + d] : 0.f;
      }
      __syncthreads();
      const int row = r0 + tx;
      float s[4], dp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float qv = Qs[tx * RS + d], ov = Os[tx * RS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i] = fmaf(Ks[(ty + 16 * i) * RS + d], qv, s[i]);
          dp[i] = fmaf(Vs[(ty + 16 * i) * RS + d], ov, dp[i]);
        }
      }
      const float lse = row < p.tq ? p.lse[qbase + row] : 0.f;
      const float dlt = row < p.tq ? p.delta[qbase + row] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
        float pe = 0.f, ds = 0.f;  // no such row or key: nothing
        if (row < p.tq && key < p.tk) {
          pe = expf(score(s[i], p, bias, row, key) - lse);
          ds = pe * (dp[i] - dlt);
        }
        Pt[(ty + 16 * i) * PS + tx] = pe;
        Dt[(ty + 16 * i) * PS + tx] = ds;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < KV_ROWS; ++r) {
        float ov[NC], qv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          ov[c] = Os[r * RS + tx + 16 * c];
          qv[c] = Qs[r * RS + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = Pt[(ty + 16 * i) * PS + r], dv_ = Dt[(ty + 16 * i) * PS + r];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[i][c] = fmaf(pv, ov[c], dv[i][c]);
            dk[i][c] = fmaf(dv_, qv[c], dk[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.tk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      p.dk[(kbase + key) * HD + tx + 16 * c] = dk[i][c] * p.scale;
      p.dv[(kbase + key) * HD + tx + 16 * c] = dv[i][c];
    }
  }
}

Params make_params(const float* q, const float* k, const float* v, const float* bias,
                   const float* d_o, const float* lse, const float* delta, int H, int group,
                   int tq, int tk, int causal, float scale) {
  Params p = {q, k, v, bias, d_o, lse, delta, nullptr, nullptr, nullptr,
              H, group, tq, tk, causal, scale};
  return p;
}

bool bad_shape(int B, int H, int group, int tq, int tk) {
  return B < 1 || H < 1 || group < 1 || H % group || tq < 1 || tk < 1;
}

template <int HD>
int launch_dq(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = dq_smem<HD>();
  const cudaError_t attr = cudaFuncSetAttribute(
      attn_bwd_dq_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attn_bwd_dq_f32_kernel<HD>
      <<<dim3(p.H, B, (p.tq + DQ_ROWS - 1) / DQ_ROWS), THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = dkv_smem<HD>();
  const cudaError_t attr = cudaFuncSetAttribute(
      attn_bwd_dkv_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attn_bwd_dkv_f32_kernel<HD>
      <<<dim3(p.H / p.group, B, (p.tk + KV_KEYS - 1) / KV_KEYS), THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// delta [rows] = rowsum(do * o) over rows of hd contiguous fp32 values
extern "C" int attn_bwd_delta_f32(const float* o, const float* d_o, float* delta,
                                  long long rows, int hd, void* stream) {
  if (rows < 1 || hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((rows + 7) / 8);
  attn_bwd_delta_f32_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d_o, delta, rows, hd);
  return static_cast<int>(cudaGetLastError());
}

// q, do [B, H, Tq, hd], k, v [B, H / group, Tk, hd], lse, delta [B, H, Tq],
// bias [B, Tk] or null: contiguous fp32; dq [B, H, Tq, hd]
extern "C" int attn_bwd_dq_f32(const float* q, const float* k, const float* v,
                               const float* bias, const float* d_o, const float* lse,
                               const float* delta, float* dq, int B, int H, int group, int tq,
                               int tk, int hd, int causal, float scale, void* stream) {
  if (bad_shape(B, H, group, tq, tk)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, bias, d_o, lse, delta, H, group, tq, tk, causal, scale);
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_dq<128>(p, B, s);
  if (hd == 64) return launch_dq<64>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the same operands; dk, dv [B, H / group, Tk, hd], summed over the group
extern "C" int attn_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                const float* bias, const float* d_o, const float* lse,
                                const float* delta, float* dk, float* dv, int B, int H,
                                int group, int tq, int tk, int hd, int causal, float scale,
                                void* stream) {
  if (bad_shape(B, H, group, tq, tk)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, bias, d_o, lse, delta, H, group, tq, tk, causal, scale);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_dkv<128>(p, B, s);
  if (hd == 64) return launch_dkv<64>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
