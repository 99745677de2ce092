// Attention backward for Hopper (sm_90a): bf16 q/k/v/do in, bf16 dq/dk/dv
// out, fp32 row statistics and accumulators.
//
// Replaces the two backward TPU kernels of trace_tpu/kernels/flash_backward.py
// (_dq_kernel and _dkv_kernel, FlashAttention-2 order) and the XLA code
// around them (delta = rowsum(do * o); the sum of dk/dv over the query heads
// of a kv head):
//   p  = exp(s - lse)           s = q k^T * scale + bias (+ causal mask)
//   dv = p^T do
//   ds = p * (do v^T - delta)
//   dq = ds k * scale           dk = ds^T q * scale
//
// The TPU bodies hold a head's whole K/V (dq) or whole Q/dO (dk/dv) and a
// full [block, Tk] fp32 score block in VMEM; at Tk = 2048, hd = 128 that is
// past the 227 KB of shared memory a block has here. So:
//   * attn_bwd_dq_kernel: one block per (64 query rows, head, batch row),
//     Q and dO tiles resident in shared memory, K and V streamed in 64-key
//     tiles (double buffered, cp.async); each of four warps recomputes its
//     16 x 64 block of p from lse, forms ds and adds ds k into a 16 x hd
//     fp32 accumulator in registers. Causal key tiles past the block's last
//     row are skipped.
//   * attn_bwd_dkv_kernel: one block per (64 keys, kv head, batch row), K
//     and V tiles resident, Q, dO, lse and delta streamed in 64-query tiles
//     over the G query heads of the kv head, one after the other in a fixed
//     order, into 16 x hd fp32 dk and dv accumulators per warp. The group
//     sum thus happens in registers: no per-query-head copy of dk/dv in
//     device memory and no float atomics, so a step repeats bit for bit.
//     Causal query tiles before the block's first key are skipped.
//   * attn_bwd_delta_kernel: delta = rowsum(do * o), one warp per row.
// All five products run on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate). p and ds are rounded to bf16 before their second product
// (p^T do, ds k, ds^T q), as the forward rounds p before p v; the plain
// version keeps them in fp32, and the comparison's tolerance says so.
//
// Bound on an H100: operations (five products of 2 B H pairs hd each over
// ~100 MB of operands at the training shape). This first version reads its
// B operands from shared memory with 2- and 4-byte loads and recomputes s
// in both kernels (7 products for the function's 5).
//
// A query row that sees no key has lse = -1e30 and p = exp(0) = 1 on every
// key tile this kernel visits; the TPU kernel visits the causally masked
// tiles too. Such rows are padding and carry do = 0 in training, where both
// give zero.

#include "attention_common.cuh"

namespace {

struct BwdParams {
  const bf16* q;      // [B, H, Tq, hd]
  const bf16* k;      // [B, Hkv, Tk, hd]
  const bf16* v;
  const float* bias;  // [B, Tk] additive, or null
  const bf16* d_o;    // [B, H, Tq, hd]
  const float* lse;   // [B, H, Tq]
  const float* delta; // [B, H, Tq]
  bf16* dq;           // [B, H, Tq, hd]
  bf16* dk;           // [B, Hkv, Tk, hd]
  bf16* dv;
  int H, group, tq, tk, causal;
  float scale;
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dq_kernel(BwdParams p) {
  constexpr int LD = pitch<HD>();
  constexpr int TILE = BQ * LD;
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const Qs = reinterpret_cast<bf16*>(smem);
  bf16* const dOs = Qs + TILE;
  bf16* const Kbuf = dOs + TILE;      // [2][TILE]
  bf16* const Vbuf = Kbuf + 2 * TILE; // [2][TILE]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16;

  const long long qrow = (static_cast<long long>(b) * p.H + h) * p.tq;
  const long long kvoff =
      (static_cast<long long>(b) * (p.H / p.group) + kvh) * p.tk * HD;
  const bf16* kg = p.k + kvoff;
  const bf16* vg = p.v + kvoff;
  const float* bias = p.bias ? p.bias + static_cast<long long>(b) * p.tk : nullptr;

  const int qvalid = min(BQ, p.tq - q0);
  copy_tile_async<HD>(Qs, p.q + (qrow + q0) * HD, HD, qvalid);
  copy_tile_async<HD>(dOs, p.d_o + (qrow + q0) * HD, HD, qvalid);
  cp_async_commit();

  const int row[2] = {q0 + row0 + g, q0 + row0 + g + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = row[r] < p.tq ? p.lse[qrow + row[r]] : 0.f;
    delta[r] = row[r] < p.tq ? p.delta[qrow + row[r]] : 0.f;
  }

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  // keys past the tile's last query row are causally masked for every row
  const int k_end = p.causal ? min(p.tk, q0 + BQ) : p.tk;

  copy_tile_async<HD>(Kbuf, kg, HD, min(BK, p.tk));
  copy_tile_async<HD>(Vbuf, vg, HD, min(BK, p.tk));
  cp_async_commit();
  for (int k0 = 0, stage = 0; k0 < k_end; k0 += BK, stage ^= 1) {
    if (k0 + BK < k_end) {
      const int nvalid = min(BK, p.tk - k0 - BK);
      copy_tile_async<HD>(Kbuf + (stage ^ 1) * TILE,
                          kg + static_cast<long long>(k0 + BK) * HD, HD, nvalid);
      copy_tile_async<HD>(Vbuf + (stage ^ 1) * TILE,
                          vg + static_cast<long long>(k0 + BK) * HD, HD, nvalid);
      cp_async_commit();
      cp_async_wait<1>();  // all but the next tile's group have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = Kbuf + stage * TILE;
    const bf16* Vs = Vbuf + stage * TILE;

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    mma_nt<HD>(s, Qs + row0 * LD, Ks, g, t);     // q k^T
    mma_nt<HD>(dp, dOs + row0 * LD, Vs, g, t);   // do v^T

    // ds = p * (dp - delta), p = exp(s - lse), left in s
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = k0 + n * 8 + 2 * t + c;
        const float bj = (bias && j < p.tk) ? bias[j] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = s[n][2 * r + c] * p.scale + bj;
          if (p.causal && j > row[r]) x = NEG_INF;
          const float pr = (j < p.tk && row[r] < p.tq) ? expf(x - lse[r]) : 0.f;
          s[n][2 * r + c] = pr * (dp[n][2 * r + c] - delta[r]);
        }
      }
    }
    mma_pn<HD>(dq, s, Ks, g, t);                 // ds k
    __syncthreads();  // every warp is done with this stage's buffers
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.tq) continue;
    bf16* out = p.dq + (qrow + row[r]) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          pack(dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dkv_kernel(BwdParams p) {
  constexpr int LD = pitch<HD>();
  constexpr int TILE = BQ * LD;
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const Ks = reinterpret_cast<bf16*>(smem);
  bf16* const Vs = Ks + TILE;
  bf16* const Qbuf = Vs + TILE;         // [2][TILE]
  bf16* const dObuf = Qbuf + 2 * TILE;  // [2][TILE]
  float* const stat = reinterpret_cast<float*>(dObuf + 2 * TILE);  // [2][2][BQ]: lse, delta

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16;

  const long long kvoff =
      ((static_cast<long long>(b) * (p.H / p.group) + kvh) * p.tk + k0) * HD;
  const int kvalid = min(BK, p.tk - k0);
  copy_tile_async<HD>(Ks, p.k + kvoff, HD, kvalid);
  copy_tile_async<HD>(Vs, p.v + kvoff, HD, kvalid);
  cp_async_commit();

  const int key[2] = {k0 + row0 + g, k0 + row0 + g + 8};
  float bj[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    bj[r] = (p.bias && key[r] < p.tk)
                ? p.bias[static_cast<long long>(b) * p.tk + key[r]] : 0.f;

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  // query tiles whose last row lies before the block's first key are
  // causally masked for every key of the block
  const int qt_start = p.causal ? k0 / BQ : 0;
  const int nqt = (p.tq + BQ - 1) / BQ - qt_start;
  const int total = nqt > 0 ? p.group * nqt : 0;

  // step ``it`` = query head kvh * G + it / nqt, query tile qt_start + it % nqt:
  // its Q and dO tiles and its rows' lse and delta into ``stage``, one group
  auto prefetch = [&](int it, int stage) {
    const int hq = kvh * p.group + it / nqt;
    const int q0 = (qt_start + it % nqt) * BQ;
    const long long qrow = (static_cast<long long>(b) * p.H + hq) * p.tq + q0;
    const int valid = min(BQ, p.tq - q0);
    copy_tile_async<HD>(Qbuf + stage * TILE, p.q + qrow * HD, HD, valid);
    copy_tile_async<HD>(dObuf + stage * TILE, p.d_o + qrow * HD, HD, valid);
    {
      const int which = threadIdx.x / BQ, i = threadIdx.x % BQ;  // 128 threads: lse | delta
      const float* src = (which ? p.delta : p.lse) + qrow;
      const unsigned saddr = static_cast<unsigned>(
          __cvta_generic_to_shared(stat + (stage * 2 + which) * BQ + i));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(saddr), "l"(src + (i < valid ? i : 0)), "r"(i < valid ? 4 : 0));
    }
    cp_async_commit();
  };

  if (total > 0) prefetch(0, 0);
  for (int it = 0, stage = 0; it < total; ++it, stage ^= 1) {
    if (it + 1 < total) {
      prefetch(it + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qs = Qbuf + stage * TILE;
    const bf16* dOs = dObuf + stage * TILE;
    const float* lse = stat + stage * 2 * BQ;
    const float* delta = lse + BQ;
    const int q0 = (qt_start + it % nqt) * BQ;

    // s^T = k q^T: 16 keys x 64 queries per warp, then p^T in place
    float s[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_nt<HD>(s, Ks + row0 * LD, Qs, g, t);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int iq = n * 8 + 2 * t + c;
        const int i = q0 + iq;
        const float l = lse[iq];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = s[n][2 * r + c] * p.scale + bj[r];
          if (p.causal && key[r] > i) x = NEG_INF;
          s[n][2 * r + c] = (key[r] < p.tk && i < p.tq) ? expf(x - l) : 0.f;
        }
      }
    }
    mma_pn<HD>(dv, s, dOs, g, t);                // dv += p^T do

    float dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    mma_nt<HD>(dp, Vs + row0 * LD, dOs, g, t);   // dp^T = v do^T
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float d = delta[n * 8 + 2 * t + c];
        s[n][c] *= dp[n][c] - d;
        s[n][2 + c] *= dp[n][2 + c] - d;
      }
    }
    mma_pn<HD>(dk, s, Qs, g, t);                 // dk += ds^T q
    __syncthreads();  // every warp is done with this stage's buffers
  }
  cp_async_wait<0>();  // K and V, if the loop never ran

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.tk) continue;
    const long long off = kvoff + static_cast<long long>(row0 + g + 8 * r) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(p.dk + off + n * 8) =
          pack(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + off + n * 8) =
          pack(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// delta[row] = sum_c do[row, c] * o[row, c] in fp32, one warp per row, the
// lanes' partial sums added in a fixed order
__global__ void attn_bwd_delta_kernel(const bf16* o, const bf16* d_o, float* delta,
                                      long long rows, int hd) {
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32)
                        + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const bf16* a = o + row * hd;
  const bf16* d = d_o + row * hd;
  float sum = 0.f;
  for (int c = 2 * lane; c < hd; c += 64) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + c));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + c));
    sum += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

template <int HD>
int launch_dq(const BwdParams& p, int B, cudaStream_t stream) {
  const int bytes = 6 * BQ * pitch<HD>() * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.tq + BQ - 1) / BQ, p.H, B);
  attn_bwd_dq_kernel<HD><<<grid, NTHREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv(const BwdParams& p, int B, cudaStream_t stream) {
  const int bytes = 6 * BQ * pitch<HD>() * static_cast<int>(sizeof(bf16))
                    + 4 * BQ * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.tk + BK - 1) / BK, p.H / p.group, B);
  attn_bwd_dkv_kernel<HD><<<grid, NTHREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

BwdParams make_params(const void* q, const void* k, const void* v, const float* bias,
                      const void* d_o, const float* lse, const float* delta,
                      int H, int group, int tq, int tk, int causal, float scale) {
  BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias = bias;
  p.d_o = static_cast<const bf16*>(d_o);
  p.lse = lse;
  p.delta = delta;
  p.dq = nullptr;
  p.dk = nullptr;
  p.dv = nullptr;
  p.H = H;
  p.group = group;
  p.tq = tq;
  p.tk = tk;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" int attn_bwd_delta_bf16(const void* o, const void* d_o, float* delta,
                                   long long rows, int hd, void* stream) {
  if (hd % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = 8;
  const unsigned blocks = static_cast<unsigned>((rows + warps - 1) / warps);
  attn_bwd_delta_kernel<<<blocks, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(d_o), delta, rows, hd);
  return static_cast<int>(cudaGetLastError());
}

// All tensors contiguous: q, d_o, dq [B, H, Tq, hd]; k, v [B, H / group, Tk, hd];
// bias [B, Tk] or null; lse, delta [B, H, Tq].
extern "C" int attn_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const float* bias, const void* d_o,
    const float* lse, const float* delta, void* dq, int B, int H, int group, int tq,
    int tk, int hd, int causal, float scale, void* stream) {
  BwdParams p = make_params(q, k, v, bias, d_o, lse, delta, H, group, tq, tk, causal, scale);
  p.dq = static_cast<bf16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_dq<128>(p, B, s);
  if (hd == 64) return launch_dq<64>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As attn_bwd_dq_bf16; dk, dv [B, H / group, Tk, hd], summed over each kv
// head's ``group`` query heads.
extern "C" int attn_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const float* bias, const void* d_o,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H, int group,
    int tq, int tk, int hd, int causal, float scale, void* stream) {
  BwdParams p = make_params(q, k, v, bias, d_o, lse, delta, H, group, tq, tk, causal, scale);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_dkv<128>(p, B, s);
  if (hd == 64) return launch_dkv<64>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
