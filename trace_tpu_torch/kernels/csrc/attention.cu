// Tiled attention forward for Hopper (sm_90a): bf16 in, bf16 out, fp32
// softmax statistics and accumulators.
//
// One kernel serves two TPU kernels of trace_tpu/kernels/flash_attention.py:
//   * flash_attention (_attn_kernel): causal GQA prefill attention over
//     [B, H, T, hd] with an additive fp32 [B, Tk] padding bias;
//   * vit_attention_btd (_btd_kernel): bidirectional ViT attention read and
//     written in place in the [B, P, D] layout (head h = columns h*hd..),
//     keys >= kv_len masked.
// The caller passes element strides for (batch, head, token) of q, k, v and
// o, so both layouts are plain strided reads. With an ``lse`` pointer it is
// also flash_attention_fwd_res of trace_tpu/kernels/flash_backward.py
// (_fwd_res_kernel): the same forward, which also writes each query row's
// fp32 logsumexp m + log(sum exp(s - m)), the residual of the backward
// kernels in attention_bwd.cu.
//
// The TPU kernel keeps a whole [block_q, Tk] fp32 score row block in VMEM.
// At Tk = 2048 that is 512 KB for 64 rows, beyond the 227 KB of shared
// memory a block may use here, so this kernel runs an online softmax over
// 64-key tiles instead (FlashAttention-2 order): one block per (q-tile of
// 64 rows, head, batch row), four warps, each warp owning 16 query rows.
// Both products run on the tensor cores as mma.sync m16n8k16 (bf16 in,
// fp32 accumulate); a warp keeps its Q fragments, its 16x64 score tile and
// its 16xhd output accumulator in registers, so only the K and V tiles pass
// through shared memory, double buffered with cp.async so the next tile's
// copy overlaps this tile's math, and the scores never leave the SM. With
// causal masking, key tiles past the tile's last query row are skipped.
//
// Masks use the finite -1e30 of the JAX package, never -inf: a row whose
// keys are all masked averages its visible values and stays finite.

#include "attention_common.cuh"

namespace {

constexpr float M_INIT = -1e38f;  // running-max start, below any masked score

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;  // [B, Tk] additive, or null
  bf16* o;
  float* lse;         // [B, H, Tq] m + log(sum exp(s - m)) per query row, or null
  int group;          // query heads per kv head
  int tq, tk, kv_len, causal;
  float scale;
  long long sqb, sqh, sqt;
  long long skb, skh, skt;
  long long svb, svh, svt;
  long long sob, soh, sot;
  long long sbias;
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS) attn_fwd_kernel(Params p) {
  constexpr int LD = pitch<HD>();
  constexpr int NT = BK / 8;   // 8-key column tiles of S
  constexpr int NO = HD / 8;   // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const Kbuf = reinterpret_cast<bf16*>(smem);  // [2][BK * LD], double buffered
  bf16* const Vbuf = Kbuf + 2 * BK * LD;             // [2][BK * LD]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16;

  const bf16* qg = p.q + b * p.sqb + h * p.sqh + q0 * p.sqt;
  const bf16* kg = p.k + b * p.skb + kvh * p.skh;
  const bf16* vg = p.v + b * p.svb + kvh * p.svh;
  const float* bias = p.bias ? p.bias + b * p.sbias : nullptr;

  // Q tile through the K buffer into this warp's A fragments
  load_tile<HD>(Kbuf, qg, p.sqt, min(BQ, p.tq - q0));
  __syncthreads();
  uint32_t qf[HD / 16][4];
  {
    const bf16* r0 = Kbuf + (row0 + g) * LD + 2 * t;
    const bf16* r1 = r0 + 8 * LD;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      qf[kc][0] = ld32(r0 + kc * 16);
      qf[kc][1] = ld32(r1 + kc * 16);
      qf[kc][2] = ld32(r0 + kc * 16 + 8);
      qf[kc][3] = ld32(r1 + kc * 16 + 8);
    }
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {M_INIT, M_INIT};  // rows g and g + 8 of the warp
  float l[2] = {0.f, 0.f};
  const int tq_row[2] = {q0 + row0 + g, q0 + row0 + g + 8};

  // keys past the tile's last query row are causally masked for every row
  const int k_end = p.causal ? min(p.tk, q0 + BQ) : p.tk;

  // K/V tiles stream through two buffers: tile i+1's copy is in flight
  // while tile i is computed
  __syncthreads();  // Q's reads of buffer 0 are finished
  load_tile_async<HD>(Kbuf, kg, p.skt, min(BK, p.tk));
  load_tile_async<HD>(Vbuf, vg, p.svt, min(BK, p.tk));
  for (int k0 = 0, stage = 0; k0 < k_end; k0 += BK, stage ^= 1) {
    if (k0 + BK < k_end) {
      const int nvalid = min(BK, p.tk - k0 - BK);
      load_tile_async<HD>(Kbuf + (stage ^ 1) * BK * LD, kg + (k0 + BK) * p.skt,
                          p.skt, nvalid);
      load_tile_async<HD>(Vbuf + (stage ^ 1) * BK * LD, vg + (k0 + BK) * p.svt,
                          p.svt, nvalid);
      cp_async_wait<2>();  // this tile's two groups are done, the next two fly
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = Kbuf + stage * BK * LD;
    const bf16* Vs = Vbuf + stage * BK * LD;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* kr = Ks + (n * 8 + g) * LD + kc * 16 + 2 * t;
        mma(s[n], qf[kc], ld32(kr), ld32(kr + 8));
      }
    }

    // scale, bias, masks, online softmax; a row's 64 scores sit in the 4
    // lanes of one quad (16 each)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = M_INIT;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = k0 + n * 8 + 2 * t + c;
          float x = s[n][2 * r + c] * p.scale;
          if (j < p.tk) {
            if (bias) x += bias[j];
            if (j >= p.kv_len || (p.causal && j > tq_row[r])) x = NEG_INF;
            mx = fmaxf(mx, x);
          }
          s[n][2 * r + c] = x;
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = k0 + n * 8 + 2 * t + c;
          const float e = j < p.tk ? expf(s[n][2 * r + c] - m_new) : 0.f;
          s[n][2 * r + c] = e;
          sum += e;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P taken from the score registers as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vr = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* vc = vr + n * 8;
        mma(o[n], a, pack(vc[0], vc[LD]), pack(vc[8 * LD], vc[9 * LD]));
      }
    }
    __syncthreads();  // every warp is done with this stage's buffers
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (tq_row[r] >= p.tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    if (p.lse && t == 0)
      p.lse[(static_cast<long long>(b) * gridDim.y + h) * p.tq + tq_row[r]] =
          m[r] + logf(fmaxf(l[r], 1e-30f));
    bf16* og = p.o + b * p.sob + h * p.soh + tq_row[r] * p.sot + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(og + n * 8) =
          pack(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int HD>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  const int bytes = 4 * BK * pitch<HD>() * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.tq + BQ - 1) / BQ, H, B);
  attn_fwd_kernel<HD><<<grid, NTHREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int attn_fwd_bf16(
    const void* q, const void* k, const void* v, const float* bias, void* o,
    float* lse, int B, int H, int group, int tq, int tk, int hd, int kv_len, int causal,
    float scale, long long sqb, long long sqh, long long sqt, long long skb,
    long long skh, long long skt, long long svb, long long svh, long long svt,
    long long sob, long long soh, long long sot, long long sbias,
    void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias = bias;
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.group = group;
  p.tq = tq;
  p.tk = tk;
  p.kv_len = kv_len;
  p.causal = causal;
  p.scale = scale;
  p.sqb = sqb; p.sqh = sqh; p.sqt = sqt;
  p.skb = skb; p.skh = skh; p.skt = skt;
  p.svb = svb; p.svh = svh; p.svt = svt;
  p.sob = sob; p.soh = soh; p.sot = sot;
  p.sbias = sbias;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch<128>(p, B, H, s);
  if (hd == 64) return launch<64>(p, B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
