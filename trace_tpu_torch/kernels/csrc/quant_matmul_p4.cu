// Nibble-packed int4 weight products for Hopper (sm_90a): bf16 x, packed
// int8 bytes qp [K/2, N], bf16 scales, bf16 or fp32 y, fp32 sums.
//
// Byte qp[k, n] holds weight rows k (low nibble) and k + K/2 (high nibble),
// each a 4-bit two's complement value. Two functions:
//   * per channel (s [N]):   y = (x[:, :K/2] @ lo + x[:, K/2:] @ hi) * s,
//     the nibbles exact, the scale applied once on the fp32 sum;
//   * grouped (s [G, N], K = 128 G, G even):  y = x @ W with
//     W[k, n] = bf16(nibble[k, n] * s[k / 128, n]); the rounding of the
//     scaled weight to bf16 is part of the function. bf16 x bf16 products are
//     exact in fp32, so only the order of the fp32 sum differs from the
//     plain version.
//
// Replaces quant_matmul_p4 (_qmm_p4_kernel) and quant_matmul_p4_grouped
// (_qmm_p4g_kernel) of trace_tpu/kernels/quant_matmul.py. The TPU kernels
// unpack with float arithmetic, get x pre-split into its two halves and
// everything padded to block multiples; here the nibbles come out of the
// 32-bit word with integer masks, the kernels index x at k and k + K/2
// themselves, and ragged M, N (and K, per channel) are predicated. The
// stacked entry points add the layer's offset to the weight and scale
// pointers, so layer li of a whole [L, K/2, N] leaf is read in place.
//
// Two forms, chosen on M by the entry point:
//   * M <= SMALL_M_MAX (a decode step): bound by bytes, K N / 2 of them
//     streamed once. As in quant_matmul.cu: a block owns a strip of 512
//     columns and a chunk of packed rows, its x rows (both halves) sit in
//     shared memory as fp32, 8 warps take the chunk's rows in turn and
//     multiply-add on the CUDA cores into 16 x rows registers; a second
//     launch sums the chunks in a fixed order (no atomics: the same bits
//     from run to run).
//   * larger M (prefill): bound by operations. A block computes a 128 x 128
//     tile of y with mma.sync m16n8k16 (bf16 in, fp32 accumulate), 8 warps of
//     64 x 32 each. The x tile (both halves) and the packed weight tile
//     stream through a 3-stage cp.async ring in shared memory; each warp
//     dequantizes its B fragments in registers, two weights at a time in
//     bf16x2 arithmetic (nibble | 0x4300 is the bf16 128 + nibble, minus 136
//     after the sign bit is flipped, times the scale pair: each step exact
//     or rounded once, as the plain version's fp32 product rounded to bf16).
//     The mma's K index is permuted so that one byte feeds one thread: k
//     indices 0-7 of a step are the low nibbles of 8 packed rows, 8-15 their
//     high nibbles, and the A fragment takes its halves from the two x
//     tiles accordingly; a thread's four 8-column tiles are interleaved
//     (column 4 g + j) so that its four bytes are one 32-bit word.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int SMALL_M_MAX = 8;   // rows up to which the split-K form runs

// ---- split-K form -------------------------------------------------------

constexpr int NW = 8;            // warps per block
constexpr int CPT = 16;          // columns per thread: one 16-byte load
constexpr int STRIP = 32 * CPT;  // columns per block
constexpr int KCH_MAX = 512;     // most packed rows of a chunk (x tile in shared memory)
constexpr int KU = 4;            // packed rows a warp loads before it multiplies

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

// 16 bf16 scales of one group row as 8 packed pairs
__device__ __forceinline__ void load_scales(const bf16* row, int col0, int N,
                                            int vec, unsigned (&p)[8]) {
  if (vec) {
    const uint4 a = *reinterpret_cast<const uint4*>(row + col0);
    const uint4 b = *reinterpret_cast<const uint4*>(row + col0 + 8);
    p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
    p[4] = b.x; p[5] = b.y; p[6] = b.z; p[7] = b.w;
  } else {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = col0 + 2 * i;
      const unsigned lo = c < N ? r[c] : 0u;
      const unsigned hi = c + 1 < N ? r[c + 1] : 0u;
      p[i] = lo | (hi << 16);
    }
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// s [G, N] for GROUPED (G = K / 128), unused otherwise (the finish launch
// applies the per-column scale)
template <int MT, bool GROUPED>
__global__ void __launch_bounds__(NW * 32, 2)
    p4_partial(const bf16* __restrict__ x, const int8_t* __restrict__ qp,
               const bf16* __restrict__ s, float* __restrict__ ws, int M, int K,
               int N, int kchunk, int vec) {
  __shared__ float xs[2][MT][KCH_MAX];
  __shared__ float red[MT][CPT][33];

  const int Kh = K / 2;
  const int strip = blockIdx.x, ks = blockIdx.y, m0 = blockIdx.z * MT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kbeg = ks * kchunk;
  const int klen = min(kchunk, Kh - kbeg);

  for (int i = threadIdx.x; i < 2 * MT * klen; i += NW * 32) {
    const int half = i / (MT * klen), rem = i % (MT * klen);
    const int m = rem / klen, k = rem % klen;
    xs[half][m][k] = (m0 + m < M)
        ? __bfloat162float(x[static_cast<long long>(m0 + m) * K + half * Kh + kbeg + k])
        : 0.f;
  }
  __syncthreads();

  const int col0 = strip * STRIP + lane * CPT;
  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;

  if (col0 < N) {
    int cur_group = -1;
    unsigned slo[8], shi[8];  // the current groups' scales, bf16 pairs
#pragma unroll
    for (int i = 0; i < 8; ++i) slo[i] = shi[i] = 0u;
    for (int k0 = warp; k0 < klen; k0 += NW * KU) {
      unsigned w[KU][4];
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int k = k0 + u * NW;
        if (k < klen) {
          load16(qp + static_cast<long long>(kbeg + k) * N, col0, N, vec, w[u]);
        } else {
          w[u][0] = w[u][1] = w[u][2] = w[u][3] = 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int k = k0 + u * NW;
        if (k >= klen) break;  // the same for every lane of the warp
        if (GROUPED) {
          const int group = (kbeg + k) >> 7;  // of the low half; the high half's is G / 2 further
          if (group != cur_group) {
            cur_group = group;
            load_scales(s + static_cast<long long>(group) * N, col0, N, vec, slo);
            load_scales(s + static_cast<long long>(group + (K >> 8)) * N, col0, N, vec, shi);
          }
        }
        float xl[MT], xh[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          xl[m] = xs[0][m][k];
          xh[m] = xs[1][m][k];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // flip each nibble's sign bit: nibble + 8 in [0, 16), put into the
          // mantissa of 2^23, minus (2^23 + 8): exact
          const unsigned biased = w[u][i] ^ 0x88888888u;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int c = 4 * i + b;
            float lo = __uint_as_float(((biased >> (8 * b)) & 0xFu) | 0x4B000000u) - 8388616.f;
            float hi = __uint_as_float(((biased >> (8 * b + 4)) & 0xFu) | 0x4B000000u) - 8388616.f;
            if (GROUPED) {
              const float sl = __uint_as_float((c & 1) ? (slo[c >> 1] & 0xFFFF0000u)
                                                       : (slo[c >> 1] << 16));
              const float sh = __uint_as_float((c & 1) ? (shi[c >> 1] & 0xFFFF0000u)
                                                       : (shi[c >> 1] << 16));
              lo = round_bf16(lo * sl);
              hi = round_bf16(hi * sh);
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              acc[m][c] = fmaf(xl[m], lo, acc[m][c]);
              acc[m][c] = fmaf(xh[m], hi, acc[m][c]);
            }
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

// sums the chunks in order; s is the per-column scale, or null (grouped)
template <typename OUT>
__global__ void p4_finish(const float* __restrict__ ws, const bf16* __restrict__ s,
                          OUT* __restrict__ y, int ksplit, long long MN, int N) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= MN) return;
  float acc = 0.f;
  for (int ks = 0; ks < ksplit; ++ks) acc += ws[ks * MN + idx];
  if (s != nullptr) acc *= __bfloat162float(s[idx % N]);
  y[idx] = cast_out<OUT>(acc);
}

template <int MT, bool GROUPED>
int launch_partial(const bf16* x, const int8_t* qp, const bf16* s, float* ws, int M,
                   int K, int N, int kchunk, int ksplit, int vec, cudaStream_t stream) {
  const dim3 grid((N + STRIP - 1) / STRIP, ksplit, (M + MT - 1) / MT);
  p4_partial<MT, GROUPED><<<grid, NW * 32, 0, stream>>>(x, qp, s, ws, M, K, N, kchunk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool GROUPED>
int run_splitk(const bf16* x, const int8_t* qp, const bf16* s, void* y, float* ws,
               int M, int K, int N, int kchunk, int out_f32, cudaStream_t stream) {
  if (ws == nullptr || kchunk < 1 || kchunk > KCH_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ksplit = (K / 2 + kchunk - 1) / kchunk;
  const int vec = (N % 16 == 0 && reinterpret_cast<uintptr_t>(qp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(s) % 16 == 0) ? 1 : 0;
  int err;
  if (M == 1) err = launch_partial<1, GROUPED>(x, qp, s, ws, M, K, N, kchunk, ksplit, vec, stream);
  else if (M == 2) err = launch_partial<2, GROUPED>(x, qp, s, ws, M, K, N, kchunk, ksplit, vec, stream);
  else err = launch_partial<4, GROUPED>(x, qp, s, ws, M, K, N, kchunk, ksplit, vec, stream);
  if (err != 0) return err;
  const long long MN = static_cast<long long>(M) * N;
  const unsigned blocks = static_cast<unsigned>((MN + 255) / 256);
  const bf16* col_scale = GROUPED ? nullptr : s;
  if (out_f32)
    p4_finish<float><<<blocks, 256, 0, stream>>>(ws, col_scale, static_cast<float*>(y), ksplit, MN, N);
  else
    p4_finish<bf16><<<blocks, 256, 0, stream>>>(ws, col_scale, static_cast<bf16*>(y), ksplit, MN, N);
  return static_cast<int>(cudaGetLastError());
}

// ---- tensor-core form ---------------------------------------------------

constexpr int BM = 128;          // rows of y per block
constexpr int BN = 128;          // columns of y per block
constexpr int BKP = 32;          // packed rows per stage (64 rows of K)
constexpr int NSTAGE = 3;
constexpr int TC_THREADS = 256;  // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int XLD = BKP + 8;     // bf16 per x row in shared memory (80 bytes: the 8 rows
                                 // a fragment load touches fall on distinct banks)
constexpr int WLD = BN + 16;     // bytes per packed row in shared memory
constexpr int X_SLAB = BM * XLD;                        // bf16 elements of one x half
constexpr int STAGE_BYTES = 2 * X_SLAB * 2 + BKP * WLD;  // both x halves + packed tile
constexpr int TC_SMEM = NSTAGE * STAGE_BYTES;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(saddr), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8 x 8 bf16 blocks from shared memory into mma fragment order: lane l
// passes the address of row l % 8 of block l / 8 (16 bytes, 16-byte aligned);
// a[i] then holds, for lane (g, t), elements 2t and 2t + 1 of row g of block i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* row) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(saddr));
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one 16x8x16 tile. Fragment layout (PTX ISA, mma.m16n8k16):
// with g = lane / 4 and t = lane % 4, a holds A[g][2t..], A[g+8][2t..],
// A[g][2t+8..], A[g+8][2t+8..]; b holds B[2t..][g], B[2t+8..][g]; d holds
// D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct TcParams {
  const bf16* x;
  const int8_t* qp;
  const bf16* s;
  void* y;
  int M, K, N;
  int xvec;  // x rows and both halves start 16-byte aligned: cp.async
  int wvec;  // packed rows start 16-byte aligned: cp.async
  int yvec;  // a thread's 8 columns of y are 16-byte aligned: vector stores
};

// tile kt (packed rows kt * BKP ..) of x's two halves and of qp into a stage
__device__ __forceinline__ void load_stage(const TcParams& p, unsigned char* stage,
                                           int kt, int m_blk, int n_blk) {
  const int Kh = p.K / 2;
  const int kk0 = kt * BKP;
  bf16* const xt = reinterpret_cast<bf16*>(stage);  // [2][BM][XLD]
  unsigned char* const wt = stage + 2 * X_SLAB * 2;  // [BKP][WLD]
  constexpr int XCH = BKP / 8;                       // 16-byte chunks per x row
  for (int id = threadIdx.x; id < 2 * BM * XCH; id += TC_THREADS) {
    const int half = id / (BM * XCH), rem = id % (BM * XCH);
    const int r = rem / XCH, c = (rem % XCH) * 8;
    const int row = m_blk + r, col = kk0 + c;
    bf16* dst = xt + half * X_SLAB + r * XLD + c;
    const bf16* src = p.x + static_cast<long long>(row) * p.K + half * Kh + col;
    if (p.xvec) {
      const bool ok = row < p.M && col < Kh;  // Kh is a multiple of 8 here
      cp_async16(dst, ok ? src : p.x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (row < p.M && col + e < Kh) ? src[e] : __float2bfloat16(0.f);
    }
  }
  constexpr int WCH = BN / 16;
  for (int id = threadIdx.x; id < BKP * WCH; id += TC_THREADS) {
    const int r = id / WCH, c = (id % WCH) * 16;
    const int row = kk0 + r, col = n_blk + c;
    unsigned char* dst = wt + r * WLD + c;
    const int8_t* src = p.qp + static_cast<long long>(row) * p.N + col;
    if (p.wvec) {
      const bool ok = row < Kh && col < p.N;  // N is a multiple of 16 here
      cp_async16(dst, ok ? src : p.qp, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (row < Kh && col + e < p.N) ? static_cast<unsigned char>(src[e]) : 0;
    }
  }
}

template <bool GROUPED, typename OUT>
__global__ void __launch_bounds__(TC_THREADS, 2) p4_mma(TcParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Kh = p.K / 2;
  const int m_blk = blockIdx.x * BM, n_blk = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp % 2) * 64;  // the warp's rows of the tile
  const int wn = (warp / 2) * 32;  // its columns
  const int nkt = (Kh + BKP - 1) / BKP;

  float acc[4][4][4];  // [16-row tile][8-column tile j][fragment]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  // the thread's B columns: tile j holds column n_blk + wn + 4 g + j
  const int bcol = n_blk + wn + 4 * g;
  __nv_bfloat162 slo[4], shi[4];  // GROUPED: the stage's scales, each doubled
  const __nv_bfloat162 bias = as_bf162(0x43084308u);  // 136 = 128 + 8, twice

  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < nkt) load_stage(p, smem + st * STAGE_BYTES, st, m_blk, n_blk);
    cp_async_commit();
  }

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<NSTAGE - 2>();  // tile kt has landed
    __syncthreads();              // for every thread; and tile kt - 1 is consumed
    if (kt + NSTAGE - 1 < nkt)
      load_stage(p, smem + ((kt + NSTAGE - 1) % NSTAGE) * STAGE_BYTES, kt + NSTAGE - 1,
                 m_blk, n_blk);
    cp_async_commit();

    if (GROUPED && (kt * BKP) % 128 == 0) {
      const int group = (kt * BKP) >> 7;
      const bf16* rlo = p.s + static_cast<long long>(group) * p.N;
      const bf16* rhi = p.s + static_cast<long long>(group + (p.K >> 8)) * p.N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = bcol + j < p.N;
        slo[j] = __bfloat162bfloat162(ok ? rlo[bcol + j] : __float2bfloat16(0.f));
        shi[j] = __bfloat162bfloat162(ok ? rhi[bcol + j] : __float2bfloat16(0.f));
      }
    }

    const unsigned char* stage = smem + (kt % NSTAGE) * STAGE_BYTES;
    const bf16* xlo = reinterpret_cast<const bf16*>(stage);
    const bf16* xhi = xlo + X_SLAB;
    const unsigned char* wt = stage + 2 * X_SLAB * 2;

#pragma unroll
    for (int ks = 0; ks < BKP / 8; ++ks) {
      // k indices 2t, 2t+1 of this step: the low nibbles of packed rows
      // 8 ks + 2t and + 1; k indices 2t+8, 2t+9: their high nibbles
      const unsigned char* wr = wt + (ks * 8 + 2 * t) * WLD + wn + 4 * g;
      const uint32_t w0 = ld32(wr) ^ 0x88888888u;
      const uint32_t w1 = ld32(wr + WLD) ^ 0x88888888u;
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte j of both rows: row 2t in the low half, row 2t+1 in the high
        const uint32_t sel = __byte_perm(w0, w1, 0x4400 + 0x1111 * j);
        __nv_bfloat162 lo = __hsub2(as_bf162((sel & 0x000F000Fu) | 0x43004300u), bias);
        __nv_bfloat162 hi = __hsub2(as_bf162(((sel >> 4) & 0x000F000Fu) | 0x43004300u), bias);
        if (GROUPED) {
          lo = __hmul2(lo, slo[j]);
          hi = __hmul2(hi, shi[j]);
        }
        b[j][0] = as_u32(lo);
        b[j][1] = as_u32(hi);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // the four 8 x 8 blocks of the A fragment in one load: rows 0-7 and
        // 8-15 of the low-half tile (k indices 0-7), then of the high-half
        // tile (k indices 8-15); lane l names row l % 8 of block l / 8
        uint32_t a[4];
        ldmatrix_x4(a, (lane < 16 ? xlo : xhi)
                       + (wm + mt * 16 + (lane & 15)) * XLD + ks * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[mt][j], a, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // D's column 2t + c of tile j is y's column wn + 4 (2t + c) + j: a thread
  // holds 8 consecutive columns, wn + 8t .. + 7, of rows g and g + 8
  const int col0 = n_blk + wn + 8 * t;
  float sc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    sc[i] = (!GROUPED && col0 + i < p.N) ? __bfloat162float(p.s[col0 + i]) : 1.f;
  OUT* const y = static_cast<OUT*>(p.y);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m_blk + wm + mt * 16 + g + 8 * h;
      if (row >= p.M) continue;
      OUT* out = y + static_cast<long long>(row) * p.N + col0;
      __align__(16) OUT v[8];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[4 * c + j] = cast_out<OUT>(acc[mt][j][2 * h + c] * sc[4 * c + j]);
      if (p.yvec) {  // N is a multiple of 8: the 8 columns are all inside, 16-byte aligned
        if (col0 < p.N) {
          const uint4* src = reinterpret_cast<const uint4*>(v);
          uint4* dst = reinterpret_cast<uint4*>(out);
#pragma unroll
          for (int q = 0; q < static_cast<int>(sizeof(v) / 16); ++q) dst[q] = src[q];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (col0 + i < p.N) out[i] = v[i];
      }
    }
  }
}

template <bool GROUPED, typename OUT>
int launch_mma(const TcParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      p4_mma<GROUPED, OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);  // M fastest: the blocks
  // in flight share a few column tiles of the weight
  p4_mma<GROUPED, OUT><<<grid, TC_THREADS, TC_SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool GROUPED>
int run(const void* x, const int8_t* qp, const bf16* s, void* y, float* ws, int M,
        int K, int N, int kchunk, int out_f32, cudaStream_t stream) {
  if (M < 1 || K < 2 || K % 2 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (GROUPED && K % 256) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  if (M <= SMALL_M_MAX)
    return run_splitk<GROUPED>(xb, qp, s, y, ws, M, K, N, kchunk, out_f32, stream);
  TcParams p;
  p.x = xb; p.qp = qp; p.s = s; p.y = y;
  p.M = M; p.K = K; p.N = N;
  p.xvec = ((K / 2) % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) ? 1 : 0;
  p.wvec = (N % 16 == 0 && reinterpret_cast<uintptr_t>(qp) % 16 == 0) ? 1 : 0;
  p.yvec = (N % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0) ? 1 : 0;
  return out_f32 ? launch_mma<GROUPED, float>(p, stream)
                 : launch_mma<GROUPED, bf16>(p, stream);
}

}  // namespace

// M <= quant_matmul_p4_small_m_max() takes the split-K form: the caller
// chooses kchunk (packed rows per block, at most quant_matmul_p4_kchunk_max)
// and sizes the workspace ws [ceil(K / 2 / kchunk), M, N] fp32. Larger M
// takes the tensor-core form and reads neither.
extern "C" int quant_matmul_p4_small_m_max() { return SMALL_M_MAX; }
extern "C" int quant_matmul_p4_kchunk_max() { return KCH_MAX; }
extern "C" int quant_matmul_p4_strip() { return STRIP; }

// per channel: qp [K/2, N], s [N]
extern "C" int quant_matmul_p4_bf16(const void* x, const void* qp, const void* s,
                                    void* y, float* ws, int M, int K, int N,
                                    int kchunk, int out_f32, void* stream) {
  return run<false>(x, static_cast<const int8_t*>(qp), static_cast<const bf16*>(s), y,
                    ws, M, K, N, kchunk, out_f32, static_cast<cudaStream_t>(stream));
}

// grouped: qp [K/2, N], s [K / 128, N]
extern "C" int quant_matmul_p4_grouped_bf16(const void* x, const void* qp, const void* s,
                                            void* y, float* ws, int M, int K, int N,
                                            int kchunk, int out_f32, void* stream) {
  return run<true>(x, static_cast<const int8_t*>(qp), static_cast<const bf16*>(s), y,
                   ws, M, K, N, kchunk, out_f32, static_cast<cudaStream_t>(stream));
}

// qp [L, K/2, N] and s [L, N] or [L, K / 128, N] whole; layer li is read in place
extern "C" int quant_matmul_p4_stacked_bf16(const void* x, const void* qp, const void* s,
                                            int li, int L, void* y, float* ws, int M,
                                            int K, int N, int kchunk, int out_f32,
                                            void* stream) {
  if (li < 0 || li >= L) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* ql = static_cast<const int8_t*>(qp) + static_cast<long long>(li) * (K / 2) * N;
  const bf16* sl = static_cast<const bf16*>(s) + static_cast<long long>(li) * N;
  return run<false>(x, ql, sl, y, ws, M, K, N, kchunk, out_f32,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int quant_matmul_p4_grouped_stacked_bf16(const void* x, const void* qp,
                                                    const void* s, int li, int L, void* y,
                                                    float* ws, int M, int K, int N,
                                                    int kchunk, int out_f32, void* stream) {
  if (li < 0 || li >= L) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* ql = static_cast<const int8_t*>(qp) + static_cast<long long>(li) * (K / 2) * N;
  const bf16* sl = static_cast<const bf16*>(s) + static_cast<long long>(li) * (K / 128) * N;
  return run<true>(x, ql, sl, y, ws, M, K, N, kchunk, out_f32,
                   static_cast<cudaStream_t>(stream));
}
