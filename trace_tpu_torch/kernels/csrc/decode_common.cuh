// Pieces shared by the two decode attention kernels (decode_attention.cu for
// a bf16 cache, decode_attention_int8.cu for an int8 one), which run as one
// cluster launch each: a cluster of C blocks per (kv head, batch row), block
// r owning a contiguous share of the slots, the row's statistics exchanged
// through distributed shared memory. Here: the split cluster barrier, the
// cp.async ring that streams the listed K or V rows, the list of the slots a
// block takes, a reduce-scatter over the lanes of a row, the output's store
// in q's type (bf16, or fp32 for a model served in fp32), and the host's rule
// for C and the cluster launch. Both kernels take G = 1 ... 8 query rows a kv
// head at hd 128 and 256 (1, 2 or 4 at hd 64); the wrappers split a larger
// group into launches of at most 8 rows. Any other head dim that is a
// multiple of 4 up to 256 runs at the next width HD (64, 128 or 256) with its
// rows zero-padded in shared memory as they land (stage_rows): the cache is
// read in place, no copy of it is made. Width 256 is built for a bf16 query
// alone.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int MAX_CLUSTER = 8;    // blocks per (kv head, batch row), portable
constexpr float MASKED = -1e30f;  // a slot whose bias is not above this is masked
constexpr int SMS = 132;          // streaming multiprocessors of an H100 SXM

// the least power of two >= g: the reduce-scatter of pass 1 runs on the G
// query rows padded with rows of zeros to that count (never stored)
__host__ __device__ constexpr int pow2_ceil(int g) {
  return g <= 1 ? 1 : 2 * pow2_ceil((g + 1) / 2);
}

// blocks of a decode kernel an SM holds (its __launch_bounds__): four, or two
// above G = 4, whose query rows and partial sums need twice the registers
__host__ __device__ constexpr int blocks_per_sm(int g) {
  return g > 4 ? 2 : 4;
}

// an output value in q's type
__device__ __forceinline__ void store_out(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16(x);
}
__device__ __forceinline__ void store_out(float* o, float x) { *o = x; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the cluster barrier in two halves: arrive (release: this block's writes,
// also into other blocks' shared memory, become visible), then wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a[0..G) summed over the N lanes (xor groups) that share sub = lane % N:
// after it a[0] holds the sum of a[sub / (N / G)] (N >= G, both powers of 2)
template <int G, int N, typename T>
__device__ __forceinline__ void reduce_scatter(T (&a)[G], int sub) {
  int off = N / 2;
#pragma unroll
  for (int half = G / 2; half > 0; half /= 2, off /= 2) {
    const bool hi = (sub & off) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const T keep = hi ? a[half + i] : a[i];
      const T send = hi ? a[i] : a[half + i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (; off > 0; off /= 2) a[0] += __shfl_xor_sync(0xffffffffu, a[0], off);
}

// start the copies of tile t (rows idx[t * TR .. min(nv, (t + 1) * TR)) of a
// stripe of ROW-byte rows, TR = STAGE / ROW) into stage t % NSTAGE of the
// ring, as one commit group (empty past the last tile, so that every thread
// counts the same groups)
template <int ROW, int STAGE, int NSTAGE, int NT>
__device__ __forceinline__ void stage_tile(void* ring, const void* src, const int* idx, int t,
                                           int nv) {
  constexpr int CPR = ROW / 16;    // 16-byte pieces per row
  constexpr int TR = STAGE / ROW;  // rows per tile
  const int k0 = t * TR, rows = min(nv - k0, TR);
  unsigned char* dst = static_cast<unsigned char*>(ring) + (t % NSTAGE) * STAGE;
  const unsigned char* rows_src = static_cast<const unsigned char*>(src);
  for (int c = threadIdx.x; c < rows * CPR; c += NT) {
    const int r = c / CPR, piece = c % CPR;
    cp_async16(dst + r * ROW + piece * 16,
               rows_src + static_cast<long long>(idx[k0 + r]) * ROW + piece * 16);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// cp.async of a P-byte piece (16, 8 or 4) whose first n bytes come from src
// and whose rest is zero-filled (n = 0: nothing is read)
template <int P>
__device__ __forceinline__ void cp_async_fill(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (P == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(P),
                 "r"(n)
                 : "memory");
}

// stage_tile for a stripe whose rows hold gbytes < ROW bytes in device memory
// (a head dim below the kernel's width HD): each row's ROW bytes in the ring
// copied as P-byte pieces, the bytes past gbytes zero-filled, so that the
// ring holds the rows as stage_tile puts them with zero columns past hd
template <int P, int ROW, int STAGE, int NSTAGE, int NT>
__device__ __forceinline__ void stage_tile_padded(void* ring, const void* src, const int* idx,
                                                  int t, int nv, int gbytes) {
  constexpr int CPR = ROW / P;     // pieces per row of the ring
  constexpr int TR = STAGE / ROW;  // rows per tile
  const int k0 = t * TR, rows = min(nv - k0, TR);
  unsigned char* dst = static_cast<unsigned char*>(ring) + (t % NSTAGE) * STAGE;
  const unsigned char* rows_src = static_cast<const unsigned char*>(src);
  for (int c = threadIdx.x; c < rows * CPR; c += NT) {
    const int r = c / CPR, off = (c % CPR) * P;
    const unsigned char* row = rows_src + static_cast<long long>(idx[k0 + r]) * gbytes;
    const int n = min(P, max(0, gbytes - off));
    cp_async_fill<P>(dst + r * ROW + off, n > 0 ? row + off : row, n);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the copies of tile t of a stripe of gbytes-byte rows: stage_tile where the
// rows fill the kernel's width (PAD false, gbytes = ROW), else
// stage_tile_padded in the largest pieces (16, 8 or 4 bytes) that the rows'
// alignment allows
template <bool PAD, int ROW, int STAGE, int NSTAGE, int NT>
__device__ __forceinline__ void stage_rows(void* ring, const void* src, const int* idx, int t,
                                           int nv, int gbytes) {
  if constexpr (!PAD)
    stage_tile<ROW, STAGE, NSTAGE, NT>(ring, src, idx, t, nv);
  else if (gbytes % 16 == 0)
    stage_tile_padded<16, ROW, STAGE, NSTAGE, NT>(ring, src, idx, t, nv, gbytes);
  else if (gbytes % 8 == 0)
    stage_tile_padded<8, ROW, STAGE, NSTAGE, NT>(ring, src, idx, t, nv, gbytes);
  else
    stage_tile_padded<4, ROW, STAGE, NSTAGE, NT>(ring, src, idx, t, nv, gbytes);
}

// the kernels' width HD for a head dim hd they take: 64, 128 or 256
// themselves (padded false); any other multiple of 4 below 256 at the next of
// the three, its rows zero-padded in shared memory (padded true); 0 for any
// other hd
inline int decode_width(int hd, bool* padded) {
  *padded = hd != 64 && hd != 128 && hd != 256;
  if (hd < 4 || hd > 256 || hd % 4) return 0;
  return hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

// the slots of [j0, j1) that the block takes, ascending, into idx; returns
// their count. Every slot if dense, else the visible ones (bsh[j - j0], the
// share's bias, above MASKED). wcnt: NT / 32 ints of shared memory
template <int NT>
__device__ __forceinline__ int list_slots(int* idx, int* wcnt, const float* bsh, int j0,
                                          int j1, bool dense) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int nv = 0;
  for (int base = j0; base < j1; base += NT) {
    const int j = base + threadIdx.x;
    const bool take = j < j1 && (dense || bsh[j - j0] > MASKED);
    const unsigned bal = __ballot_sync(0xffffffffu, take);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = nv, tot = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      off += w < warp ? wcnt[w] : 0;
      tot += wcnt[w];
    }
    if (take) idx[off + __popc(bal & ((1u << lane) - 1u))] = j;
    nv += tot;
    __syncthreads();
  }
  return nv;
}

// Blocks per (kv head, batch row): MAX_CLUSTER at serving lengths, fewer
// where a share would hold under min_share slots or the grid would pass
// max_blocks (where C > 1), but never fewer than hold the row in shared
// memory: a block needs ring + per_slot bytes a slot of its share (rounded
// up to 16 slots) of at most max_smem. C = 1 past that still launches, and
// fails for want of shared memory.
inline int cluster_blocks(int S, int pairs, int min_share, int max_blocks, int max_smem,
                          int ring, int per_slot) {
  const int by_length = (S + min_share - 1) / min_share;
  const int by_grid = max_blocks / pairs;
  const int fit = (max_smem - ring) / per_slot - 15;
  const int by_memory = (S + fit - 1) / fit;
  return std::min(MAX_CLUSTER, std::max({1, by_memory, std::min(by_length, by_grid)}));
}

// one launch of kernel on a grid of (C, nkv, B) blocks of nt threads in
// clusters of C along x, with smem bytes of dynamic shared memory
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int C, int nkv, int B, int nt, size_t smem,
                    cudaStream_t stream, Args... args) {
  // static and dynamic shared memory together pass 48 KB at some lengths
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, nkv, B);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
