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
// int8 streamed once, about one operation per byte and row of x. The kernel
// is the I8 form of qmm_split.cuh: one cluster launch per product, no
// workspace (the ranks along K exchange their partial sums through
// distributed shared memory in rank order), long blocks in one wave, a TMA
// ring of 16 KB stages that no block barrier paces, and the products on
// the tensor cores (mma.sync m16n8k16) with each int8 pair turned into
// bf16x2 by integer and bf16x2 steps that are exact. Two tiles of x, each
// its own entry points: up to 8 rows a block (five stages; a decode step
// at batch <= 8), and the wide tile of 32 rows a block for M > 8 (three
// stages, each with 8 KB of x beside 16 KB of weight; the bench's decode
// batch of 32), where each weight fragment, built once from the bytes,
// meets four 8-row fragments of x. Up to 32 rows read the weight once; a
// larger M takes tiles of 32 rows, each re-reading it (right; prefill
// takes the s8 x s8 path). ptxas (CUDA 12.8, sm_90a): 70 registers (8
// rows) and 105 (the wide tile), no spills.
//
// fp32 x (a model served in fp32), up to 8 rows: the fp32 instance of the
// same kernel (_f32 entry points; qmm_split.cuh: x fp32 in the ring, each
// k-step two TF32 products on x split into hi + lo, the weight exact in
// TF32). More rows take quant_matmul_f32.cu's tensor-core form.

#include "qmm_split.cuh"

namespace {

template <int MT, typename X = __nv_bfloat16>
int run(const void* x, const int8_t* q, const __nv_bfloat16* s, void* y, int M, int K,
        int N, int cluster, int share, int out_f32, cudaStream_t stream) {
  qsplit::Params p = {};
  p.x = x;
  p.w = q;
  p.s = s;
  p.y = y;
  p.M = M;
  p.K = K;
  p.N = N;
  p.rows = K;
  p.out_f32 = out_f32;
  return qsplit::launch<qsplit::Form::I8, MT, X>(p, cluster, share, stream);
}

template <int MT, typename X = __nv_bfloat16>
int run_stacked(const void* x, const void* q, const void* s, int li, int L, void* y, int M,
                int K, int N, int cluster, int share, int out_f32, void* stream) {
  if (li < 0 || li >= L) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* ql = static_cast<const int8_t*>(q) + static_cast<long long>(li) * K * N;
  const __nv_bfloat16* sl = static_cast<const __nv_bfloat16*>(s) + static_cast<long long>(li) * N;
  return run<MT, X>(x, ql, sl, y, M, K, N, cluster, share, out_f32,
                    static_cast<cudaStream_t>(stream));
}

}  // namespace

// Clusters of `cluster` blocks that run at once, or a negative CUDA error
// (the host's plan takes the largest cluster that keeps a launch in one
// wave): the 8-row tile, and the wide one.
extern "C" int quant_matmul_clusters_at_once(int cluster) {
  return qsplit::clusters_at_once<qsplit::Form::I8>(cluster);
}

extern "C" int quant_matmul_wide_clusters_at_once(int cluster) {
  return qsplit::clusters_at_once<qsplit::Form::I8, 32>(cluster);
}

extern "C" int quant_matmul_f32_clusters_at_once(int cluster) {
  return qsplit::clusters_at_once<qsplit::Form::I8, 8, float>(cluster);
}

// One launch: clusters of `cluster` blocks along K, each rank taking `share`
// rows (a multiple of 16; cluster * share >= K); tiles of 8 rows of x, or
// (_wide) of 32. Only y is written.
extern "C" int quant_matmul_i8(const void* x, const void* q, const void* s, void* y, int M,
                               int K, int N, int cluster, int share, int out_f32,
                               void* stream) {
  return run<8>(x, static_cast<const int8_t*>(q), static_cast<const __nv_bfloat16*>(s), y, M,
                K, N, cluster, share, out_f32, static_cast<cudaStream_t>(stream));
}

extern "C" int quant_matmul_i8_wide(const void* x, const void* q, const void* s, void* y,
                                    int M, int K, int N, int cluster, int share, int out_f32,
                                    void* stream) {
  return run<32>(x, static_cast<const int8_t*>(q), static_cast<const __nv_bfloat16*>(s), y,
                 M, K, N, cluster, share, out_f32, static_cast<cudaStream_t>(stream));
}

// q [L, K, N] and s [L, N] whole; layer li is read in place.
extern "C" int quant_matmul_stacked_i8(const void* x, const void* q, const void* s, int li,
                                       int L, void* y, int M, int K, int N, int cluster,
                                       int share, int out_f32, void* stream) {
  return run_stacked<8>(x, q, s, li, L, y, M, K, N, cluster, share, out_f32, stream);
}

extern "C" int quant_matmul_stacked_i8_wide(const void* x, const void* q, const void* s,
                                            int li, int L, void* y, int M, int K, int N,
                                            int cluster, int share, int out_f32,
                                            void* stream) {
  return run_stacked<32>(x, q, s, li, L, y, M, K, N, cluster, share, out_f32, stream);
}

// fp32 x [M <= 8, K]: one launch of the fp32 instance (shares a multiple of 8 rows).
extern "C" int quant_matmul_i8_f32(const void* x, const void* q, const void* s, void* y, int M,
                                   int K, int N, int cluster, int share, int out_f32,
                                   void* stream) {
  if (M > 8) return static_cast<int>(cudaErrorInvalidValue);
  return run<8, float>(x, static_cast<const int8_t*>(q), static_cast<const __nv_bfloat16*>(s),
                       y, M, K, N, cluster, share, out_f32, static_cast<cudaStream_t>(stream));
}

extern "C" int quant_matmul_stacked_i8_f32(const void* x, const void* q, const void* s, int li,
                                           int L, void* y, int M, int K, int N, int cluster,
                                           int share, int out_f32, void* stream) {
  if (M > 8) return static_cast<int>(cudaErrorInvalidValue);
  return run_stacked<8, float>(x, q, s, li, L, y, M, K, N, cluster, share, out_f32, stream);
}
