// Pairwise tree reduction of N stacked shards for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel `_kernel` / `tree_reduce` of
// src/repro/kernels/reduce_tree.py (the pallas_call at line 42; its oracle is
// `ref_reduce`, line 53): the on-chip combiner that a reduce-scatter or
// all-reduce runs over the shards that arrived, the R-uswitch analogue of
// FRED.  For every output column it sums the N shards in fp32 with the fixed
// pairwise tree of `ref_reduce`
//
//   while m > 1:  x[i] = x[i] + x[i + m/2]  for i < m/2;  an odd tail x[m-1]
//                 moves to x[m/2];  m = m/2 + m%2
//
// and writes the result once, rounded to the shards' dtype.  The order of the
// adds is the point of the TPU kernel (deterministic, error O(log N)), so it is
// kept exactly: fp32 and bf16 results are bit-equal to
// repro_torch/kernels/reduce_tree.py::tree_reduce_plain on the same inputs.
//
// What differs from the TPU kernel, and why.  There a grid step holds an
// (N, block) tile in VMEM and reduces it with whole-tile adds.  Here one thread
// owns one output column and holds its N values in registers: N is a template
// parameter (1..64, one instantiation each), so the tree unrolls at compile
// time into plain register adds and no value goes to local memory.  The input
// is `(b0, b1, b2, N, L)` read through element strides (the last dimension
// contiguous), so the stacked transport of the gradient sync reduces a strided
// `(P, D_recv, D_src, s)` view of the padded gradients over D_src in one launch,
// with no copy; the output is `(b0, b1, b2, L)` contiguous.
//
// What bounds it on this card.  It does one add per input element, so it is
// bound by bytes: at the served shape (llama3.2-1b's embedding gradient in the
// pod 2 x data 4 sync, (2, 4, 4, 65667072) bf16 -> (2, 4, 65667072)) it reads
// 4.2 GB and writes 1.05 GB, about 1.57 ms at 3.35 TB/s.  Neighbouring threads
// read neighbouring columns of one shard row, so every load of a warp is
// coalesced; a thread loads one element per row (2 bytes in bf16), which leaves
// wider vector loads for a later change.
//
// Plain C interface (no PyTorch headers): the wrapper in
// repro_torch/kernels/reduce_tree.py passes raw pointers, element strides and
// the stream, and raises on a non-zero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 64;

struct Params {
  const void* x;
  void* out;
  long long L;
  int b1, b2;                    // sizes of batch dimensions 1 and 2 (0 comes from the grid)
  long long sb0, sb1, sb2, sn;   // element strides of x; the last dimension has stride 1
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch's .to(bfloat16)
}

// One level of ref_reduce's tree on M live values, then the next level.
template <int M>
struct Tree {
  __device__ __forceinline__ static void run(float* v) {
    constexpr int half = M / 2;
#pragma unroll
    for (int i = 0; i < half; ++i) v[i] = v[i] + v[i + half];
    if constexpr (M % 2 == 1) v[half] = v[2 * half];
    Tree<half + M % 2>::run(v);
  }
};
template <>
struct Tree<1> {
  __device__ __forceinline__ static void run(float*) {}
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) tree_reduce_kernel(Params p) {
  const long long l = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (l >= p.L) return;
  const int row = blockIdx.y;
  const int i2 = row % p.b2;
  const int i1 = (row / p.b2) % p.b1;
  const int i0 = row / (p.b2 * p.b1);
  const T* x = static_cast<const T*>(p.x) + i0 * p.sb0 + i1 * p.sb1 + i2 * p.sb2 + l;
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = to_f32(x[i * p.sn]);
  Tree<N>::run(v);
  static_cast<T*>(p.out)[(long long)row * p.L + l] = from_f32<T>(v[0]);
}

template <typename T, int N>
int launch(int n, dim3 grid, const Params& p, cudaStream_t stream) {
  if constexpr (N > kMaxShards) {
    return -2;
  } else {
    if (n != N) return launch<T, N + 1>(n, grid, p, stream);
    tree_reduce_kernel<T, N><<<grid, kThreads, 0, stream>>>(p);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// x: (b0, b1, b2, n, L) through the strides (last dimension contiguous), fp32 or
// bf16; out: (b0, b1, b2, L) contiguous, same dtype.  Returns 0 or an error code.
extern "C" int tree_reduce_fwd(const void* x, void* out, int n, long long L, int b0, int b1,
                               int b2, long long sb0, long long sb1, long long sb2,
                               long long sn, int is_bf16, void* stream) {
  if (n < 1 || n > kMaxShards) return -2;
  if (L < 1 || b0 < 1 || b1 < 1 || b2 < 1) return -3;
  const long long rows = (long long)b0 * b1 * b2;
  const long long blocks = (L + kThreads - 1) / kThreads;
  if (rows > 65535 || blocks > 2147483647LL) return -4;
  Params p{x, out, L, b1, b2, sb0, sb1, sb2, sn};
  dim3 grid((unsigned)blocks, (unsigned)rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16, 1>(n, grid, p, s) : launch<float, 1>(n, grid, p, s);
}
