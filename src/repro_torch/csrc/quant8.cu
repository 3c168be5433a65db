// Blockwise symmetric int8 quantize / dequantize for Hopper (sm_90a), written by hand.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/quant8.py:
// `_q_kernel` / `quantize` (the pallas_call at line 36) and `_dq_kernel` /
// `dequantize` (line 55).  Per block of `block` values of a row, padded with
// zeros to a whole number of blocks as the JAX functions pad:
//
//   scale = max(amax, 1e-20) / 127          amax = max |x| over the block, fp32
//   q     = clip(round(x / scale), -127, 127)   int8, round half to even
//   err   = x - q * scale                   fp32, optional (error feedback)
//   dequantize: out = q * scale, rounded once to the output dtype
//
// The reference holds q bit-equal to repro.parallel.compress.quantize
// (tests/test_kernels.py:74), so every rounding point is spelled out: the
// division is IEEE (`__fdiv_rn`, never a multiply by the reciprocal), the
// rounding is `rintf` (half to even; `floorf(x + 0.5f)` rounds ties up), and
// the residual is `__fsub_rn(x, __fmul_rn(q, scale))`: nvcc contracts
// `x - q * s` into one FMA by default, which changes the bits of err.  The build
// passes no --use_fast_math.  The results are bit-equal to
// repro_torch/kernels/quant8.py::quantize_plain / dequantize_plain.
//
// What differs from the TPU kernels, and why.  The Pallas grid visits one
// (1, block) tile per step.  Here one thread block of 256 threads owns one
// quantization block of one row: it loads the block once into shared memory as
// fp32, reduces amax (warp shuffles, then one warp over the warps' maxima),
// writes the scale, then q and, fused as a second output, the error-feedback
// residual that `ef_quantize` needs (the ROADMAP's K3 entry asks for it): the
// fp32 values never round-trip device memory.  Dequantize runs on the same
// grid, so a thread block reads its scale once and no thread divides an
// element index by the block size (a 64-bit division per element costs more
// than the element's bytes).  A row is `(b0, b1, b2, n)` read
// through element strides (last dimension contiguous) and pads and starts its
// blocks on its own, so the stacked gradient sync quantizes every replica's
// shard in one launch; the grid is (blocks of a row, rows).
//
// What bounds them on this card.  A few operations per element, so bytes: at
// the served shape (the error-feedback carry of llama3.2-1b's embedding, 8 rows
// of 65667072 fp32) quantize reads 2.1 GB and writes 0.5 GB of q and 2.1 GB of
// err, about 1.41 ms at 3.35 TB/s; dequantize of the gathered (4, 2, 65667072)
// int8 payload reads 0.5 GB and writes 2.1 GB, about 0.78 ms.  Loads and stores
// are one element a thread per step, coalesced across the warp; wider vectors
// are left for a later change.
//
// Plain C interface (no PyTorch headers): the wrapper in
// repro_torch/kernels/quant8.py passes raw pointers, element strides and the
// stream, and raises on a non-zero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlock = 12288;  // 48 KB of fp32 values in dynamic shared memory

struct Batch {
  int b1, b2;               // sizes of batch dimensions 1 and 2 (0 comes from the grid)
  long long s0, s1, s2;     // element strides of the batch dimensions
  __device__ __forceinline__ long long offset(int row) const {
    const int i2 = row % b2;
    const int i1 = (row / b2) % b1;
    const int i0 = row / (b2 * b1);
    return i0 * s0 + i1 * s1 + i2 * s2;
  }
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
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                    float* __restrict__ err, long long n, int block, long long nb, Batch bx) {
  extern __shared__ float xs[];
  __shared__ float warp_max[kWarps];
  const int row = blockIdx.y;
  const long long start = (long long)blockIdx.x * block;
  const int count = (int)min((long long)block, n - start);  // the rest of the block is padding
  const T* xr = x + bx.offset(row) + start;

  float amax = 0.0f;  // padding zeros cannot raise it
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const float v = to_f32(xr[i]);
    xs[i] = v;
    amax = fmaxf(amax, fabsf(v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = lane < kWarps ? warp_max[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) warp_max[0] = amax;
  }
  __syncthreads();
  const float scale = __fdiv_rn(fmaxf(warp_max[0], 1e-20f), 127.0f);
  if (threadIdx.x == 0) scales[(long long)row * nb + blockIdx.x] = scale;

  const long long out = (long long)row * n + start;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const float v = xs[i];
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f);
    q[out + i] = (int8_t)r;
    if (err != nullptr) err[out + i] = __fsub_rn(v, __fmul_rn(r, scale));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                      T* __restrict__ out, long long n, int block, Batch bq, Batch bs) {
  const int row = blockIdx.y;
  const long long start = (long long)blockIdx.x * block;
  const int count = (int)min((long long)block, n - start);
  const float scale = scales[bs.offset(row) + blockIdx.x];
  const int8_t* qr = q + bq.offset(row) + start;
  T* o = out + (long long)row * n + start;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    o[i] = from_f32<T>(__fmul_rn((float)qr[i], scale));
  }
}

bool grid_fits(long long blocks, long long rows) {
  return blocks >= 1 && blocks <= 2147483647LL && rows >= 1 && rows <= 65535;
}

}  // namespace

// x: (b0, b1, b2, n) through the strides, fp32 or bf16.  q: (b0, b1, b2, n) int8,
// scales: (b0, b1, b2, ceil(n / block)) fp32, err: like q in fp32 or null; all
// three contiguous.  Returns 0 or an error code.
extern "C" int quantize_fwd(const void* x, void* q, void* scales, void* err, long long n,
                            int block, int b0, int b1, int b2, long long s0, long long s1,
                            long long s2, int is_bf16, void* stream) {
  if (block < 1 || block > kMaxBlock || n < 1) return -2;
  const long long nb = (n + block - 1) / block;
  const long long rows = (long long)b0 * b1 * b2;
  if (!grid_fits(nb, rows)) return -4;
  const Batch bx{b1, b2, s0, s1, s2};
  const dim3 grid((unsigned)nb, (unsigned)rows);
  const size_t smem = (size_t)block * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a block of more than 12276 values needs more than the default 48 KB of
  // shared memory (with the warp maxima); raise the limit once per dtype
  static bool raised[2] = {false, false};
  if (!raised[is_bf16 ? 1 : 0]) {
    const cudaError_t e = is_bf16
        ? cudaFuncSetAttribute(quantize_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxBlock * (int)sizeof(float))
        : cudaFuncSetAttribute(quantize_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxBlock * (int)sizeof(float));
    if (e != cudaSuccess) return (int)e;
    raised[is_bf16 ? 1 : 0] = true;
  }
  if (is_bf16) {
    quantize_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), static_cast<float*>(err), n, block, nb, bx);
  } else {
    quantize_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(scales),
        static_cast<float*>(err), n, block, nb, bx);
  }
  return (int)cudaGetLastError();
}

// q: (b0, b1, b2, n) int8 and scales: (b0, b1, b2, nb) fp32 through their strides
// (last dimensions contiguous); out: (b0, b1, b2, n) contiguous, fp32 or bf16.
extern "C" int dequantize_fwd(const void* q, const void* scales, void* out, long long n,
                              int block, int b0, int b1, int b2, long long sq0, long long sq1,
                              long long sq2, long long ss0, long long ss1, long long ss2,
                              int out_bf16, void* stream) {
  if (block < 1 || n < 1) return -2;
  const long long rows = (long long)b0 * b1 * b2;
  const long long blocks = (n + block - 1) / block;
  if (!grid_fits(blocks, rows)) return -4;
  const Batch bq{b1, b2, sq0, sq1, sq2};
  const Batch bs{b1, b2, ss0, ss1, ss2};
  const dim3 grid((unsigned)blocks, (unsigned)rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  if (out_bf16) {
    dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        qp, sp, static_cast<__nv_bfloat16*>(out), n, block, bq, bs);
  } else {
    dequantize_kernel<float><<<grid, kThreads, 0, s>>>(qp, sp, static_cast<float*>(out), n,
                                                       block, bq, bs);
  }
  return (int)cudaGetLastError();
}
