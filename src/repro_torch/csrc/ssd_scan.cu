// Mamba2 SSD chunked scan for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel `_kernel` / `ssd_scan` of
// src/repro/kernels/ssd_scan.py (the pallas_call at line 94).  Per head and per
// chunk of kChunk tokens it computes what that kernel computes:
//
//   cs        = cumsum(dt * A)                       within the chunk
//   M[i, j]   = (C_i . B_j) * exp(cs_i - cs_j) * dt_j  for j <= i, else 0
//   y         = M . x  +  (C . state^T) * exp(cs)
//   state     = exp(cs_last) * state + sum_q (x_q * dt_q * exp(cs_last - cs_q)) B_q^T
//
// with the (hd, N) state carried in fp32 from chunk to chunk and y written in
// x's dtype.  Beyond the Pallas kernel, because the model path needs both
// (src/repro/models/ssm.py::ssd_chunked is the oracle for them): an optional
// initial state (a null pointer means zeros) and the final state written out.
//
// What differs from the TPU kernel, and why.  There the grid is
// (batch*heads, chunks) and the chunk axis runs in order on one core, carrying
// the state in VMEM scratch.  Here blocks run in parallel and nothing carries
// between them, so one thread block owns one (batch, head) and walks the
// chunks itself with the state in shared memory.  The kernel reads x, B, C and
// dt through their strides: in the model they are slices of one conv output
// (B, S, d_inner + 2GN), so no moveaxis / pad / contiguous copies are made.
// Head h reads B/C group h / (H/G) in place; the Pallas wrapper repeats B and
// C per head, which at H 64, G 1 is 64 times the bytes.  A ragged last chunk
// is loaded with x = B = C = 0 and dt = 0, so the padded steps have decay 1
// and add nothing: the final state is the state after token S-1, and padded
// rows of y are never stored.  exp(cs_i - cs_j) is evaluated only for j <= i:
// above the diagonal it is positive and can overflow, and inf * 0 is NaN.
//
// What bounds it on this card.  At mamba2-1.3b's serving prefill (B 8, S 2048,
// H 64, hd 64, N 128, G 1, bf16) the function moves about 298 MB (x, y, dt, B,
// C, final state) and does about 47 GFLOP (the causal half of the two
// chunk-by-chunk products, plus C.state^T and the state update): about 160
// operations per byte, below the ~295 where an H100 turns from memory- to
// tensor-core-bound, so the bound is bytes (about 0.089 ms).  This first
// kernel is far from that bound by design: every product is plain fp32 FMAs
// out of shared memory (4x4 register tiles, rows padded by 4 floats so float4
// reads of neighbouring rows hit distinct banks), one block of 256 threads per
// (batch, head) and, at N 128, one block per SM (137 KB of shared memory).
// Tensor-core tiling (`mma.sync` / `wgmma`), TMA loads overlapping the
// products, and chunk-parallel state passing are left for a later change.
//
// Plain C interface (no PyTorch headers): the wrapper in
// repro_torch/kernels/ssd_scan.py passes raw pointers, element strides and the
// stream, and raises on a non-zero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;     // tokens per chunk (the Pallas default)
constexpr int kThreads = 256;  // 16 x 16 tiles of 4 x 4 for the chunk-by-chunk products
static_assert(kChunk == 64 && kThreads == 256,
              "the cumulative sum is one warp of two steps a lane; the M tile map is 16 x 16");

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* h0;  // (B, H, hd, N) fp32 contiguous, or null for zeros
  void* y;
  float* hT;        // (B, H, hd, N) fp32 contiguous, or null to skip
  int B, S, H, G;
  // strides in elements (the last dimension of x, B, C, y has stride 1)
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long a_s;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long y_sb, y_ss, y_sh;
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Shared-memory layout, in floats.  Every array starts on a 16-byte boundary.
template <int HD, int N>
struct Smem {
  static constexpr int NP = N + 4;       // padded row of the state, B and C
  static constexpr int HP = HD + 4;      // padded row of x
  static constexpr int QP = kChunk + 4;  // padded row of M^T
  static constexpr int kState = HD * NP;
  static constexpr int kBC = kChunk * NP;
  static constexpr int kX = kChunk * HP;
  static constexpr int kM = kChunk * QP;
  static constexpr int kFloats = kState + 2 * kBC + kX + kM + 3 * kChunk;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int HD, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Params p) {
  using L = Smem<HD, N>;
  constexpr int NP = L::NP, HP = L::HP, QP = L::QP;
  static_assert(HD % 4 == 0 && N % 4 == 0, "hd and N must be multiples of 4");

  extern __shared__ __align__(16) float smem[];
  float* st = smem;             // [HD][NP] the carried state
  float* Bs = st + L::kState;   // [Q][NP]
  float* Cs = Bs + L::kBC;      // [Q][NP]
  float* xs = Cs + L::kBC;      // [Q][HP]
  float* Mt = xs + L::kX;       // [Q][QP], Mt[j][i] = M[i][j]
  float* cs = Mt + L::kM;       // [Q] cumulative dt*A from the chunk's start
  float* dts = cs + kChunk;     // [Q]
  float* w = dts + kChunk;      // [Q] dt_q * exp(cs_last - cs_q)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int g = h / (p.H / p.G);
  const float A = p.A[h * p.a_s];

  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const T* Bg = static_cast<const T*>(p.Bm) + b * p.b_sb + g * p.b_sg;
  const T* Cg = static_cast<const T*>(p.Cm) + b * p.c_sb + g * p.c_sg;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  T* y = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;
  const long long state_off = (long long)bh * HD * N;

  for (int i = tid; i < HD * N; i += kThreads)
    st[(i / N) * NP + i % N] = p.h0 ? p.h0[state_off + i] : 0.f;

  const int n_chunks = (p.S + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * kChunk;
    const int valid = min(kChunk, p.S - s0);

    // ---- load the chunk; rows past the end are zeros (dt = 0: decay 1, no update)
    for (int i = tid; i < kChunk * HD; i += kThreads) {
      const int q = i / HD, d = i % HD;
      xs[q * HP + d] = q < valid ? to_f32(x[(long long)(s0 + q) * p.x_ss + d]) : 0.f;
    }
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int q = i / N, n = i % N;
      const bool ok = q < valid;
      Bs[q * NP + n] = ok ? to_f32(Bg[(long long)(s0 + q) * p.b_ss + n]) : 0.f;
      Cs[q * NP + n] = ok ? to_f32(Cg[(long long)(s0 + q) * p.c_ss + n]) : 0.f;
    }
    if (tid < kChunk) dts[tid] = tid < valid ? dt[(long long)(s0 + tid) * p.dt_ss] : 0.f;
    __syncthreads();

    // ---- cs = cumsum(dt*A): one warp, two steps a lane, a shuffle scan over lanes
    if (tid < 32) {
      const float a0 = dts[2 * tid] * A;
      const float a1 = dts[2 * tid + 1] * A;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
      const float c0 = (tid ? prev : 0.f) + a0;
      const float c1 = incl;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      cs[2 * tid] = c0;
      cs[2 * tid + 1] = c1;
      w[2 * tid] = dts[2 * tid] * expf(last - c0);
      w[2 * tid + 1] = dts[2 * tid + 1] * expf(last - c1);
    }
    __syncthreads();

    // ---- M = (C.B^T) o L o dt, stored transposed.  Thread (ti, tj) owns rows
    // i = 4ti..4ti+3 and columns j = tj + 16k: neighbouring threads read
    // neighbouring B rows (distinct banks), a row of C is a broadcast.
    {
      const int ti = tid / 16, tj = tid % 16;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = ld4(&Cs[(4 * ti + a) * NP + n]);
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = ld4(&Bs[(tj + 16 * k) * NP + n]);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[a][k] = dot4(cv[a], bv[k], acc[a][k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = tj + 16 * k;
        float m[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = 4 * ti + a;
          // only below the diagonal: above it exp() may overflow
          m[a] = j <= i ? acc[a][k] * expf(cs[i] - cs[j]) * dts[j] : 0.f;
        }
        *reinterpret_cast<float4*>(&Mt[j * QP + 4 * ti]) = make_float4(m[0], m[1], m[2], m[3]);
      }
    }
    __syncthreads();

    // ---- y = M.x + (C.state^T) * exp(cs).  Thread owns rows 4ti..4ti+3 and
    // head columns td + (HD/4)c.
    {
      constexpr int TD = HD / 4;
      for (int t = tid; t < (kChunk / 4) * TD; t += kThreads) {
        const int ti = t / TD, td = t % TD;
        float acc[4][4], acc2[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[a][cc] = acc2[a][cc] = 0.f;
        const int jmax = 4 * ti + 3;  // M[i][j] = 0 for j > i
        for (int j = 0; j <= jmax; ++j) {
          const float4 m = ld4(&Mt[j * QP + 4 * ti]);
          float xv[4];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) xv[cc] = xs[j * HP + td + TD * cc];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            acc[0][cc] = fmaf(m.x, xv[cc], acc[0][cc]);
            acc[1][cc] = fmaf(m.y, xv[cc], acc[1][cc]);
            acc[2][cc] = fmaf(m.z, xv[cc], acc[2][cc]);
            acc[3][cc] = fmaf(m.w, xv[cc], acc[3][cc]);
          }
        }
#pragma unroll 4
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], sv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = ld4(&Cs[(4 * ti + a) * NP + n]);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) sv[cc] = ld4(&st[(td + TD * cc) * NP + n]);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) acc2[a][cc] = dot4(cv[a], sv[cc], acc2[a][cc]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = 4 * ti + a;
          if (i < valid) {
            const float e = expf(cs[i]);
            T* yrow = y + (long long)(s0 + i) * p.y_ss;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              yrow[td + TD * cc] = from_f32<T>(acc[a][cc] + acc2[a][cc] * e);
          }
        }
      }
    }
    __syncthreads();

    // ---- state = exp(cs_last) * state + sum_q (w_q x_q) B_q^T.  Thread owns
    // state rows 4td..4td+3 and columns 4tn..4tn+3.
    {
      constexpr int TN = N / 4;
      const float decay = expf(cs[kChunk - 1]);
      for (int t = tid; t < (HD / 4) * TN; t += kThreads) {
        const int td = t / TN, tn = t % TN;
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;
        for (int q = 0; q < valid; ++q) {
          const float wq = w[q];
          const float4 xv = ld4(&xs[q * HP + 4 * td]);
          const float4 bv = ld4(&Bs[q * NP + 4 * tn]);
          const float xw[4] = {xv.x * wq, xv.y * wq, xv.z * wq, xv.w * wq};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[a][0] = fmaf(xw[a], bv.x, acc[a][0]);
            acc[a][1] = fmaf(xw[a], bv.y, acc[a][1]);
            acc[a][2] = fmaf(xw[a], bv.z, acc[a][2]);
            acc[a][3] = fmaf(xw[a], bv.w, acc[a][3]);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float4* sp = reinterpret_cast<float4*>(&st[(4 * td + a) * NP + 4 * tn]);
          float4 s = *sp;
          s.x = fmaf(s.x, decay, acc[a][0]);
          s.y = fmaf(s.y, decay, acc[a][1]);
          s.z = fmaf(s.z, decay, acc[a][2]);
          s.w = fmaf(s.w, decay, acc[a][3]);
          *sp = s;
        }
      }
    }
    __syncthreads();  // the next chunk overwrites x and B
  }

  if (p.hT)
    for (int i = tid; i < HD * N; i += kThreads) p.hT[state_off + i] = st[(i / N) * NP + i % N];
}

template <typename T, int HD, int N>
int launch(const Params& p, cudaStream_t s) {
  constexpr size_t bytes = Smem<HD, N>::kBytes;
  static_assert(bytes <= 232448, "shared memory of one block on an H100");
  static bool attr_set = false;  // the attribute sticks to the function
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<T, HD, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  ssd_scan_kernel<T, HD, N><<<p.B * p.H, kThreads, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_n(const Params& p, int N, cudaStream_t s) {
  switch (N) {
    case 8: return launch<T, HD, 8>(p, s);
    case 16: return launch<T, HD, 16>(p, s);
    case 32: return launch<T, HD, 32>(p, s);
    case 64: return launch<T, HD, 64>(p, s);
    case 128: return launch<T, HD, 128>(p, s);
    default: return -1;
  }
}

template <typename T>
int launch_hd(const Params& p, int hd, int N, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_n<T, 16>(p, N, s);
    case 32: return launch_n<T, 32>(p, N, s);
    case 64: return launch_n<T, 64>(p, N, s);
    default: return -1;
  }
}

}  // namespace

extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A, const void* Bm,
                            const void* Cm, const float* h0, void* y, float* hT, int B, int S,
                            int H, int G, int hd, int N, long long x_sb, long long x_ss,
                            long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
                            long long a_s, long long b_sb, long long b_ss, long long b_sg,
                            long long c_sb, long long c_ss, long long c_sg, long long y_sb,
                            long long y_ss, long long y_sh, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0) return -2;
  if ((long long)B * H > 2147483647LL) return -2;
  Params p{x,    dt,   A,    Bm,   Cm,   h0,   y,    hT,   B,    S,    H,    G,
           x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, a_s, b_sb, b_ss, b_sg, c_sb, c_ss,
           c_sg, y_sb, y_ss, y_sh};
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_hd<__nv_bfloat16>(p, hd, N, s) : launch_hd<float>(p, hd, N, s);
}
