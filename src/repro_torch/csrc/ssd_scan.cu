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
// between them, so a thread block walks the chunks of one (batch, head) itself.
// The kernel reads x, B, C and dt through their strides: in the model they are
// slices of one conv output (B, S, d_inner + 2GN), so no moveaxis / pad /
// contiguous copies are made.  Head h reads B/C group h / (H/G) in place; the
// Pallas wrapper repeats B and C per head, which at H 64, G 1 is 64 times the
// bytes.  A ragged last chunk is loaded with x = B = C = 0 and dt = 0, so the
// padded steps have decay 1 and add nothing: the final state is the state after
// token S-1, and padded rows of y are never stored.  exp(cs_i - cs_j) is
// evaluated only for j <= i: above the diagonal it is positive and can
// overflow, and inf * 0 is NaN.
//
// What bounds it on this card.  At mamba2-1.3b's serving prefill (B 8, S 2048,
// H 64, hd 64, N 128, G 1, bf16) the function moves about 298 MB (x, y, dt, B,
// C, final state) and does about 47 GFLOP (the causal half of the two
// chunk-by-chunk products, plus C.state^T and the state update): about 160
// operations per byte, below the ~295 where an H100 turns from memory- to
// tensor-core-bound, so the bound is bytes (about 0.089 ms).  What keeps a
// kernel from it is the chain of 32 dependent chunks per head, so the design
// is about latency: many blocks in flight, and products short enough that a
// chunk's chain is a few microseconds.
//   * bf16 (ssd_scan_tc): the four products run on the tensor cores as
//     `mma.sync.m16n8k16` (bf16 operands, fp32 accumulation), operands staged
//     in shared memory as bf16 and read with ldmatrix.  x, B and C are exact
//     bf16 inputs; M (with its exp and dt factors), w.x and the carried fp32
//     state are not, so each is split into hi = bf16(v) and lo = bf16(v - hi)
//     and multiplied twice, which keeps about 16 of fp32's 24 mantissa bits
//     (a single bf16 rounding of the state-update operand fails the final
//     state's tolerance; tests/test_torch_ssd_precision.py emulates both).
//     The state stays in fp32 registers as the accumulator of its own update;
//     its hi / lo copy in shared memory is the operand of the next chunk's
//     C.state^T.  The head dimension is split: a block of 4 warps carries 32
//     (or hd, if smaller) rows of the state, since rows are independent, and
//     recomputes the cheap C.B^T (G = 1 at the served shapes, so the two
//     halves of a head read the same B and C from L2).  That gives B*H*2
//     blocks of 128 threads and about 108 KB of shared memory each at N 128:
//     two blocks an SM.  Chunk c+1's x, B, C and dt are prefetched with 16-byte
//     cp.async into a second buffer while chunk c computes (element loads if a
//     row is not 16-byte aligned).  Two block barriers a chunk; the cumulative
//     sum is computed by every warp for itself, in units of log2, so each
//     decay is one 2^x.  N 8 is zero-padded to a depth
//     of 16.  One device kernel per call.
//   * fp32 (ssd_scan_kernel): plain fp32 FMAs out of shared memory (4x4
//     register tiles), one block of 256 threads per (batch, head).  fp32 x, B
//     and C are not exact in bf16, and this path serves checks and small fp32
//     models, not the bf16 serving path.
//
// Plain C interface (no PyTorch headers): the wrapper in
// repro_torch/kernels/ssd_scan.py passes raw pointers, element strides and the
// stream, and raises on a non-zero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kChunk = 64;     // tokens per chunk (the Pallas default)
constexpr int kThreads = 256;  // fp32 path: 16 x 16 tiles of 4 x 4 for the chunk-by-chunk products
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
  int vec;          // every row of x, B and C starts on a 16-byte boundary (bf16 path)
};

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

template <int HD, int N>
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

  const float* x = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* Bg = static_cast<const float*>(p.Bm) + b * p.b_sb + g * p.b_sg;
  const float* Cg = static_cast<const float*>(p.Cm) + b * p.c_sb + g * p.c_sg;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  float* y = static_cast<float*>(p.y) + b * p.y_sb + h * p.y_sh;
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
      xs[q * HP + d] = q < valid ? x[(long long)(s0 + q) * p.x_ss + d] : 0.f;
    }
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int q = i / N, n = i % N;
      const bool ok = q < valid;
      Bs[q * NP + n] = ok ? Bg[(long long)(s0 + q) * p.b_ss + n] : 0.f;
      Cs[q * NP + n] = ok ? Cg[(long long)(s0 + q) * p.c_ss + n] : 0.f;
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
            float* yrow = y + (long long)(s0 + i) * p.y_ss;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              yrow[td + TD * cc] = acc[a][cc] + acc2[a][cc] * e;
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

template <int HD, int N>
int launch(const Params& p, cudaStream_t s) {
  constexpr size_t bytes = Smem<HD, N>::kBytes;
  static_assert(bytes <= 232448, "shared memory of one block on an H100");
  static bool attr_set = false;  // the attribute sticks to the function
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<HD, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  ssd_scan_kernel<HD, N><<<p.B * p.H, kThreads, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_n(const Params& p, int N, cudaStream_t s) {
  switch (N) {
    case 8: return launch<HD, 8>(p, s);
    case 16: return launch<HD, 16>(p, s);
    case 32: return launch<HD, 32>(p, s);
    case 64: return launch<HD, 64>(p, s);
    case 128: return launch<HD, 128>(p, s);
    default: return -1;
  }
}

int launch_hd(const Params& p, int hd, int N, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_n<16>(p, N, s);
    case 32: return launch_n<32>(p, N, s);
    case 64: return launch_n<64>(p, N, s);
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core chunk products (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

// Shared-memory layout of the bf16 kernel, in bytes.  Rows are padded by 16
// bytes so that the eight row addresses of an ldmatrix hit distinct banks.
template <int HD, int N>
struct Tc {
  static constexpr int D = HD < 32 ? HD : 32;    // state rows (head columns) of a block
  static constexpr int PARTS = HD / D;           // blocks per (batch, head)
  static constexpr int N16 = N < 16 ? 16 : N;    // depth of C.B^T and C.state^T (N 8 zero-padded)
  static constexpr int LDN = N16 + 8;            // row of C, B, state (bf16 elements)
  static constexpr int LDX = D + 8;              // row of x, w.x
  static constexpr int kC = 0;                   // [2][64][LDN]  C of this chunk and the next
  static constexpr int kB = kC + 2 * kChunk * LDN * 2;   // [2][64][LDN]
  static constexpr int kX = kB + 2 * kChunk * LDN * 2;   // [2][64][LDX]
  static constexpr int kWh = kX + 2 * kChunk * LDX * 2;  // [64][LDX] bf16(w.x)
  static constexpr int kWl = kWh + kChunk * LDX * 2;     // [64][LDX] bf16(w.x - hi)
  static constexpr int kSh = kWl + kChunk * LDX * 2;     // [D][LDN] bf16(state)
  static constexpr int kSl = kSh + D * LDN * 2;          // [D][LDN] bf16(state - hi)
  static constexpr int kDt = kSl + D * LDN * 2;          // [2][64] fp32
  static constexpr int kCs = kDt + 2 * kChunk * 4;       // [4 warps][64] fp32 cumsum(dt*A)
  static constexpr int kW = kCs + 4 * kChunk * 4;        // [4 warps][64] fp32 dt*exp(cs_last-cs)
  static constexpr int kBytes = kW + 4 * kChunk * 4;
  // the state update's (D x N) output, in m16n8 tiles spread over the 4 warps
  static constexpr int MT = D / 16, NT = N / 8, T = MT * NT, TPW = (T + 3) / 4;
};

// Chunk `c` of x (this block's D columns), B, C and dt into buffer `buf`;
// rows past the end are zeros.  16-byte cp.async when every row is 16-byte
// aligned, else element by element (synchronous).
template <int HD, int N>
__device__ __forceinline__ void load_chunk(const Params& p, uint8_t* smem, int buf, int s0,
                                           int valid, const __nv_bfloat16* xg,
                                           const __nv_bfloat16* Bg, const __nv_bfloat16* Cg,
                                           const float* dtg, bool vec) {
  using L = Tc<HD, N>;
  const int tid = threadIdx.x;
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem + L::kC) + buf * kChunk * L::LDN;
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + L::kB) + buf * kChunk * L::LDN;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L::kX) + buf * kChunk * L::LDX;
  float* dts = reinterpret_cast<float*>(smem + L::kDt) + buf * kChunk;
  if (vec) {
    constexpr int CPR = N / 8, CPX = L::D / 8;
    for (int i = tid; i < kChunk * CPR; i += 128) {
      const int q = i / CPR, cc = i % CPR;
      const bool ok = q < valid;
      const long long row = s0 + (ok ? q : 0);
      cp_async16(Cs + q * L::LDN + cc * 8, Cg + row * p.c_ss + cc * 8, ok);
      cp_async16(Bs + q * L::LDN + cc * 8, Bg + row * p.b_ss + cc * 8, ok);
    }
    for (int i = tid; i < kChunk * CPX; i += 128) {
      const int q = i / CPX, cc = i % CPX;
      const bool ok = q < valid;
      cp_async16(xs + q * L::LDX + cc * 8, xg + (long long)(s0 + (ok ? q : 0)) * p.x_ss + cc * 8,
                 ok);
    }
    if (tid < kChunk) {
      const bool ok = tid < valid;
      cp_async4(dts + tid, dtg + (long long)(s0 + (ok ? tid : 0)) * p.dt_ss, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < kChunk * N; i += 128) {
      const int q = i / N, n = i % N;
      const bool ok = q < valid;
      Cs[q * L::LDN + n] = ok ? Cg[(long long)(s0 + q) * p.c_ss + n] : zero;
      Bs[q * L::LDN + n] = ok ? Bg[(long long)(s0 + q) * p.b_ss + n] : zero;
    }
    for (int i = tid; i < kChunk * L::D; i += 128) {
      const int q = i / L::D, d = i % L::D;
      xs[q * L::LDX + d] = q < valid ? xg[(long long)(s0 + q) * p.x_ss + d] : zero;
    }
    if (tid < kChunk) dts[tid] = tid < valid ? dtg[(long long)(s0 + tid) * p.dt_ss] : 0.f;
  }
}

// A warp's state tiles (fp32 registers) as the hi / lo bf16 operands of the
// next chunk's C.state^T.
template <int TPW, int LDN>
__device__ __forceinline__ void put_state(const float (&st)[TPW][4], __nv_bfloat16* sth,
                                          __nv_bfloat16* stl, int sr_lo, int sr_hi, int nt0,
                                          int t4) {
#pragma unroll
  for (int k = 0; k < TPW; ++k) {
    const int col = 8 * (nt0 + k) + 2 * t4;
    uint32_t hi, lo;
    split2(st[k][0], st[k][1], hi, lo);
    *reinterpret_cast<uint32_t*>(sth + sr_lo * LDN + col) = hi;
    *reinterpret_cast<uint32_t*>(stl + sr_lo * LDN + col) = lo;
    split2(st[k][2], st[k][3], hi, lo);
    *reinterpret_cast<uint32_t*>(sth + sr_hi * LDN + col) = hi;
    *reinterpret_cast<uint32_t*>(stl + sr_hi * LDN + col) = lo;
  }
}

template <int HD, int N>
__global__ void __launch_bounds__(128) ssd_scan_tc(Params p) {
  using L = Tc<HD, N>;
  constexpr int D = L::D, LDN = L::LDN, LDX = L::LDX, KS = L::N16 / 16;
  constexpr int NT = L::NT, TPW = L::TPW;
  static_assert(D % 16 == 0 && N % 8 == 0, "head slice of 16 or 32, N a multiple of 8");

  extern __shared__ __align__(16) uint8_t smem_tc[];
  __nv_bfloat16* const Cs0 = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::kC);
  __nv_bfloat16* const Bs0 = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::kB);
  __nv_bfloat16* const xs0 = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::kX);
  __nv_bfloat16* const wxh = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::kWh);
  __nv_bfloat16* const wxl = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::kWl);
  __nv_bfloat16* const sth = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::kSh);
  __nv_bfloat16* const stl = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::kSl);
  const float* const dts0 = reinterpret_cast<const float*>(smem_tc + L::kDt);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float* const csw = reinterpret_cast<float*>(smem_tc + L::kCs) + warp * kChunk;  // this warp's
  float* const ww = reinterpret_cast<float*>(smem_tc + L::kW) + warp * kChunk;

  const int part = blockIdx.x % L::PARTS, bh = blockIdx.x / L::PARTS;
  const int b = bh / p.H, h = bh % p.H;
  const int grp = h / (p.H / p.G);
  const int d0 = part * D;
  const float A2 = p.A[h * p.a_s] * 1.4426950408889634f;   // dt*A in units of log2
  const __nv_bfloat16* xg =
      static_cast<const __nv_bfloat16*>(p.x) + b * p.x_sb + h * p.x_sh + d0;
  const __nv_bfloat16* Bg = static_cast<const __nv_bfloat16*>(p.Bm) + b * p.b_sb + grp * p.b_sg;
  const __nv_bfloat16* Cg = static_cast<const __nv_bfloat16*>(p.Cm) + b * p.c_sb + grp * p.c_sg;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  __nv_bfloat16* yg = static_cast<__nv_bfloat16*>(p.y) + b * p.y_sb + h * p.y_sh + d0;
  const long long state_off = (long long)bh * HD * N + (long long)d0 * N;

  // The state rows this warp updates: m16n8 tiles nt0 .. nt0 + TPW - 1 of m-tile mt.
  const bool owns = warp * TPW < L::T;
  const int mt = (warp * TPW) / NT, nt0 = (warp * TPW) % NT;
  const int sr_lo = 16 * mt + g, sr_hi = sr_lo + 8;      // state rows (within the slice)
  float st[TPW][4];
#pragma unroll
  for (int k = 0; k < TPW; ++k) {
    const int col = 8 * (nt0 + k) + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[k][e] = owns && p.h0 ? p.h0[state_off + (long long)(e & 2 ? sr_hi : sr_lo) * N + col +
                                     (e & 1)]
                              : 0.f;
  }

  // zero what no load writes (N 8: columns 8..15 of C, B and the state), then
  // the initial state as hi / lo operands
  if (N < 16) {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < 2 * kChunk * 8; i += 128) {
      Cs0[(i / 8) * LDN + 8 + i % 8] = zero;
      Bs0[(i / 8) * LDN + 8 + i % 8] = zero;
    }
    for (int i = tid; i < D * 8; i += 128) {
      sth[(i / 8) * LDN + 8 + i % 8] = zero;
      stl[(i / 8) * LDN + 8 + i % 8] = zero;
    }
  }
  if (owns) put_state<TPW, LDN>(st, sth, stl, sr_lo, sr_hi, nt0, t4);

  const int n_chunks = (p.S + kChunk - 1) / kChunk;
  load_chunk<HD, N>(p, smem_tc, 0, 0, min(kChunk, p.S), xg, Bg, Cg, dtg, p.vec);
  cp_async_commit();

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    const int s0 = c * kChunk;
    const int valid = min(kChunk, p.S - s0);
    cp_async_wait_all();
    __syncthreads();   // chunk c has landed everywhere; chunk c-1 is finished by every warp
    if (c + 1 < n_chunks) {
      const int s1 = s0 + kChunk;
      load_chunk<HD, N>(p, smem_tc, buf ^ 1, s1, min(kChunk, p.S - s1), xg, Bg, Cg, dtg, p.vec);
    }
    cp_async_commit();

    const __nv_bfloat16* Cs = Cs0 + buf * kChunk * LDN;
    const __nv_bfloat16* Bs = Bs0 + buf * kChunk * LDN;
    const __nv_bfloat16* xs = xs0 + buf * kChunk * LDX;
    const float* dts = dts0 + buf * kChunk;

    // ---- cs = cumsum(dt*A) (in units of log2) and w = dt*exp(cs_last - cs):
    // every warp its own copy
    {
      const float a0 = dts[2 * lane] * A2, a1 = dts[2 * lane + 1] * A2;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
      const float c0 = (lane ? prev : 0.f) + a0, c1 = incl;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      csw[2 * lane] = c0;
      csw[2 * lane + 1] = c1;
      ww[2 * lane] = dts[2 * lane] * ex2(last - c0);
      ww[2 * lane + 1] = dts[2 * lane + 1] * ex2(last - c1);
      __syncwarp();
    }

    // ---- CB = C.B^T on this warp's 16 rows i, columns j < 16 (warp + 1)
    uint32_t ca[KS][4];   // C's rows as A fragments, kept for C.state^T
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(ca[kk], Cs + (16 * warp + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8);
    float m[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) m[nt][0] = m[nt][1] = m[nt][2] = m[nt][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp > warp) break;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bb[4];
        ldsm_x4(bb, Bs + (16 * jp + (lane & 7) + (lane >> 4) * 8) * LDN + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma16816(m[2 * jp], ca[kk], bb[0], bb[1]);
        mma16816(m[2 * jp + 1], ca[kk], bb[2], bb[3]);
      }
    }
    // ---- M = CB o exp(cs_i - cs_j) o dt_j for j <= i (exp only there: above it may overflow)
    const int i_lo = 16 * warp + g, i_hi = i_lo + 8;
    const float cs_lo = csw[i_lo], cs_hi = csw[i_hi];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt > 2 * warp + 1) break;
      const bool diag = nt >= 2 * warp;   // tiles left of the diagonal need no test
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * nt + 2 * t4 + (e & 1);
        const int i = (e & 2) ? i_hi : i_lo;
        const float ci = (e & 2) ? cs_hi : cs_lo;
        m[nt][e] = !diag || j <= i ? m[nt][e] * ex2(ci - csw[j]) * dts[j] : 0.f;
      }
    }

    // ---- y = M.x (M split hi + lo) + (C.state^T, state split hi + lo) * exp(cs)
    float yi[D / 8][4], yx[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yi[nt][e] = yx[nt][e] = 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp > warp) break;
      uint32_t ah[4], al[4];
      split2(m[2 * jp][0], m[2 * jp][1], ah[0], al[0]);
      split2(m[2 * jp][2], m[2 * jp][3], ah[1], al[1]);
      split2(m[2 * jp + 1][0], m[2 * jp + 1][1], ah[2], al[2]);
      split2(m[2 * jp + 1][2], m[2 * jp + 1][3], ah[3], al[3]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, xs + (16 * jp + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX + 16 * np +
                          (lane >> 4) * 8);
        mma16816(yi[2 * np], ah, bb[0], bb[1]);
        mma16816(yi[2 * np], al, bb[0], bb[1]);
        mma16816(yi[2 * np + 1], ah, bb[2], bb[3]);
        mma16816(yi[2 * np + 1], al, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        const int off = (16 * np + (lane & 7) + (lane >> 4) * 8) * LDN + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, sth + off);
        ldsm_x4(bl, stl + off);
        mma16816(yx[2 * np], ca[kk], bh[0], bh[1]);
        mma16816(yx[2 * np], ca[kk], bl[0], bl[1]);
        mma16816(yx[2 * np + 1], ca[kk], bh[2], bh[3]);
        mma16816(yx[2 * np + 1], ca[kk], bl[2], bl[3]);
      }
    {
      const float e_lo = ex2(cs_lo), e_hi = ex2(cs_hi);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const int col = 8 * nt + 2 * t4;
        if (i_lo < valid)
          *reinterpret_cast<__nv_bfloat162*>(yg + (long long)(s0 + i_lo) * p.y_ss + col) =
              __floats2bfloat162_rn(yi[nt][0] + yx[nt][0] * e_lo, yi[nt][1] + yx[nt][1] * e_lo);
        if (i_hi < valid)
          *reinterpret_cast<__nv_bfloat162*>(yg + (long long)(s0 + i_hi) * p.y_ss + col) =
              __floats2bfloat162_rn(yi[nt][2] + yx[nt][2] * e_hi, yi[nt][3] + yx[nt][3] * e_hi);
      }
    }

    // ---- w.x as hi / lo operands of the state update
    for (int e = tid; e < kChunk * (D / 2); e += 128) {
      const int q = e / (D / 2), dp = 2 * (e % (D / 2));
      const float2 xf =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + q * LDX + dp));
      const float wq = ww[q];
      uint32_t hi, lo;
      split2(xf.x * wq, xf.y * wq, hi, lo);
      *reinterpret_cast<uint32_t*>(wxh + q * LDX + dp) = hi;
      *reinterpret_cast<uint32_t*>(wxl + q * LDX + dp) = lo;
    }
    __syncthreads();   // w.x complete; every warp is done reading the old state

    // ---- state = exp(cs_last) * state + (w.x)^T . B, in this warp's registers
    if (owns) {
      const float decay = ex2(csw[kChunk - 1]);
#pragma unroll
      for (int k = 0; k < TPW; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[k][e] *= decay;
#pragma unroll
      for (int kq = 0; kq < kChunk / 16; ++kq) {
        const int off = (16 * kq + (lane & 7) + (lane >> 4) * 8) * LDX + 16 * mt +
                        ((lane >> 3) & 1) * 8;
        uint32_t ah[4], al[4];
        ldsm_x4_t(ah, wxh + off);
        ldsm_x4_t(al, wxl + off);
#pragma unroll
        for (int k = 0; k < TPW; ++k) {
          uint32_t bb[2];
          ldsm_x2_t(bb, Bs + (16 * kq + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                            8 * (nt0 + k));
          mma16816(st[k], ah, bb[0], bb[1]);
          mma16816(st[k], al, bb[0], bb[1]);
        }
      }
      put_state<TPW, LDN>(st, sth, stl, sr_lo, sr_hi, nt0, t4);
    }
  }

  if (p.hT && owns) {
#pragma unroll
    for (int k = 0; k < TPW; ++k) {
      const int col = 8 * (nt0 + k) + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p.hT[state_off + (long long)(e & 2 ? sr_hi : sr_lo) * N + col + (e & 1)] = st[k][e];
    }
  }
}

template <int HD, int N>
int launch_tc(const Params& p, cudaStream_t s) {
  constexpr int bytes = Tc<HD, N>::kBytes;
  static_assert(bytes <= 232448, "shared memory of one block on an H100");
  static bool attr_set = false;  // the attribute sticks to the function
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_scan_tc<HD, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  ssd_scan_tc<HD, N><<<p.B * p.H * Tc<HD, N>::PARTS, 128, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tc_n(const Params& p, int N, cudaStream_t s) {
  switch (N) {
    case 8: return launch_tc<HD, 8>(p, s);
    case 16: return launch_tc<HD, 16>(p, s);
    case 32: return launch_tc<HD, 32>(p, s);
    case 64: return launch_tc<HD, 64>(p, s);
    case 128: return launch_tc<HD, 128>(p, s);
    default: return -1;
  }
}

int launch_tc_hd(const Params& p, int hd, int N, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_tc_n<16>(p, N, s);
    case 32: return launch_tc_n<32>(p, N, s);
    case 64: return launch_tc_n<64>(p, N, s);
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
  if ((long long)B * H * 2 > 2147483647LL) return -2;
  auto rows16 = [](const void* ptr, long long s0, long long s1, long long s2) {
    return (uintptr_t)ptr % 16 == 0 && s0 % 8 == 0 && s1 % 8 == 0 && s2 % 8 == 0;
  };
  const int vec = rows16(x, x_sb, x_ss, x_sh) && rows16(Bm, b_sb, b_ss, b_sg) &&
                  rows16(Cm, c_sb, c_ss, c_sg);
  Params p{x,    dt,   A,    Bm,   Cm,   h0,   y,    hT,   B,    S,    H,    G,    x_sb, x_ss,
           x_sh, dt_sb, dt_ss, dt_sh, a_s, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, y_sb, y_ss, y_sh,
           vec};
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_tc_hd(p, hd, N, s) : launch_hd(p, hd, N, s);
}
