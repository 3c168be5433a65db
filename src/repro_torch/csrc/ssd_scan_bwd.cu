// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), written by hand.
//
// Computes the gradient of the function of the Pallas TPU kernel `ssd_scan`
// (src/repro/kernels/ssd_scan.py, the pallas_call at line 94), which has no
// backward: the JAX model trains through `ssd_chunked`
// (src/repro/models/ssm.py:100), which JAX differentiates.  Given dy (the
// cotangent of y) and optionally dhT (that of the final state), it returns dx,
// ddt, dA, dB, dC and dh0.  Per head and per chunk of kChunk tokens, with
// cs = cumsum(dt * A) in the chunk, L[i][j] = exp(cs_i - cs_j) for j <= i (else
// 0), w_j = dt_j exp(cs_last - cs_j), h_c the state entering chunk c and dh the
// gradient of the state leaving it:
//
//   dx_j  = sum_i M_ij dy_i + w_j dh B_j                 M_ij = (C_i.B_j) L_ij dt_j
//   dB_j  = sum_i (dy_i.x_j) L_ij dt_j C_i + w_j dh^T x_j
//   dC_i  = sum_j (dy_i.x_j) L_ij dt_j B_j + exp(cs_i) h_c^T dy_i
//   ddt_j = sum_i (dy_i.x_j)(C_i.B_j) L_ij + exp(cs_last - cs_j) x_j^T dh B_j
//           + A * (reverse cumsum of dcs)_j,     dA = sum dt * (that reverse cumsum)
//   dh    <- exp(cs_last) dh + sum_i exp(cs_i) dy_i C_i^T   (dh0 after the first chunk)
//
// where dcs, the gradient through cs, gathers the terms of L, of exp(cs_i) in
// the chunk-to-chunk part of y and of exp(cs_last - cs_j) and exp(cs_last) in
// the state update.  dB and dC are summed over the H/G heads of a group.  The
// plain version, ssd_scan_bwd_plain in repro_torch/kernels/ssd_scan.py, is the
// same arithmetic in tensor ops.
//
// Design.  The chain of chunks is the one serial part: given the states h_c
// and the gradients dh, every chunk's gradient is independent of the others.
// So one call is four launches on the stream: the two chains, which write
// the state entering each chunk and the gradient of the state leaving it
// into scratch; the chunk kernel, every chunk in parallel; the sums of dB and
// dC over a group's heads (the last partials) and of dA over batch and
// chunks.  Row 0 of the chains repeats the forward kernel's chain: the
// backward takes only the forward's inputs, as the plain version does, and
// the forward, which serving runs, is left as it is.  No atomics: every sum
// is taken in one order, so two calls give the same bits.  A ragged last
// chunk is loaded with x = dy = B = C = 0 and dt = 0: the padded steps have
// decay 1, add nothing, and are never stored.  exp(cs_i - cs_j) is evaluated
// only for j <= i: above the diagonal it is positive and can overflow, and
// inf * 0 is NaN.
//
//   * bf16 (ssd_bwd_chains_tc, ssd_bwd_chunk_tc): every product on the tensor
//     cores as mma.sync.m16n8k16 (bf16 operands, fp32 accumulation;
//     csrc/mma_sync.cuh), operands staged in shared memory as bf16 and read
//     with ldmatrix.  x, dy, B and C are exact bf16 inputs; every other
//     operand (coef.u in the chains, the chunk states and their gradients,
//     M^T, Gd^T and Gd with their decay and dt factors) is split into hi =
//     bf16(v) and lo = bf16(v - hi) and multiplied twice, as the forward does:
//     one bf16 rounding of M moves dx by 2.5e-3 of its norm, one of dh by
//     7e-4-1e-3, against the 3e-4 the checks allow
//     (tests/test_torch_ssd_bwd_precision.py emulates the plan).  Sums are
//     fp32.  The decays are expf of natural-unit cumulative sums, as in the
//     plain version: the forward's 2^x of sums in units of log2 moves each by
//     about |cs| 2^-24 of itself, which flips the bf16 rounding of a dC
//     element of the sweep that lies 1e-6 of itself from a midpoint (4.5e-4 of
//     dC's norm, against the 3e-4 limit).  The chains: one block of 8 warps
//     per (batch*head, direction), the (hd x N) carry in fp32 registers as the
//     accumulator of its own update, as the forward kernel's chain; each
//     chunk's carry goes out as hi and lo bf16 planes (the same bytes as fp32,
//     the chunk kernel's operands as they are) through shared memory in
//     16-byte stores.  The chunk kernel: one block of 8 warps per (batch,
//     group, block of k heads, chunk), k the largest divisor of H/G up to 8 (8
//     at mamba2-1.3b's and zamba2-2.7b's shapes: 1024 blocks for mamba2's
//     training batch).  It computes B.C^T once and walks its k heads in order,
//     the next head's x, dy, dt and states arriving by cp.async while one
//     computes (216 KB of shared memory at hd 64, N 128: one block an SM; 255
//     registers a thread).  Warp w takes rows 16 (w % 4) .. + 15 of the chunk
//     and one column half of dx and of dB / dC; each product's coefficient
//     matrix is computed with the warp's rows as its rows (B.C^T and x.dy^T
//     for dx and dB, dy.x^T for dC), so an accumulator is the next product's A
//     fragment without a trip through shared memory.  dB and dC of the group
//     are summed over the k heads in fp32 registers, in head order, and
//     written once: the per-head scratch shrinks k-fold, to (B, S, G, H/(G k),
//     N).
//   * fp32 (ssd_bwd_chains, ssd_bwd_chunk): the first kernels, plain fp32 FMAs
//     out of shared memory (4 x 4 register tiles): the chains one block per
//     (batch*head, direction), the chunk kernel one block of 256 threads per
//     (batch*head, chunk) with x, dy, B, C, h_c and dh in shared memory as
//     fp32 (222,208 bytes at hd 64, N 128), dB and dC per head in fp32
//     scratch.  fp32 x, B and C are not exact in bf16; this path serves checks
//     and small fp32 models.
//   * both: ssd_bwd_reduce_bc sums the partial dB / dC of a group in order;
//     ssd_bwd_reduce_a sums dA over batch and chunks, in order.
//
// What bounds it on this card.  At mamba2-1.3b's training shape (B 4, S 2048,
// H 64, hd 64, N 128, G 1, bf16) the function reads x, dy, dt, B, C and writes
// dx, ddt, dB, dC: about 214 MB, 0.064 ms at 3.35 TB/s; its products are about
// 60 GFLOP, 0.061 ms at the bf16 tensor-core peak.  So the bound is bytes, by
// a little.  The design adds its scratch: the chunk states and their
// gradients, 537 MB written by the chains and read by the chunk kernel
// (about 0.32 ms at the memory rate), and the split operands double the
// tensor-core work.
//
// Plain C interface (no PyTorch headers): the wrapper in
// repro_torch/kernels/ssd_scan.py passes raw pointers, element strides, the
// scratch it allocated and the stream, and raises on a non-zero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kChunk = 64;     // tokens per chunk, as the forward kernel
constexpr int kThreads = 256;
static_assert(kChunk == 64 && kThreads == 256,
              "the cumulative sum is one warp of two steps a lane; the C.B^T tile map is 16 x 16");

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* h0;      // (B, H, hd, N) fp32 contiguous, or null for zeros
  const void* dy;
  const float* dhT;     // (B, H, hd, N) fp32 contiguous, or null for zeros
  void* dx;             // (B, S, H, hd) contiguous, x's dtype
  float* ddt;           // (B, S, H) contiguous
  float* dA;            // (H,)
  void* dB;             // (B, S, G, N) contiguous, x's dtype
  void* dC;
  float* dh0;           // (B, H, hd, N), or null to skip
  // scratch: the state entering each chunk and the gradient of the state
  // leaving it, (B, H, nc, hd, N) fp32, or in bf16 calls (B, H, nc, 2, hd, N)
  // bf16 (hi and lo planes, the same bytes)
  float* states;
  float* dstates;
  float* dBh;           // scratch: dB of each head (B, S, H, N), or in bf16 calls of
  float* dCh;           //   each block of k heads (B, S, G, H / (G k), N); fp32
  float* dApart;        // scratch (B, nc, H): dA of each (batch, chunk, head)
  int B, S, H, G;
  int kheads;           // bf16: heads of one group a chunk block takes (k)
  int vec;              // bf16: every row of x, B, C and dy starts on a 16-byte boundary
  // strides in elements (the last dimension of x, B, C, dy has stride 1)
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long a_s;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long dy_sb, dy_ss, dy_sh;
};

__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// cs = cumsum(dt * A) over the chunk by one warp, two steps a lane; returns
// cs_last (every lane) and leaves cs_{2 lane}, cs_{2 lane + 1} in c0, c1.
__device__ __forceinline__ float chunk_cumsum(const float* dts, float A, int lane, float& c0,
                                              float& c1) {
  const float a0 = dts[2 * lane] * A;
  const float a1 = dts[2 * lane + 1] * A;
  float incl = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
  c0 = (lane ? prev : 0.f) + a0;
  c1 = incl;
  return __shfl_sync(0xffffffffu, incl, 31);
}

// ---------------------------------------------------------------------------
// 1. the two chains: states entering each chunk (forward), their gradients (reverse)
// ---------------------------------------------------------------------------

template <int HD, int N>
struct ChainSmem {
  static constexpr int HP = HD + 4, NP = N + 4;
  static constexpr int kFloats = kChunk * HP + kChunk * NP + 3 * kChunk;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <int HD, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chains(Params p) {
  using L = ChainSmem<HD, N>;
  constexpr int HP = L::HP, NP = L::NP;
  constexpr int TN = N / 4, TILES = (HD / 4) * TN, TPT = (TILES + kThreads - 1) / kThreads;
  static_assert(HD % 4 == 0 && N % 4 == 0, "hd and N must be multiples of 4");

  extern __shared__ __align__(16) float smem[];
  float* us = smem;                 // [Q][HP] x (forward) or dy (reverse), times coef
  float* vs = us + kChunk * HP;     // [Q][NP] B (forward) or C (reverse)
  float* coef = vs + kChunk * NP;   // [Q] w_q (forward) or exp(cs_q) (reverse)
  float* dts = coef + kChunk;       // [Q]
  float* misc = dts + kChunk;       // [0]: exp(cs_last)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int g = h / (p.H / p.G);
  const bool rev = blockIdx.y == 1;
  const float A = p.A[h * p.a_s];
  const float* u = rev ? static_cast<const float*>(p.dy) + b * p.dy_sb + h * p.dy_sh
                   : static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const long long u_ss = rev ? p.dy_ss : p.x_ss;
  const float* v = rev ? static_cast<const float*>(p.Cm) + b * p.c_sb + g * p.c_sg
                   : static_cast<const float*>(p.Bm) + b * p.b_sb + g * p.b_sg;
  const long long v_ss = rev ? p.c_ss : p.b_ss;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  const int nc = (p.S + kChunk - 1) / kChunk;
  const long long off = (long long)bh * HD * N;
  float* out = (rev ? p.dstates : p.states) + off * nc;
  const float* init = rev ? p.dhT : p.h0;

  // the carry: this thread's 4 x 4 tiles of the (hd x N) state, in registers
  float st[TPT][4][4];
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    const int t = tid + kThreads * k;
    const int td = t / TN, tn = t % TN;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[k][a][e] = (t < TILES && init) ? init[off + (4 * td + a) * N + 4 * tn + e] : 0.f;
  }

  for (int step = 0; step < nc; ++step) {
    const int c = rev ? nc - 1 - step : step;
    const int s0 = c * kChunk;
    const int valid = min(kChunk, p.S - s0);

    // the carry as it enters chunk c (forward) or leaves it (reverse)
    float* o = out + (long long)c * HD * N;
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int t = tid + kThreads * k;
      if (t < TILES) {
        const int td = t / TN, tn = t % TN;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(&o[(4 * td + a) * N + 4 * tn]) =
              make_float4(st[k][a][0], st[k][a][1], st[k][a][2], st[k][a][3]);
      }
    }

    for (int i = tid; i < kChunk * HD; i += kThreads) {
      const int q = i / HD, d = i % HD;
      us[q * HP + d] = q < valid ? u[(long long)(s0 + q) * u_ss + d] : 0.f;
    }
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int q = i / N, n = i % N;
      vs[q * NP + n] = q < valid ? v[(long long)(s0 + q) * v_ss + n] : 0.f;
    }
    if (tid < kChunk) dts[tid] = tid < valid ? dt[(long long)(s0 + tid) * p.dt_ss] : 0.f;
    __syncthreads();

    if (tid < 32) {
      float c0, c1;
      const float last = chunk_cumsum(dts, A, tid, c0, c1);
      if (rev) {
        coef[2 * tid] = expf(c0);
        coef[2 * tid + 1] = expf(c1);
      } else {
        coef[2 * tid] = dts[2 * tid] * expf(last - c0);
        coef[2 * tid + 1] = dts[2 * tid + 1] * expf(last - c1);
      }
      if (tid == 0) misc[0] = expf(last);
    }
    __syncthreads();
    for (int i = tid; i < kChunk * HD; i += kThreads) {
      const int q = i / HD, d = i % HD;
      us[q * HP + d] *= coef[q];
    }
    __syncthreads();

    // carry = exp(cs_last) * carry + sum_q (coef_q u_q) v_q^T
    const float decay = misc[0];
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int t = tid + kThreads * k;
      if (t < TILES) {
        const int td = t / TN, tn = t % TN;
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
        for (int q = 0; q < valid; ++q) {
          const float4 uv = ld4(&us[q * HP + 4 * td]);
          const float4 vv = ld4(&vs[q * NP + 4 * tn]);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float ua = comp(uv, a);
            acc[a][0] = fmaf(ua, vv.x, acc[a][0]);
            acc[a][1] = fmaf(ua, vv.y, acc[a][1]);
            acc[a][2] = fmaf(ua, vv.z, acc[a][2]);
            acc[a][3] = fmaf(ua, vv.w, acc[a][3]);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[k][a][e] = fmaf(st[k][a][e], decay, acc[a][e]);
      }
    }
    __syncthreads();   // the next chunk overwrites us, vs, coef
  }

  if (rev && p.dh0) {
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int t = tid + kThreads * k;
      if (t < TILES) {
        const int td = t / TN, tn = t % TN;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(&p.dh0[off + (4 * td + a) * N + 4 * tn]) =
              make_float4(st[k][a][0], st[k][a][1], st[k][a][2], st[k][a][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. one chunk's gradient, every chunk in parallel
// ---------------------------------------------------------------------------

template <int HD, int N>
struct ChunkSmem {
  static constexpr int HP = HD + 4;        // padded row of x, dy
  static constexpr int NP = N + 4;         // padded row of B, C, h_c, dh
  static constexpr int QP = kChunk + 4;    // padded row of M, Gd
  static constexpr int PU = HD / 4 + 1;    // row of the dx tiles' partials of x.(dh B)
  static constexpr int PI = N / 4 + 1;     // row of the dC tiles' partials of C.dC_inter
  static constexpr int kPart = 3 * kChunk * 17;
  static_assert(kChunk * PU + kChunk * PI <= kPart, "partials of dx and dC share one region");
  static constexpr int kVec = 13;          // vectors of kChunk floats (see the kernel)
  static constexpr int kFloats = 2 * kChunk * HP + 2 * kChunk * NP + 2 * HD * NP +
                                 2 * kChunk * QP + kPart + kVec * kChunk + kThreads;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <int HD, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk(Params p) {
  using L = ChunkSmem<HD, N>;
  constexpr int Q = kChunk, HP = L::HP, NP = L::NP, QP = L::QP, PU = L::PU, PI = L::PI;
  constexpr int TC = HD / 4, TCN = N / 4;

  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [Q][HP]
  float* dys = xs + Q * HP;       // [Q][HP]
  float* Bs = dys + Q * HP;       // [Q][NP]
  float* Cs = Bs + Q * NP;        // [Q][NP]
  float* hs = Cs + Q * NP;        // [HD][NP] h_c, the state entering the chunk
  float* gs = hs + HD * NP;       // [HD][NP] dh, the gradient of the state leaving it
  float* Ms = gs + HD * NP;       // [Q][QP] M[i][j] = (C_i.B_j) L_ij dt_j
  float* Gs = Ms + Q * QP;        // [Q][QP] Gd[i][j] = (dy_i.x_j) L_ij dt_j
  float* part = Gs + Q * QP;      // partial sums (three [Q][17], later [Q][PU] + [Q][PI])
  float* vec = part + L::kPart;
  float* dts = vec;               // [Q] dt
  float* cs = dts + Q;            // [Q] cumsum(dt*A)
  float* ecs = cs + Q;            // [Q] exp(cs)
  float* dec = ecs + Q;           // [Q] exp(cs_last - cs)
  float* w = dec + Q;             // [Q] dt * exp(cs_last - cs)
  float* rowP = w + Q;            // [Q] sum_j P_ij, P = (dy_i.x_j) M_ij
  float* colP = rowP + Q;         // [Q] sum_i P_ij
  float* colG = colP + Q;         // [Q] sum_i (dy_i.x_j)(C_i.B_j) L_ij
  float* Ux = colG + Q;           // [Q] x_j . (dh B_j)
  float* dcs = Ux + Q;            // [Q]
  float* da = dcs + Q;            // [Q] reverse cumsum of dcs
  float* misc = da + Q;           // [0]: cs_last
  float* red = vec + L::kVec * Q; // [kThreads] partials of <dh, h_c>

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int g = h / (p.H / p.G);
  const int nc = gridDim.y;
  const int s0 = c * Q;
  const int valid = min(Q, p.S - s0);
  const float A = p.A[h * p.a_s];

  // ---- load the chunk; rows past the end are zeros (dt = 0: decay 1, no update)
  {
    const float* x = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
    const float* dy = static_cast<const float*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
    const float* Bg = static_cast<const float*>(p.Bm) + b * p.b_sb + g * p.b_sg;
    const float* Cg = static_cast<const float*>(p.Cm) + b * p.c_sb + g * p.c_sg;
    for (int i = tid; i < Q * HD; i += kThreads) {
      const int q = i / HD, d = i % HD;
      const bool ok = q < valid;
      xs[q * HP + d] = ok ? x[(long long)(s0 + q) * p.x_ss + d] : 0.f;
      dys[q * HP + d] = ok ? dy[(long long)(s0 + q) * p.dy_ss + d] : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int q = i / N, n = i % N;
      const bool ok = q < valid;
      Bs[q * NP + n] = ok ? Bg[(long long)(s0 + q) * p.b_ss + n] : 0.f;
      Cs[q * NP + n] = ok ? Cg[(long long)(s0 + q) * p.c_ss + n] : 0.f;
    }
    const long long so = ((long long)bh * nc + c) * HD * N;
    for (int i = tid; i < HD * N / 4; i += kThreads) {
      const int d = (4 * i) / N, n = (4 * i) % N;
      *reinterpret_cast<float4*>(&hs[d * NP + n]) = ld4(&p.states[so + 4 * i]);
      *reinterpret_cast<float4*>(&gs[d * NP + n]) = ld4(&p.dstates[so + 4 * i]);
    }
    if (tid < Q)
      dts[tid] = tid < valid ? p.dt[b * p.dt_sb + h * p.dt_sh + (long long)(s0 + tid) * p.dt_ss]
                             : 0.f;
  }
  __syncthreads();

  if (tid < 32) {
    float c0, c1;
    const float last = chunk_cumsum(dts, A, tid, c0, c1);
    const int q0 = 2 * tid, q1 = q0 + 1;
    cs[q0] = c0;
    cs[q1] = c1;
    ecs[q0] = expf(c0);
    ecs[q1] = expf(c1);
    dec[q0] = expf(last - c0);
    dec[q1] = expf(last - c1);
    w[q0] = dts[q0] * dec[q0];
    w[q1] = dts[q1] * dec[q1];
    if (tid == 0) misc[0] = last;
  }
  __syncthreads();

  // ---- C.B^T and dy.x^T on rows i = 4ti..4ti+3, columns j = tj + 16k; then
  // M, Gd, and the partial row / column sums of P and of the ddt term
  {
    const int ti = tid / 16, tj = tid % 16;
    float cb[4][4], dd[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) cb[a][k] = dd[a][k] = 0.f;
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
        for (int k = 0; k < 4; ++k) cb[a][k] = dot4(cv[a], bv[k], cb[a][k]);
    }
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 yv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) yv[a] = ld4(&dys[(4 * ti + a) * HP + d]);
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = ld4(&xs[(tj + 16 * k) * HP + d]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) dd[a][k] = dot4(yv[a], xv[k], dd[a][k]);
    }
    float rp[4] = {0.f, 0.f, 0.f, 0.f}, cp[4] = {0.f, 0.f, 0.f, 0.f},
          cg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * ti + a;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = tj + 16 * k;
        float m = 0.f, gd = 0.f, gm = 0.f;
        if (j <= i) {   // only below the diagonal: above it exp() may overflow
          const float l = expf(cs[i] - cs[j]);
          m = cb[a][k] * l * dts[j];
          gd = dd[a][k] * l * dts[j];
          gm = cb[a][k] * dd[a][k] * l;
        }
        Ms[i * QP + j] = m;
        Gs[i * QP + j] = gd;
        const float pp = gm * dts[j];
        rp[a] += pp;
        cp[k] += pp;
        cg[k] += gm;
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) part[(4 * ti + a) * 17 + tj] = rp[a];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      part[Q * 17 + (tj + 16 * k) * 17 + ti] = cp[k];
      part[2 * Q * 17 + (tj + 16 * k) * 17 + ti] = cg[k];
    }
  }
  __syncthreads();
  if (tid < 3 * Q) {
    const int which = tid / Q, q = tid % Q;
    const float* src = part + which * Q * 17 + q * 17;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) s += src[t];
    (which == 0 ? rowP : which == 1 ? colP : colG)[q] = s;
  }
  __syncthreads();   // the partials' region is free again

  float* partU = part;            // [Q][PU]
  float* partI = part + Q * PU;   // [Q][PI]
  const long long row0 = (long long)b * p.S + s0;   // (b, s0) as a row of (B*S, H, ...)

  // ---- dx_j = sum_i M_ij dy_i + w_j (dh B_j); rows j = 4tr.., columns tc + TC*cc
  for (int t = tid; t < (Q / 4) * TC; t += kThreads) {
    const int tr = t / TC, tc = t % TC;
    float acc[4][4], acc2[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[a][cc] = acc2[a][cc] = 0.f;
    for (int i = 4 * tr; i < Q; ++i) {   // M_ij = 0 for i < j
      const float4 m = ld4(&Ms[i * QP + 4 * tr]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float yv = dys[i * HP + tc + TC * cc];
        acc[0][cc] = fmaf(m.x, yv, acc[0][cc]);
        acc[1][cc] = fmaf(m.y, yv, acc[1][cc]);
        acc[2][cc] = fmaf(m.z, yv, acc[2][cc]);
        acc[3][cc] = fmaf(m.w, yv, acc[3][cc]);
      }
    }
#pragma unroll 4
    for (int n = 0; n < N; n += 4) {
      float4 bv[4], gv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) bv[a] = ld4(&Bs[(4 * tr + a) * NP + n]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) gv[cc] = ld4(&gs[(tc + TC * cc) * NP + n]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc2[a][cc] = dot4(bv[a], gv[cc], acc2[a][cc]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = 4 * tr + a;
      float ux = 0.f;
      float* out = static_cast<float*>(p.dx) + ((row0 + j) * p.H + h) * HD;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int d = tc + TC * cc;
        ux = fmaf(xs[j * HP + d], acc2[a][cc], ux);
        if (j < valid) out[d] = fmaf(w[j], acc2[a][cc], acc[a][cc]);
      }
      partU[j * PU + tc] = ux;
    }
  }

  // ---- dB_j = sum_i Gd_ij C_i + w_j (dh^T x_j), per head; columns tc + TCN*cc
  for (int t = tid; t < (Q / 4) * TCN; t += kThreads) {
    const int tr = t / TCN, tc = t % TCN;
    float acc[4][4], acc2[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[a][cc] = acc2[a][cc] = 0.f;
    for (int i = 4 * tr; i < Q; ++i) {   // Gd_ij = 0 for i < j
      const float4 m = ld4(&Gs[i * QP + 4 * tr]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float cv = Cs[i * NP + tc + TCN * cc];
        acc[0][cc] = fmaf(m.x, cv, acc[0][cc]);
        acc[1][cc] = fmaf(m.y, cv, acc[1][cc]);
        acc[2][cc] = fmaf(m.z, cv, acc[2][cc]);
        acc[3][cc] = fmaf(m.w, cv, acc[3][cc]);
      }
    }
    for (int d = 0; d < HD; d += 4) {
      float4 xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = ld4(&xs[(4 * tr + a) * HP + d]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float gv[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) gv[cc] = gs[(d + e) * NP + tc + TCN * cc];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float xa = comp(xv[a], e);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc2[a][cc] = fmaf(xa, gv[cc], acc2[a][cc]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = 4 * tr + a;
      if (j < valid) {
        float* out = p.dBh + ((row0 + j) * p.H + h) * N;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          out[tc + TCN * cc] = fmaf(w[j], acc2[a][cc], acc[a][cc]);
      }
    }
  }

  // ---- dC_i = sum_j Gd_ij B_j + exp(cs_i) (h_c^T dy_i), per head; and the
  // partials of C_i . exp(cs_i)(h_c^T dy_i), the gradient of cs_i through y
  for (int t = tid; t < (Q / 4) * TCN; t += kThreads) {
    const int tr = t / TCN, tc = t % TCN;
    float acc[4][4], acc2[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[a][cc] = acc2[a][cc] = 0.f;
    for (int j = 0; j < 4 * tr + 4; ++j) {   // Gd_ij = 0 for j > i
      float gv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) gv[a] = Gs[(4 * tr + a) * QP + j];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) bv[cc] = Bs[j * NP + tc + TCN * cc];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[a][cc] = fmaf(gv[a], bv[cc], acc[a][cc]);
    }
    for (int d = 0; d < HD; d += 4) {
      float4 yv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) yv[a] = ld4(&dys[(4 * tr + a) * HP + d]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float hv[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) hv[cc] = hs[(d + e) * NP + tc + TCN * cc];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float ya = comp(yv[a], e);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc2[a][cc] = fmaf(ya, hv[cc], acc2[a][cc]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * tr + a;
      const float e = ecs[i];
      float s = 0.f;
      float* out = p.dCh + ((row0 + i) * p.H + h) * N;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int n = tc + TCN * cc;
        const float ci = e * acc2[a][cc];
        s = fmaf(Cs[i * NP + n], ci, s);
        if (i < valid) out[n] = acc[a][cc] + ci;
      }
      partI[i * PI + tc] = s;
    }
  }

  // ---- <dh, h_c>, this thread's share
  {
    float s = 0.f;
    for (int e = tid; e < HD * N; e += kThreads) {
      const int d = e / N, n = e % N;
      s = fmaf(gs[d * NP + n], hs[d * NP + n], s);
    }
    red[tid] = s;
  }
  __syncthreads();

  // ---- dcs, its reverse cumulative sum, ddt and this chunk's share of dA
  if (tid < Q) {
    const int q = tid;
    float ux = 0.f, in = 0.f;
#pragma unroll
    for (int t = 0; t < TC; ++t) ux += partU[q * PU + t];
#pragma unroll
    for (int t = 0; t < TCN; ++t) in += partI[q * PI + t];
    Ux[q] = ux;
    dcs[q] = rowP[q] - colP[q] + in - w[q] * ux;
  }
  __syncthreads();
  if (tid == 0) {
    float hd = 0.f, su = 0.f;
    for (int t = 0; t < kThreads; ++t) hd += red[t];
    for (int q = 0; q < Q; ++q) su = fmaf(w[q], Ux[q], su);
    // through exp(cs_last): the state's decay and every w_j
    dcs[Q - 1] += expf(misc[0]) * hd + su;
    float run = 0.f, sa = 0.f;
    for (int q = Q - 1; q >= 0; --q) {
      run += dcs[q];
      da[q] = run;
      sa = fmaf(dts[q], run, sa);
    }
    p.dApart[((long long)b * nc + c) * p.H + h] = sa;
  }
  __syncthreads();
  if (tid < valid)
    p.ddt[(row0 + tid) * p.H + h] = colG[tid] + dec[tid] * Ux[tid] + A * da[tid];
}

// ---------------------------------------------------------------------------
// 3, 4. the sums over a group's heads (dB, dC) and over batch and chunks (dA)
// ---------------------------------------------------------------------------

// dB and dC: the partials of each group (per head in fp32 calls, per block of
// k heads in bf16 calls: (B, S, G, nkb, N) either way) summed in order, cast to
// the inputs' dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce_bc(Params p, int N, int nkb) {
  const long long per = (long long)p.B * p.S * p.G * N;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= 2 * per) return;
  const bool is_c = idx >= per;
  const long long e = is_c ? idx - per : idx;
  const float* src = (is_c ? p.dCh : p.dBh) + (e / N) * nkb * N + e % N;
  float s = 0.f;
  for (int r = 0; r < nkb; ++r) s += src[(long long)r * N];
  stf(static_cast<T*>(is_c ? p.dC : p.dB) + e, s);
}

__global__ void ssd_bwd_reduce_a(Params p, int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= p.H) return;
  float s = 0.f;
  for (int b = 0; b < p.B; ++b)
    for (int c = 0; c < nc; ++c) s += p.dApart[((long long)b * nc + c) * p.H + h];
  p.dA[h] = s;
}

template <int HD, int N>
int launch(const Params& p, cudaStream_t s) {
  constexpr size_t chain_bytes = ChainSmem<HD, N>::kBytes;
  constexpr size_t chunk_bytes = ChunkSmem<HD, N>::kBytes;
  static_assert(chunk_bytes <= 232448 && chain_bytes <= 232448,
                "shared memory of one block on an H100");
  static bool attr_set = false;  // the attribute sticks to the function
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_bwd_chains<HD, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)chain_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(ssd_bwd_chunk<HD, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)chunk_bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int nc = (p.S + kChunk - 1) / kChunk;
  ssd_bwd_chains<HD, N><<<dim3(p.B * p.H, 2), kThreads, chain_bytes, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_chunk<HD, N><<<dim3(p.B * p.H, nc), kThreads, chunk_bytes, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_bc = 2LL * p.B * p.S * p.G * N;
  ssd_bwd_reduce_bc<float><<<(unsigned)((n_bc + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      p, N, p.H / p.G);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_reduce_a<<<(p.H + 127) / 128, 128, 0, s>>>(p, nc);
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
// bf16: the chains and the chunk gradients on the tensor cores
// ---------------------------------------------------------------------------

// Layout of the bf16 chains kernel's shared memory, in bytes.  Rows are
// padded by 16 bytes so that the eight row addresses of an ldmatrix (and the
// eight rows a warp's fragment stores touch) hit distinct banks.
template <int HD, int N>
struct TcChain {
  static constexpr int LDN = N + 8;             // row of v (B or C), and of the staged carry
  static constexpr int LDU = HD + 8;            // row of u (x or dy)
  static constexpr int kV = 0;                             // [2][64][LDN] this chunk and the next
  static constexpr int kU = kV + 2 * kChunk * LDN * 2;     // [2][64][LDU]
  static constexpr int kUh = kU + 2 * kChunk * LDU * 2;    // [64][LDU] bf16(coef.u)
  static constexpr int kUl = kUh + kChunk * LDU * 2;       // [64][LDU] bf16(coef.u - hi)
  static constexpr int kSt = kUl + kChunk * LDU * 2;       // [2][HD][LDN] the carry, hi and lo
  static constexpr int kDt = kSt + 2 * HD * LDN * 2;       // [2][64] fp32
  static constexpr int kCoef = kDt + 2 * kChunk * 4;       // [8 warps][64] fp32
  static constexpr int kBytes = kCoef + 8 * kChunk * 4;
  // the carry's (hd x N) tiles of m16n8, spread over the 8 warps
  static constexpr int MT = HD / 16, NT = N / 8, T = MT * NT, TPW = (T + 7) / 8;
};

// Chunk `c` of u, v and dt into buffer `buf`; rows past the end are zeros.
// 16-byte cp.async when every row is 16-byte aligned, else element by element
// (synchronous).
template <int HD, int N>
__device__ __forceinline__ void chain_load(const Params& p, uint8_t* smem, int buf, int c,
                                           const __nv_bfloat16* ug, long long u_ss,
                                           const __nv_bfloat16* vg, long long v_ss,
                                           const float* dtg) {
  using L = TcChain<HD, N>;
  const int tid = threadIdx.x;
  const int s0 = c * kChunk, valid = min(kChunk, p.S - s0);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::kV) + buf * kChunk * L::LDN;
  __nv_bfloat16* us = reinterpret_cast<__nv_bfloat16*>(smem + L::kU) + buf * kChunk * L::LDU;
  float* dts = reinterpret_cast<float*>(smem + L::kDt) + buf * kChunk;
  if (p.vec) {
    constexpr int CPV = N / 8, CPU = HD / 8;
    for (int i = tid; i < kChunk * CPV; i += 256) {
      const int q = i / CPV, cc = i % CPV;
      const bool ok = q < valid;
      cp_async16(vs + q * L::LDN + cc * 8, vg + (long long)(s0 + (ok ? q : 0)) * v_ss + cc * 8, ok);
    }
    for (int i = tid; i < kChunk * CPU; i += 256) {
      const int q = i / CPU, cc = i % CPU;
      const bool ok = q < valid;
      cp_async16(us + q * L::LDU + cc * 8, ug + (long long)(s0 + (ok ? q : 0)) * u_ss + cc * 8, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < kChunk * N; i += 256) {
      const int q = i / N, n = i % N;
      vs[q * L::LDN + n] = q < valid ? vg[(long long)(s0 + q) * v_ss + n] : zero;
    }
    for (int i = tid; i < kChunk * HD; i += 256) {
      const int q = i / HD, d = i % HD;
      us[q * L::LDU + d] = q < valid ? ug[(long long)(s0 + q) * u_ss + d] : zero;
    }
  }
  if (tid < kChunk) {
    const bool ok = tid < valid;
    cp_async4(dts + tid, dtg + (long long)(s0 + (ok ? tid : 0)) * p.dt_ss, ok);
  }
}

// A warp's carry tiles (fp32 registers) as bf16 hi and lo planes in shared
// memory, for the copy out.
template <int TPW, int LDN>
__device__ __forceinline__ void stage_carry(const float (&st)[TPW][4], __nv_bfloat16* sth,
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

// The two chains, as the forward kernel's state chain: blocks (batch * head,
// 2), 256 threads, the (hd x N) carry of one head a block, in fp32 registers
// as the accumulator of
//   carry = exp(cs_last) carry + sum_q (coef_q u_q) v_q^T
// on the tensor cores, coef.u split into bf16 hi + lo, v exact.  Row 0 (the
// forward): u = x, v = B, coef = dt exp(cs_last - cs), from h0 (or zeros);
// it writes the state entering each chunk.  Row 1 (the reverse): u = dy, v =
// C, coef = exp(cs), from dhT (or zeros), last chunk first; it writes the
// gradient of the state leaving each chunk, then dh0.  A chunk's carry is
// written as two bf16 planes, hi and lo, (B, H, nc, 2, hd, N): the same bytes
// as fp32, and the chunk kernel's operands as they are.  It goes out through
// shared memory in 16-byte stores, contiguous across the block: a warp's
// fragments, written straight from registers, are 16-byte pieces of eight
// rows a store, which cost the chains more than all their other work
// (tools/kernel_ablations.py, `fragment_stores`).
template <int HD, int N>
__global__ void __launch_bounds__(256, 2) ssd_bwd_chains_tc(Params p) {
  using L = TcChain<HD, N>;
  constexpr int LDN = L::LDN, LDU = L::LDU, NT = L::NT, TPW = L::TPW;
  static_assert(HD % 16 == 0 && N % 8 == 0, "hd a multiple of 16, N of 8");

  extern __shared__ __align__(16) uint8_t smem_ch[];
  const __nv_bfloat16* const vs0 = reinterpret_cast<const __nv_bfloat16*>(smem_ch + L::kV);
  const __nv_bfloat16* const us0 = reinterpret_cast<const __nv_bfloat16*>(smem_ch + L::kU);
  __nv_bfloat16* const uh = reinterpret_cast<__nv_bfloat16*>(smem_ch + L::kUh);
  __nv_bfloat16* const ul = reinterpret_cast<__nv_bfloat16*>(smem_ch + L::kUl);
  __nv_bfloat16* const sth = reinterpret_cast<__nv_bfloat16*>(smem_ch + L::kSt);
  __nv_bfloat16* const stl = sth + HD * LDN;
  const float* const dts0 = reinterpret_cast<const float*>(smem_ch + L::kDt);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float* const coef = reinterpret_cast<float*>(smem_ch + L::kCoef) + warp * kChunk;  // this warp's

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int grp = h / (p.H / p.G);
  const bool reverse = blockIdx.y == 1;
  const float A = p.A[h * p.a_s];
  const __nv_bfloat16* ug =
      reverse ? static_cast<const __nv_bfloat16*>(p.dy) + b * p.dy_sb + h * p.dy_sh
              : static_cast<const __nv_bfloat16*>(p.x) + b * p.x_sb + h * p.x_sh;
  const long long u_ss = reverse ? p.dy_ss : p.x_ss;
  const __nv_bfloat16* vg =
      reverse ? static_cast<const __nv_bfloat16*>(p.Cm) + b * p.c_sb + grp * p.c_sg
              : static_cast<const __nv_bfloat16*>(p.Bm) + b * p.b_sb + grp * p.b_sg;
  const long long v_ss = reverse ? p.c_ss : p.b_ss;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const int nc = (p.S + kChunk - 1) / kChunk;
  __nv_bfloat16* const out = reinterpret_cast<__nv_bfloat16*>(reverse ? p.dstates : p.states) +
                             (long long)bh * nc * 2 * HD * N;
  const float* init = reverse ? p.dhT : p.h0;
  const long long st_off = (long long)bh * HD * N;

  // The carry rows this warp owns: m16n8 tiles nt0 .. nt0 + TPW - 1 of m-tile mt.
  const bool owns = warp * TPW < L::T;
  const int mt = (warp * TPW) / NT, nt0 = (warp * TPW) % NT;
  const int sr_lo = 16 * mt + g, sr_hi = sr_lo + 8;
  float st[TPW][4];
#pragma unroll
  for (int k = 0; k < TPW; ++k) {
    const int col = 8 * (nt0 + k) + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[k][e] = owns && init
                     ? init[st_off + (long long)(e & 2 ? sr_hi : sr_lo) * N + col + (e & 1)]
                     : 0.f;
  }
  if (owns) stage_carry<TPW, LDN>(st, sth, stl, sr_lo, sr_hi, nt0, t4);

  chain_load<HD, N>(p, smem_ch, 0, reverse ? nc - 1 : 0, ug, u_ss, vg, v_ss, dtg);
  cp_async_commit();

  for (int step = 0; step < nc; ++step) {
    const int c = reverse ? nc - 1 - step : step;
    const int buf = step & 1;
    cp_async_wait_all();
    __syncthreads();   // chunk c and the staged carry are in; the previous step is done everywhere
    if (step + 1 < nc)
      chain_load<HD, N>(p, smem_ch, buf ^ 1, reverse ? c - 1 : c + 1, ug, u_ss, vg, v_ss, dtg);
    cp_async_commit();

    // the carry as it enters chunk c (forward) or leaves it (reverse), hi and lo planes
    {
      constexpr int CPR = N / 8;   // 16-byte pieces of a row
      __nv_bfloat16* o = out + (long long)c * 2 * HD * N;
      for (int i = tid; i < 2 * HD * CPR; i += 256) {
        const int lo = i / (HD * CPR), r = (i / CPR) % HD, cc = i % CPR;
        *reinterpret_cast<uint4*>(o + lo * HD * N + r * N + cc * 8) =
            *reinterpret_cast<const uint4*>((lo ? stl : sth) + r * LDN + cc * 8);
      }
    }

    const __nv_bfloat16* vs = vs0 + buf * kChunk * LDN;
    const __nv_bfloat16* us = us0 + buf * kChunk * LDU;
    const float* dts = dts0 + buf * kChunk;

    // ---- cs = cumsum(dt*A); coef = dt exp(cs_last - cs) or
    // exp(cs): every warp its own copy
    float last;
    {
      float c0, c1;
      last = chunk_cumsum(dts, A, lane, c0, c1);
      coef[2 * lane] = reverse ? expf(c0) : dts[2 * lane] * expf(last - c0);
      coef[2 * lane + 1] = reverse ? expf(c1) : dts[2 * lane + 1] * expf(last - c1);
      __syncwarp();
    }

    // ---- coef.u as hi / lo operands
    for (int e = tid; e < kChunk * (HD / 2); e += 256) {
      const int q = e / (HD / 2), dp = 2 * (e % (HD / 2));
      const float2 uf =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(us + q * LDU + dp));
      const float cq = coef[q];
      uint32_t hi, lo;
      split2(uf.x * cq, uf.y * cq, hi, lo);
      *reinterpret_cast<uint32_t*>(uh + q * LDU + dp) = hi;
      *reinterpret_cast<uint32_t*>(ul + q * LDU + dp) = lo;
    }
    __syncthreads();   // coef.u complete; the staged carry is written out

    // ---- carry = exp(cs_last) * carry + (coef.u)^T . v, in this warp's registers
    if (owns) {
      const float decay = expf(last);
#pragma unroll
      for (int k = 0; k < TPW; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[k][e] *= decay;
#pragma unroll
      for (int kq = 0; kq < kChunk / 16; ++kq) {
        const int off = (16 * kq + (lane & 7) + (lane >> 4) * 8) * LDU + 16 * mt +
                        ((lane >> 3) & 1) * 8;
        uint32_t ah[4], al[4];
        ldsm_x4_t(ah, uh + off);
        ldsm_x4_t(al, ul + off);
#pragma unroll
        for (int k = 0; k < TPW; ++k) {
          uint32_t bb[2];
          ldsm_x2_t(bb, vs + (16 * kq + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN + 8 * (nt0 + k));
          mma16816(st[k], ah, bb[0], bb[1]);
          mma16816(st[k], al, bb[0], bb[1]);
        }
      }
      stage_carry<TPW, LDN>(st, sth, stl, sr_lo, sr_hi, nt0, t4);
    }
  }

  if (reverse && p.dh0 && owns) {
#pragma unroll
    for (int k = 0; k < TPW; ++k) {
      const int col = 8 * (nt0 + k) + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p.dh0[st_off + (long long)(e & 2 ? sr_hi : sr_lo) * N + col + (e & 1)] = st[k][e];
    }
  }
}

// Layout of the bf16 chunk kernel's shared memory, in bytes.
template <int HD, int N>
struct TcChunk {
  static constexpr int N16 = N < 16 ? 16 : N;   // depth of B.C^T and B.dh^T (N 8 zero-padded)
  static constexpr int LDN = N16 + 8;           // row of B, C and of the states (bf16 elements)
  static constexpr int LDX = HD + 8;            // row of x, dy
  static constexpr int XB = kChunk * LDX * 2;   // bytes of x (or dy) of a head
  static constexpr int SB = HD * LDN * 2;       // bytes of one state plane
  // a head's buffer: x, dy, dh hi, dh lo, h_c hi, h_c lo (the planes in this
  // order, SB apart), dt
  static constexpr int kX = 0, kDy = XB, kGh = 2 * XB, kGl = kGh + SB, kHh = kGl + SB,
                       kHl = kHh + SB, kDt = kHl + SB, HEAD = kDt + kChunk * 4;
  static constexpr int kB = 0;                          // [64][LDN] B of the group
  static constexpr int kC = kB + kChunk * LDN * 2;      // [64][LDN] C
  static constexpr int kHead = kC + kChunk * LDN * 2;   // [2] head buffers, this head and the next
  static constexpr int kCs = kHead + 2 * HEAD;          // [8 warps][64] cumsum(dt*A)
  static constexpr int kSum = kCs + 8 * kChunk * 4;     // fp32 sums of a head (see the kernel)
  static constexpr int kDx = kSum + (10 * kChunk + 8) * 4;   // [64][LDX] dx of a head, bf16
  static constexpr int kBytes = kDx + kChunk * LDX * 2;
  // after the heads, the head buffers hold dB, then dC, [64][LDP] fp32, for the copy out
  static constexpr int LDP = N + 8;
  static_assert(kChunk * LDP * 4 <= 2 * HEAD, "the staged dB fits the head buffers");
  static constexpr int KN = N16 / 16, KD = HD / 16;     // 16-deep steps over N, over hd
  static constexpr int NTN = N / 8;                     // 8-column tiles of dB, dC
  static constexpr int NW = NTN >= 2 ? NTN / 2 : 1;     // of them a warp (a column half)
  static constexpr int DW = HD / 16;                    // 8-column tiles of dx a warp
};

// Every product of the chunk kernel: acc += a . b on the tensor cores (one
// place, so that tools/kernel_ablations.py can take them all out).
__device__ __forceinline__ void chunk_mma(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  mma16816(acc, a, b0, b1);
}

// acc[t] += A . B over W 8-column tiles of B from column n0, depth k0 .. k0 + 15.
// B is read from shared memory laid out [k][n] (KN) or [n][k], rows of ld
// elements.  SA: A is split, ah + al, both against the same B.  SB: B is
// split, the hi array bh and the lo array bl, both against ah.  Hi first,
// then lo.  W is 1 or even.
template <int W, bool KN, bool SA, bool SB>
__device__ __forceinline__ void mma_tiles(float (&acc)[W][4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const __nv_bfloat16* bh,
                                          const __nv_bfloat16* bl, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  if constexpr (W >= 2) {
#pragma unroll
    for (int t = 0; t < W; t += 2) {
      const int off = KN ? (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + 8 * t +
                               (lane >> 4) * 8
                         : (n0 + 8 * t + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                               ((lane >> 3) & 1) * 8;
      uint32_t b[4];
      if constexpr (KN) ldsm_x4_t(b, bh + off);
      else ldsm_x4(b, bh + off);
      chunk_mma(acc[t], ah, b[0], b[1]);
      chunk_mma(acc[t + 1], ah, b[2], b[3]);
      if constexpr (SA) {
        chunk_mma(acc[t], al, b[0], b[1]);
        chunk_mma(acc[t + 1], al, b[2], b[3]);
      }
      if constexpr (SB) {
        if constexpr (KN) ldsm_x4_t(b, bl + off);
        else ldsm_x4(b, bl + off);
        chunk_mma(acc[t], ah, b[0], b[1]);
        chunk_mma(acc[t + 1], ah, b[2], b[3]);
      }
    }
  } else {
    const int off = KN ? (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0
                       : (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8;
    uint32_t b[2];
    if constexpr (KN) ldsm_x2_t(b, bh + off);
    else ldsm_x2(b, bh + off);
    chunk_mma(acc[0], ah, b[0], b[1]);
    if constexpr (SA) chunk_mma(acc[0], al, b[0], b[1]);
    if constexpr (SB) {
      if constexpr (KN) ldsm_x2_t(b, bl + off);
      else ldsm_x2(b, bl + off);
      chunk_mma(acc[0], ah, b[0], b[1]);
    }
  }
}

// The 8-column accumulator tiles t and t + 1 as the hi / lo A fragments of a
// product over those 16 columns.
template <int T>
__device__ __forceinline__ void split_a(const float (&m)[T][4], int t, uint32_t (&ah)[4],
                                        uint32_t (&al)[4]) {
  split2(m[t][0], m[t][1], ah[0], al[0]);
  split2(m[t][2], m[t][3], ah[1], al[1]);
  split2(m[t + 1][0], m[t + 1][1], ah[2], al[2]);
  split2(m[t + 1][2], m[t + 1][3], ah[3], al[3]);
}

// A block's dB or dC partial (fp32 registers, rows r_lo and r_hi, the W tiles
// from column n0) staged in shared memory, then out in 16-byte pieces of its
// rows: rows (b, s0 + r, g) of the partial (B, S, G, H / (G k), N), block kb.
template <int N, int W, int LDP>
__device__ __forceinline__ void write_partial(const float (&acc)[W][4], bool has_n, float* stage,
                                              float* part, long long base, int G, int nkb,
                                              int kb, int valid, int r_lo, int r_hi, int n0,
                                              int t4) {
  __syncthreads();   // the head buffers (or the previous staged sum) are free
  if (has_n)
#pragma unroll
    for (int t = 0; t < W; ++t) {
      const int n = n0 + 8 * t + 2 * t4;
      *reinterpret_cast<float2*>(stage + r_lo * LDP + n) = make_float2(acc[t][0], acc[t][1]);
      *reinterpret_cast<float2*>(stage + r_hi * LDP + n) = make_float2(acc[t][2], acc[t][3]);
    }
  __syncthreads();
  for (int i = threadIdx.x; i < valid * (N / 4); i += 256) {
    const int r = i / (N / 4), cc = i % (N / 4);
    *reinterpret_cast<float4*>(part + ((base + (long long)r * G) * nkb + kb) * N + cc * 4) =
        *reinterpret_cast<const float4*>(stage + r * LDP + cc * 4);
  }
}

// Head h's x, dy, dt and chunk states into a head buffer: cp.async (x and dy
// element by element when a row is not 16-byte aligned).
template <int HD, int N>
__device__ __forceinline__ void load_head(const Params& p, uint8_t* hb, int b, int h, int c,
                                          int nc, int s0, int valid) {
  using L = TcChunk<HD, N>;
  const int tid = threadIdx.x;
  const long long so = (((long long)b * p.H + h) * nc + c) * 2 * HD * N;
  const __nv_bfloat16* hg = reinterpret_cast<const __nv_bfloat16*>(p.states) + so;
  const __nv_bfloat16* gg = reinterpret_cast<const __nv_bfloat16*>(p.dstates) + so;
  constexpr int CPR = N / 8;   // 16-byte pieces of a state row
  for (int i = tid; i < 2 * HD * CPR; i += 256) {
    const int lo = i / (HD * CPR), r = (i / CPR) % HD, cc = i % CPR;
    const long long src = (long long)lo * HD * N + r * N + cc * 8;
    const int dst = (r * L::LDN + cc * 8) * 2;
    cp_async16(hb + (lo ? L::kGl : L::kGh) + dst, gg + src, true);
    cp_async16(hb + (lo ? L::kHl : L::kHh) + dst, hg + src, true);
  }
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(p.x) + b * p.x_sb + h * p.x_sh;
  const __nv_bfloat16* yg = static_cast<const __nv_bfloat16*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(hb + L::kX);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(hb + L::kDy);
  if (p.vec) {
    constexpr int CPX = HD / 8;
    for (int i = tid; i < kChunk * CPX; i += 256) {
      const int q = i / CPX, cc = i % CPX;
      const bool ok = q < valid;
      const long long row = s0 + (ok ? q : 0);
      cp_async16(xs + q * L::LDX + cc * 8, xg + row * p.x_ss + cc * 8, ok);
      cp_async16(ys + q * L::LDX + cc * 8, yg + row * p.dy_ss + cc * 8, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < kChunk * HD; i += 256) {
      const int q = i / HD, d = i % HD;
      const bool ok = q < valid;
      xs[q * L::LDX + d] = ok ? xg[(long long)(s0 + q) * p.x_ss + d] : zero;
      ys[q * L::LDX + d] = ok ? yg[(long long)(s0 + q) * p.dy_ss + d] : zero;
    }
  }
  if (tid < kChunk) {
    const bool ok = tid < valid;
    cp_async4(reinterpret_cast<float*>(hb + L::kDt) + tid,
              p.dt + b * p.dt_sb + h * p.dt_sh + (long long)(s0 + (ok ? tid : 0)) * p.dt_ss, ok);
  }
}

// One chunk's gradient for k heads of one group: blocks (batch * group *
// H / (G k), chunk), 256 threads.  Warp w takes the chunk's rows 16 (w % 4) ..
// 16 (w % 4) + 15 and one column half (w / 4) of dx and of dB / dC.  The
// heads go in order; while one computes, the next one's x, dy, dt and states
// arrive by cp.async into the other head buffer.  B.C^T is computed once for
// the block; dB and dC of the group are summed over the heads in fp32
// registers and written once, as the block's partial (B, S, G, H / (G k), N).
template <int HD, int N>
__global__ void __launch_bounds__(256, 1) ssd_bwd_chunk_tc(Params p) {
  using L = TcChunk<HD, N>;
  constexpr int LDN = L::LDN, LDX = L::LDX, KN = L::KN, KD = L::KD, NW = L::NW, DW = L::DW;
  static_assert(HD % 16 == 0 && N % 8 == 0, "hd a multiple of 16, N of 8");

  extern __shared__ __align__(16) uint8_t smem_k[];
  __nv_bfloat16* const Bs = reinterpret_cast<__nv_bfloat16*>(smem_k + L::kB);
  __nv_bfloat16* const Cs = reinterpret_cast<__nv_bfloat16*>(smem_k + L::kC);
  float* const rowP = reinterpret_cast<float*>(smem_k + L::kSum);  // [4][64] sum_j P_ij, a row
                                                                   // tile of warps each
  float* const Uxp = rowP + 4 * kChunk;   // [2][64] x_j . (dh B_j), a column half each
  float* const Inp = Uxp + 2 * kChunk;    // [2][64] C_i . dC_inter_i, a column half each
  float* const colP = Inp + 2 * kChunk;   // [64] sum_i P_ij
  float* const colG = colP + kChunk;      // [64] sum_i (dy_i.x_j)(C_i.B_j) L_ij
  float* const red = colG + kChunk;       // [8 warps] <dh, h_c>
  __nv_bfloat16* const dxs = reinterpret_cast<__nv_bfloat16*>(smem_k + L::kDx);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp & 3, ch = warp >> 2;
  float* const csw = reinterpret_cast<float*>(smem_k + L::kCs) + warp * kChunk;  // this warp's

  const int rep = p.H / p.G, nkb = rep / p.kheads;
  const int kb = blockIdx.x % nkb, bgi = blockIdx.x / nkb;
  const int b = bgi / p.G, grp = bgi % p.G;
  const int c = blockIdx.y, nc = gridDim.y;
  const int s0 = c * kChunk, valid = min(kChunk, p.S - s0);
  const int hfirst = grp * rep + kb * p.kheads;
  const int r_lo = 16 * rt + g, r_hi = r_lo + 8;   // this thread's rows of the chunk
  const bool has_n = ch * NW < L::NTN;             // (N 8: the second half has no dB / dC tile)
  const int n0 = 8 * ch * NW, d0 = 8 * ch * DW;    // this warp's first column of dB / dC, of dx

  if (N < 16) {   // columns 8..15 of B, C and of the state planes: zeros that no load overwrites
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < kChunk * 8; i += 256) {
      Bs[(i / 8) * LDN + 8 + i % 8] = zero;
      Cs[(i / 8) * LDN + 8 + i % 8] = zero;
    }
    for (int i = tid; i < 2 * 4 * HD * 8; i += 256) {
      const int buf = i / (4 * HD * 8), pl = (i / (HD * 8)) % 4, r = (i / 8) % HD;
      reinterpret_cast<__nv_bfloat16*>(smem_k + L::kHead + buf * L::HEAD + L::kGh +
                                       pl * L::SB)[r * LDN + 8 + i % 8] = zero;
    }
  }
  {   // B and C of the group, then the first head
    const __nv_bfloat16* Bg =
        static_cast<const __nv_bfloat16*>(p.Bm) + b * p.b_sb + grp * p.b_sg;
    const __nv_bfloat16* Cg =
        static_cast<const __nv_bfloat16*>(p.Cm) + b * p.c_sb + grp * p.c_sg;
    if (p.vec) {
      constexpr int CPR = N / 8;
      for (int i = tid; i < kChunk * CPR; i += 256) {
        const int q = i / CPR, cc = i % CPR;
        const bool ok = q < valid;
        const long long row = s0 + (ok ? q : 0);
        cp_async16(Bs + q * LDN + cc * 8, Bg + row * p.b_ss + cc * 8, ok);
        cp_async16(Cs + q * LDN + cc * 8, Cg + row * p.c_ss + cc * 8, ok);
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < kChunk * N; i += 256) {
        const int q = i / N, n = i % N;
        const bool ok = q < valid;
        Bs[q * LDN + n] = ok ? Bg[(long long)(s0 + q) * p.b_ss + n] : zero;
        Cs[q * LDN + n] = ok ? Cg[(long long)(s0 + q) * p.c_ss + n] : zero;
      }
    }
  }
  load_head<HD, N>(p, smem_k + L::kHead, b, hfirst, c, nc, s0, valid);
  cp_async_commit();

  float bc[8][4];                 // B_j . C_i on this warp's rows j, columns i >= 16 rt
  float dBs[NW][4], dCs[NW][4];   // dB and dC of the group, summed over the heads so far
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) bc[t][e] = 0.f;
#pragma unroll
  for (int t = 0; t < NW; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dBs[t][e] = dCs[t][e] = 0.f;

  for (int hh = 0; hh < p.kheads; ++hh) {
    const int h = hfirst + hh;
    const uint8_t* const hb = smem_k + L::kHead + (hh & 1) * L::HEAD;
    cp_async_wait_all();
    __syncthreads();   // this head has landed; the previous head is finished by every warp
    if (hh + 1 < p.kheads)
      load_head<HD, N>(p, smem_k + L::kHead + ((hh + 1) & 1) * L::HEAD, b, h + 1, c, nc, s0,
                       valid);
    cp_async_commit();
    const __nv_bfloat16* const xs = reinterpret_cast<const __nv_bfloat16*>(hb + L::kX);
    const __nv_bfloat16* const ys = reinterpret_cast<const __nv_bfloat16*>(hb + L::kDy);
    const __nv_bfloat16* const gh = reinterpret_cast<const __nv_bfloat16*>(hb + L::kGh);
    const __nv_bfloat16* const gl = reinterpret_cast<const __nv_bfloat16*>(hb + L::kGl);
    const __nv_bfloat16* const sh = reinterpret_cast<const __nv_bfloat16*>(hb + L::kHh);
    const __nv_bfloat16* const sl = reinterpret_cast<const __nv_bfloat16*>(hb + L::kHl);
    const float* const dts = reinterpret_cast<const float*>(hb + L::kDt);

    if (hh == 0) {   // B.C^T, once for the block
#pragma unroll
      for (int kn = 0; kn < KN; ++kn) {
        uint32_t a[4];
        ldsm_x4(a, Bs + (16 * rt + (lane & 15)) * LDN + 16 * kn + (lane >> 4) * 8);
#pragma unroll
        for (int ip = 0; ip < 4; ++ip) {
          if (ip < rt) continue;
          uint32_t bb[4];
          ldsm_x4(bb, Cs + (16 * ip + (lane & 7) + (lane >> 4) * 8) * LDN + 16 * kn +
                          ((lane >> 3) & 1) * 8);
          chunk_mma(bc[2 * ip], a, bb[0], bb[1]);
          chunk_mma(bc[2 * ip + 1], a, bb[2], bb[3]);
        }
      }
    }

    // ---- cs = cumsum(dt*A): every warp its own copy
    const float A = p.A[h * p.a_s];
    float last;
    {
      float c0, c1;
      last = chunk_cumsum(dts, A, lane, c0, c1);
      csw[2 * lane] = c0;
      csw[2 * lane + 1] = c1;
      __syncwarp();
    }
    const float c_lo = csw[r_lo], c_hi = csw[r_hi];
    const float dt_lo = dts[r_lo], dt_hi = dts[r_hi];
    const float w_lo = dt_lo * expf(last - c_lo), w_hi = dt_hi * expf(last - c_hi);

    // ======== this warp's rows as j (inputs): dx and the group's dB
    uint32_t xa[KD][4];   // x_j as A fragments (loaded again for x.dh)
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      ldsm_x4(xa[kd], xs + (16 * rt + (lane & 15)) * LDX + 16 * kd + (lane >> 4) * 8);
    float gd[8][4];   // x_j . dy_i (columns i >= 16 rt), then Gd^T_ji = (dy_i.x_j) L_ij dt_j
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) gd[t][e] = 0.f;
#pragma unroll
    for (int ip = 0; ip < 4; ++ip) {
      if (ip < rt) continue;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t bb[4];
        ldsm_x4(bb, ys + (16 * ip + (lane & 7) + (lane >> 4) * 8) * LDX + 16 * kd +
                        ((lane >> 3) & 1) * 8);
        chunk_mma(gd[2 * ip], xa[kd], bb[0], bb[1]);
        chunk_mma(gd[2 * ip + 1], xa[kd], bb[2], bb[3]);
      }
    }
    // Gd^T in place; M^T_ji = (C_i.B_j) L_ij dt_j a k-step at a time, straight
    // into dx_j = sum_i M^T_ji dy_i (M^T split hi / lo); the sums of P_ij =
    // (dy_i.x_j)(C_i.B_j) L_ij dt_j over i (rows) and over this thread's j
    // (columns), and of P_ij / dt_j over i
    float dxa[DW][4];
#pragma unroll
    for (int t = 0; t < DW; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[t][e] = 0.f;
    float rp[2] = {0.f, 0.f}, rg[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float mk[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int nt = 2 * kk + u;
        float cp[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * nt + 2 * t4 + (e & 1);
          float m = 0.f, gv = 0.f;
          if (nt >= 2 * rt && i >= (e & 2 ? r_hi : r_lo)) {   // only there: above, 2^x may overflow
            const float l = expf(csw[i] - (e & 2 ? c_hi : c_lo));
            const float dtj = e & 2 ? dt_hi : dt_lo;
            const float gm = bc[nt][e] * gd[nt][e] * l;
            const float pp = gm * dtj;
            rp[e >> 1] += pp;
            rg[e >> 1] += gm;
            cp[e & 1] += pp;
            m = bc[nt][e] * l * dtj;
            gv = gd[nt][e] * l * dtj;
          }
          mk[u][e] = m;
          gd[nt][e] = gv;
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {   // over the 8 rows g: this warp's share of sum_j P_ij
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) cp[k] += __shfl_xor_sync(0xffffffffu, cp[k], off);
          if (ch == 0 && g == 0) rowP[rt * kChunk + 8 * nt + 2 * t4 + k] = cp[k];
        }
      }
      if (kk < rt) continue;
      uint32_t ah[4], al[4];
      split_a(mk, 0, ah, al);
      mma_tiles<DW, true, true, false>(dxa, ah, al, ys, ys, LDX, 16 * kk, d0);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rp[u] += __shfl_xor_sync(0xffffffffu, rp[u], off);
        rg[u] += __shfl_xor_sync(0xffffffffu, rg[u], off);
      }
    if (ch == 0 && t4 == 0) {   // both column halves hold the same sums
      colP[r_lo] = rp[0];
      colP[r_hi] = rp[1];
      colG[r_lo] = rg[0];
      colG[r_hi] = rg[1];
    }

    // dB_j += sum_i Gd^T_ji C_i   (Gd^T split hi / lo)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < rt || !has_n) continue;
      uint32_t ah[4], al[4];
      split_a(gd, 2 * kk, ah, al);
      mma_tiles<NW, true, true, false>(dBs, ah, al, Cs, Cs, LDN, 16 * kk, n0);
    }
    // dx_j += w_j (dh B_j)   (dh split hi / lo)
    float dxb[DW][4];
#pragma unroll
    for (int t = 0; t < DW; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxb[t][e] = 0.f;
#pragma unroll
    for (int kn = 0; kn < KN; ++kn) {
      uint32_t a[4];
      ldsm_x4(a, Bs + (16 * rt + (lane & 15)) * LDN + 16 * kn + (lane >> 4) * 8);
      mma_tiles<DW, false, false, true>(dxb, a, a, gh, gl, LDN, 16 * kn, d0);
    }
    {
      float ux_lo = 0.f, ux_hi = 0.f;   // x_j . (dh B_j) over this warp's columns
#pragma unroll
      for (int t = 0; t < DW; ++t) {
        const int d = d0 + 8 * t + 2 * t4;
        const float2 xl =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + r_lo * LDX + d));
        const float2 xh =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + r_hi * LDX + d));
        ux_lo += xl.x * dxb[t][0] + xl.y * dxb[t][1];
        ux_hi += xh.x * dxb[t][2] + xh.y * dxb[t][3];
        *reinterpret_cast<__nv_bfloat162*>(dxs + r_lo * LDX + d) =
            __floats2bfloat162_rn(dxa[t][0] + w_lo * dxb[t][0], dxa[t][1] + w_lo * dxb[t][1]);
        *reinterpret_cast<__nv_bfloat162*>(dxs + r_hi * LDX + d) =
            __floats2bfloat162_rn(dxa[t][2] + w_hi * dxb[t][2], dxa[t][3] + w_hi * dxb[t][3]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ux_lo += __shfl_xor_sync(0xffffffffu, ux_lo, off);
        ux_hi += __shfl_xor_sync(0xffffffffu, ux_hi, off);
      }
      if (t4 == 0) {
        Uxp[ch * kChunk + r_lo] = ux_lo;
        Uxp[ch * kChunk + r_hi] = ux_hi;
      }
    }
    // dB_j += w_j (x_j . dh)   (dh split hi / lo)
    if (has_n) {
      float tb[NW][4];
#pragma unroll
      for (int t = 0; t < NW; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) tb[t][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        ldsm_x4(xa[kd], xs + (16 * rt + (lane & 15)) * LDX + 16 * kd + (lane >> 4) * 8);
        mma_tiles<NW, true, false, true>(tb, xa[kd], xa[kd], gh, gl, LDN, 16 * kd, n0);
      }
#pragma unroll
      for (int t = 0; t < NW; ++t) {   // the group's sum, head by head
        dBs[t][0] += w_lo * tb[t][0];
        dBs[t][1] += w_lo * tb[t][1];
        dBs[t][2] += w_hi * tb[t][2];
        dBs[t][3] += w_hi * tb[t][3];
      }
    }

    // ======== this warp's rows as i (outputs of y): the group's dC
    uint32_t ya[KD][4];   // dy_i as A fragments
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      ldsm_x4(ya[kd], ys + (16 * rt + (lane & 15)) * LDX + 16 * kd + (lane >> 4) * 8);
    float gi[8][4];   // dy_i . x_j (columns j < 16 rt + 16), then Gd_ij = (dy_i.x_j) L_ij dt_j
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) gi[t][e] = 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp > rt) continue;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t bb[4];
        ldsm_x4(bb, xs + (16 * jp + (lane & 7) + (lane >> 4) * 8) * LDX + 16 * kd +
                        ((lane >> 3) & 1) * 8);
        chunk_mma(gi[2 * jp], ya[kd], bb[0], bb[1]);
        chunk_mma(gi[2 * jp + 1], ya[kd], bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * nt + 2 * t4 + (e & 1);
        gi[nt][e] = nt <= 2 * rt + 1 && j <= (e & 2 ? r_hi : r_lo)
                        ? gi[nt][e] * expf((e & 2 ? c_hi : c_lo) - csw[j]) * dts[j]
                        : 0.f;
      }
    // dC_i += sum_j Gd_ij B_j   (Gd split hi / lo)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > rt || !has_n) continue;
      uint32_t ah[4], al[4];
      split_a(gi, 2 * kk, ah, al);
      mma_tiles<NW, true, true, false>(dCs, ah, al, Bs, Bs, LDN, 16 * kk, n0);
    }
    // dC_i += exp(cs_i) (h_c^T dy_i) (h_c split hi / lo), and C_i . that: the
    // gradient of cs_i through the chunk-to-chunk part of y
    {
      float in_lo = 0.f, in_hi = 0.f;
      if (has_n) {
        const float e_lo = expf(c_lo), e_hi = expf(c_hi);
        float tc[NW][4];
#pragma unroll
        for (int t = 0; t < NW; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) tc[t][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          mma_tiles<NW, true, false, true>(tc, ya[kd], ya[kd], sh, sl, LDN, 16 * kd, n0);
#pragma unroll
        for (int t = 0; t < NW; ++t) {   // the group's sum, head by head
          const int n = n0 + 8 * t + 2 * t4;
          const float2 cl =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Cs + r_lo * LDN + n));
          const float2 chv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Cs + r_hi * LDN + n));
          const float v0 = e_lo * tc[t][0], v1 = e_lo * tc[t][1];
          const float v2 = e_hi * tc[t][2], v3 = e_hi * tc[t][3];
          dCs[t][0] += v0;
          dCs[t][1] += v1;
          dCs[t][2] += v2;
          dCs[t][3] += v3;
          in_lo += cl.x * v0 + cl.y * v1;
          in_hi += chv.x * v2 + chv.y * v3;
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        in_lo += __shfl_xor_sync(0xffffffffu, in_lo, off);
        in_hi += __shfl_xor_sync(0xffffffffu, in_hi, off);
      }
      if (t4 == 0) {
        Inp[ch * kChunk + r_lo] = in_lo;
        Inp[ch * kChunk + r_hi] = in_hi;
      }
    }

    // ---- <dh, h_c>, from the hi + lo halves
    {
      float s = 0.f;
      for (int e = tid; e < HD * N / 2; e += 256) {
        const int o = ((2 * e) / N) * LDN + (2 * e) % N;
        const float2 ah = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gh + o));
        const float2 al = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gl + o));
        const float2 bh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sh + o));
        const float2 bl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sl + o));
        s += (ah.x + al.x) * (bh.x + bl.x) + (ah.y + al.y) * (bh.y + bl.y);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) red[warp] = s;
    }
    __syncthreads();   // every sum of this head, and its dx, is in shared memory

    if (warp != 0) {   // dx out, in 16-byte pieces of its rows
      __nv_bfloat16* dxg =
          static_cast<__nv_bfloat16*>(p.dx) + (((long long)b * p.S + s0) * p.H + h) * HD;
      for (int i = tid - 32; i < valid * (HD / 8); i += 224) {
        const int r = i / (HD / 8), cc = i % (HD / 8);
        *reinterpret_cast<uint4*>(dxg + (long long)r * p.H * HD + cc * 8) =
            *reinterpret_cast<const uint4*>(dxs + r * LDX + cc * 8);
      }
    } else {   // ---- dcs, its reverse cumulative sum, ddt and this head's share of dA
      float hdot = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) hdot += red[w];
      float dc[2], ux[2], dec[2], su = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = 2 * lane + u;
        ux[u] = Uxp[q] + Uxp[kChunk + q];
        const float in = Inp[q] + Inp[kChunk + q];
        const float rpq = rowP[q] + rowP[kChunk + q] + rowP[2 * kChunk + q] + rowP[3 * kChunk + q];
        dec[u] = expf(last - csw[q]);
        const float wq = dts[q] * dec[u];
        dc[u] = rpq - colP[q] + in - wq * ux[u];
        su += wq * ux[u];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) su += __shfl_xor_sync(0xffffffffu, su, off);
      // through exp(cs_last): the state's decay and every w_j
      if (lane == 31) dc[1] += expf(last) * hdot + su;
      // da_q = sum over q' >= q of dcs_q'
      float incl = dc[0] + dc[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += o;
      }
      float after = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) after = 0.f;
      const float da1 = dc[1] + after, da0 = dc[0] + da1;
      float* ddtg = p.ddt + ((long long)b * p.S + s0) * p.H + h;
      if (2 * lane < valid)
        ddtg[(long long)(2 * lane) * p.H] = colG[2 * lane] + dec[0] * ux[0] + A * da0;
      if (2 * lane + 1 < valid)
        ddtg[(long long)(2 * lane + 1) * p.H] = colG[2 * lane + 1] + dec[1] * ux[1] + A * da1;
      float sa = dts[2 * lane] * da0 + dts[2 * lane + 1] * da1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sa += __shfl_xor_sync(0xffffffffu, sa, off);
      if (lane == 0) p.dApart[((long long)b * nc + c) * p.H + h] = sa;
    }
  }

  // ---- the group's dB and dC over this block's heads, as its fp32 partial:
  // staged in the head buffers, then out in 16-byte pieces of its rows
  float* const stage = reinterpret_cast<float*>(smem_k + L::kHead);
  const long long base = ((long long)b * p.S + s0) * p.G + grp;   // row (b, s0, g)
  write_partial<N, NW, L::LDP>(dBs, has_n, stage, p.dBh, base, p.G, nkb, kb, valid, r_lo, r_hi,
                              n0, t4);
  write_partial<N, NW, L::LDP>(dCs, has_n, stage, p.dCh, base, p.G, nkb, kb, valid, r_lo, r_hi,
                              n0, t4);
}

template <int HD, int N>
int launch_tc(const Params& p, cudaStream_t s) {
  using LC = TcChain<HD, N>;
  using LK = TcChunk<HD, N>;
  static_assert(LC::kBytes <= 232448 && LK::kBytes <= 232448,
                "shared memory of one block on an H100");
  static bool attr_set = false;  // the attribute sticks to the function
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_bwd_chains_tc<HD, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, LC::kBytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(ssd_bwd_chunk_tc<HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             LK::kBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int nc = (p.S + kChunk - 1) / kChunk;
  const int nkb = p.H / p.G / p.kheads;
  ssd_bwd_chains_tc<HD, N><<<dim3(p.B * p.H, 2), 256, LC::kBytes, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_chunk_tc<HD, N><<<dim3(p.B * p.G * nkb, nc), 256, LK::kBytes, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_bc = 2LL * p.B * p.S * p.G * N;
  ssd_bwd_reduce_bc<__nv_bfloat16>
      <<<(unsigned)((n_bc + kThreads - 1) / kThreads), kThreads, 0, s>>>(p, N, nkb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_reduce_a<<<(p.H + 127) / 128, 128, 0, s>>>(p, nc);
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

extern "C" int ssd_scan_bwd(const void* x, const float* dt, const float* A, const void* Bm,
                            const void* Cm, const float* h0, const void* dy, const float* dhT,
                            void* dx, float* ddt, float* dA, void* dB, void* dC, float* dh0,
                            float* states, float* dstates, float* dBh, float* dCh,
                            float* dApart, int B, int S, int H, int G, int hd, int N, int kheads,
                            long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
                            long long dt_ss, long long dt_sh, long long a_s, long long b_sb,
                            long long b_ss, long long b_sg, long long c_sb, long long c_ss,
                            long long c_sg, long long dy_sb, long long dy_ss, long long dy_sh,
                            int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0) return -2;
  if ((long long)B * H > 2147483647LL || (S + kChunk - 1) / kChunk > 65535) return -2;
  if (2LL * B * S * G * N > 2147483647LL * kThreads) return -2;
  if (is_bf16 && (kheads <= 0 || (H / G) % kheads != 0)) return -2;
  auto rows16 = [](const void* ptr, long long s0, long long s1, long long s2) {
    return (uintptr_t)ptr % 16 == 0 && s0 % 8 == 0 && s1 % 8 == 0 && s2 % 8 == 0;
  };
  const int vec = rows16(x, x_sb, x_ss, x_sh) && rows16(Bm, b_sb, b_ss, b_sg) &&
                  rows16(Cm, c_sb, c_ss, c_sg) && rows16(dy, dy_sb, dy_ss, dy_sh);
  Params p{x,      dt,    A,     Bm,    Cm,    h0,    dy,    dhT,   dx,    ddt,   dA,
           dB,     dC,    dh0,   states, dstates, dBh, dCh, dApart, B,    S,     H,
           G,      kheads, vec,  x_sb,  x_ss,  x_sh,  dt_sb, dt_ss, dt_sh, a_s,  b_sb,
           b_ss,   b_sg,  c_sb,  c_ss,  c_sg,  dy_sb, dy_ss, dy_sh};
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_tc_hd(p, hd, N, s) : launch_hd(p, hd, N, s);
}
