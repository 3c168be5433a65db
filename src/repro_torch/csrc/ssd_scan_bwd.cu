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
// Design (a kernel that is right first; making it fast is later work).  The
// chain of chunks is the one serial part, and it is cheap: given the states
// h_c and the gradients dh, every chunk's gradient is independent of the
// others.  So one call is four launches on the stream:
//   1. ssd_bwd_chains: blocks (batch*head, 2).  Row 0 walks the chunks
//      forward and writes the state entering each chunk (h0, or zeros, first);
//      row 1 walks them in reverse from dhT (or zeros) and writes the gradient
//      of the state leaving each chunk, then dh0.  Each chunk's update is an
//      (hd x N) product of depth 64 in fp32 FMAs with the carry in registers.
//      The two scratch arrays are (B, H, nc, hd, N) fp32 each.  Row 0
//      repeats the forward kernel's chain: the backward takes only the
//      forward's inputs, as the plain version does, and the forward, which
//      serving runs, is left as it is.
//   2. ssd_bwd_chunk: one block of 256 threads per (batch*head, chunk), all
//      in parallel (8192 blocks at mamba2-1.3b's training shape).  x, dy, B,
//      C, h_c and dh of the chunk in shared memory as fp32 (222,208 bytes at
//      hd 64, N 128: one block an SM); C.B^T and dy.x^T, then M and the
//      dB / dC coefficient matrix, then dx, dB, dC as products over shared
//      memory (4 x 4 register tiles, fp32 FMAs), dx written in x's dtype, dB
//      and dC per head in fp32 scratch.  Row and column sums (for dcs) are
//      written as per-thread partials and added in a fixed order; the reverse
//      cumulative sum of dcs, ddt and the block's share of dA follow.
//   3. ssd_bwd_reduce_bc: dB and dC summed over the heads of each group, in
//      head order, cast to the inputs' dtype.
//   4. ssd_bwd_reduce_a: dA summed over batch and chunks, in order.
// No atomics: every sum is taken in one order, so two calls give the same bits.
// bf16 inputs are widened to fp32 as they are loaded; every product and sum is
// fp32.  A ragged last chunk is loaded with x = dy = B = C = 0 and dt = 0:
// the padded steps have decay 1, add nothing, and are never stored.
// exp(cs_i - cs_j) is evaluated only for j <= i: above the diagonal it is
// positive and can overflow, and inf * 0 is NaN.
//
// What bounds it on this card.  At mamba2-1.3b's training shape (B 4, S 2048,
// H 64, hd 64, N 128, G 1, bf16) the function reads x, dy, dt, B, C and writes
// dx, ddt, dB, dC: about 214 MB, 0.064 ms at 3.35 TB/s; its products are about
// 60 GFLOP, 0.061 ms at the bf16 tensor-core peak.  So the bound is bytes, by
// a little.  This kernel is far from it: its products are fp32 FMAs out of
// shared memory (67 TFLOP/s peak), its blocks run one to an SM, and its
// scratch (the chunk states and their gradients, 537 MB of fp32, and as much
// again of per-head dB / dC) makes a round trip through memory.  Tensor-core
// products and a smaller footprint are the next step.
//
// Plain C interface (no PyTorch headers): the wrapper in
// repro_torch/kernels/ssd_scan.py passes raw pointers, element strides, the
// scratch it allocated and the stream, and raises on a non-zero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  float* states;        // scratch (B, H, nc, hd, N): the state entering each chunk
  float* dstates;       // scratch (B, H, nc, hd, N): the gradient of the state leaving it
  float* dBh;           // scratch (B, S, H, N): dB of each head
  float* dCh;
  float* dApart;        // scratch (B, nc, H): dA of each (batch, chunk, head)
  int B, S, H, G;
  // strides in elements (the last dimension of x, B, C, dy has stride 1)
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long a_s;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long dy_sb, dy_ss, dy_sh;
};

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }
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

template <typename T, int HD, int N>
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
  const T* u = rev ? static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh
                   : static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const long long u_ss = rev ? p.dy_ss : p.x_ss;
  const T* v = rev ? static_cast<const T*>(p.Cm) + b * p.c_sb + g * p.c_sg
                   : static_cast<const T*>(p.Bm) + b * p.b_sb + g * p.b_sg;
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
      us[q * HP + d] = q < valid ? ldf(u + (long long)(s0 + q) * u_ss + d) : 0.f;
    }
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int q = i / N, n = i % N;
      vs[q * NP + n] = q < valid ? ldf(v + (long long)(s0 + q) * v_ss + n) : 0.f;
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

template <typename T, int HD, int N>
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
    const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
    const T* dy = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
    const T* Bg = static_cast<const T*>(p.Bm) + b * p.b_sb + g * p.b_sg;
    const T* Cg = static_cast<const T*>(p.Cm) + b * p.c_sb + g * p.c_sg;
    for (int i = tid; i < Q * HD; i += kThreads) {
      const int q = i / HD, d = i % HD;
      const bool ok = q < valid;
      xs[q * HP + d] = ok ? ldf(x + (long long)(s0 + q) * p.x_ss + d) : 0.f;
      dys[q * HP + d] = ok ? ldf(dy + (long long)(s0 + q) * p.dy_ss + d) : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int q = i / N, n = i % N;
      const bool ok = q < valid;
      Bs[q * NP + n] = ok ? ldf(Bg + (long long)(s0 + q) * p.b_ss + n) : 0.f;
      Cs[q * NP + n] = ok ? ldf(Cg + (long long)(s0 + q) * p.c_ss + n) : 0.f;
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
      T* out = static_cast<T*>(p.dx) + ((row0 + j) * p.H + h) * HD;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int d = tc + TC * cc;
        ux = fmaf(xs[j * HP + d], acc2[a][cc], ux);
        if (j < valid) stf(out + d, fmaf(w[j], acc2[a][cc], acc[a][cc]));
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

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce_bc(Params p, int N) {
  const long long per = (long long)p.B * p.S * p.G * N;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= 2 * per) return;
  const bool is_c = idx >= per;
  const long long e = is_c ? idx - per : idx;
  const int rep = p.H / p.G;
  const int n = (int)(e % N);
  const long long rest = e / N;
  const int g = (int)(rest % p.G);
  const long long bs = rest / p.G;
  const float* src = (is_c ? p.dCh : p.dBh) + (bs * p.H + (long long)g * rep) * N + n;
  float s = 0.f;
  for (int r = 0; r < rep; ++r) s += src[(long long)r * N];
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

template <typename T, int HD, int N>
int launch(const Params& p, cudaStream_t s) {
  constexpr size_t chain_bytes = ChainSmem<HD, N>::kBytes;
  constexpr size_t chunk_bytes = ChunkSmem<HD, N>::kBytes;
  static_assert(chunk_bytes <= 232448 && chain_bytes <= 232448,
                "shared memory of one block on an H100");
  static bool attr_set = false;  // the attribute sticks to the function
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_bwd_chains<T, HD, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)chain_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(ssd_bwd_chunk<T, HD, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)chunk_bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int nc = (p.S + kChunk - 1) / kChunk;
  ssd_bwd_chains<T, HD, N><<<dim3(p.B * p.H, 2), kThreads, chain_bytes, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_chunk<T, HD, N><<<dim3(p.B * p.H, nc), kThreads, chunk_bytes, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_bc = 2LL * p.B * p.S * p.G * N;
  ssd_bwd_reduce_bc<T><<<(unsigned)((n_bc + kThreads - 1) / kThreads), kThreads, 0, s>>>(p, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_reduce_a<<<(p.H + 127) / 128, 128, 0, s>>>(p, nc);
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

extern "C" int ssd_scan_bwd(const void* x, const float* dt, const float* A, const void* Bm,
                            const void* Cm, const float* h0, const void* dy, const float* dhT,
                            void* dx, float* ddt, float* dA, void* dB, void* dC, float* dh0,
                            float* states, float* dstates, float* dBh, float* dCh,
                            float* dApart, int B, int S, int H, int G, int hd, int N,
                            long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
                            long long dt_ss, long long dt_sh, long long a_s, long long b_sb,
                            long long b_ss, long long b_sg, long long c_sb, long long c_ss,
                            long long c_sg, long long dy_sb, long long dy_ss, long long dy_sh,
                            int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0) return -2;
  if ((long long)B * H > 2147483647LL || (S + kChunk - 1) / kChunk > 65535) return -2;
  if (2LL * B * S * G * N > 2147483647LL * kThreads) return -2;
  Params p{x,     dt,    A,     Bm,    Cm,    h0,    dy,    dhT,   dx,    ddt,   dA,
           dB,    dC,    dh0,   states, dstates, dBh, dCh, dApart, B,     S,     H,
           G,     x_sb,  x_ss,  x_sh,  dt_sb, dt_ss, dt_sh, a_s,   b_sb,  b_ss,  b_sg,
           c_sb,  c_ss,  c_sg,  dy_sb, dy_ss, dy_sh};
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_hd<__nv_bfloat16>(p, hd, N, s) : launch_hd<float>(p, hd, N, s);
}
