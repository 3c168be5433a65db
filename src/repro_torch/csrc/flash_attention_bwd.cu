// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// The gradient of the function the forward kernel (csrc/flash_attention.cu)
// computes, the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (the pallas_call at line 102).  That kernel has no backward: the JAX
// package trains through chunked / dense attention differentiated by JAX
// (src/repro/models/layers.py:129-138), so this file has no TPU kernel to
// translate and follows the usual flash-attention recomputation instead.
// Given q, k, v, the forward's output o, its cotangent dO and the forward's
// per-row log-sum-exp `lse = m + log l` (fp32, (B, Hq, Sq)) it computes
//
//   D  = rowsum(dO * O)                      (fp32, one pass, kept in a buffer)
//   P  = exp(q.k^T * scale - lse)            recomputed block by block, with the
//                                            forward's masks (k_pos < Sk; if
//                                            causal, k_pos <= q_pos) as P = 0
//   dV = P^T dO
//   dS = P * (dO V^T - D)
//   dQ = dS K * scale,   dK = dS^T Q * scale
//
// and sums dK and dV over the Hq / Hkv query heads that read one KV head.
//
// Design: two kernels after the D pass, so that no two blocks write the same
// output and no atomics are needed (the result is deterministic and the
// grouped-query sum needs no second pass):
//   * dK/dV: one block per (batch, KV head, 64-key tile) walks every query
//     head of the group and every 64-row q tile that can see its keys (from
//     the diagonal on, if causal), and keeps dK and dV in registers;
//   * dQ: one block per (batch, query head, 64-row q tile) walks the key tiles
//     up to the diagonal, and keeps dQ in registers.
// Both recompute S and dP = dO V^T; the dQ kernel could take dS from the
// dK/dV kernel through memory instead, at (B, Hq, Sq, Sk) bytes.
//
// What bounds it on this card.  At llama3.2-1b's training shape (B 4, S 2048,
// 32 query heads, 8 KV heads, hd 64, bf16, causal) the products are 2.5 times
// the forward's (Q.K^T, dO.V^T, P^T.dO, dS^T.Q, dS.K; Q.K^T and dO.V^T are
// done twice here, so the kernels do 3.5 times): 172 GFLOP on 168 MB, far
// above the ~295 operations a byte where an H100 turns tensor-core-bound.
//   * bf16: `mma.sync.m16n8k16` bf16 -> fp32 on the tensor cores.  A block is
//     4 warps of 16 rows each.  Tiles come through shared memory with 16-byte
//     loads, rows padded by 16 bytes so that the fragment loads hit 32
//     distinct banks.  S and dP stay in registers as accumulator fragments;
//     P and dS are rounded to bf16 and turned into the A operand of the next
//     product in registers (the accumulator layout of two n8 tiles is the A
//     layout of one k16 step), so they never go through memory.  No TMA, no
//     wgmma and no overlap of loads with products: a simple kernel first.
//   * fp32: plain FMAs (no TF32, for the reference's fp32 tolerance), blocks
//     of 32 rows, every product through shared memory.  This path serves
//     checks and small fp32 models.
//
// Plain C interface (no PyTorch headers): the wrapper in
// repro_torch/kernels/flash_attention.py passes raw pointers, element strides
// and the stream, and raises on a non-zero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // (B, Hq, Sq), contiguous
  float* delta;        // (B, Hq, Sq), contiguous: D = rowsum(dO * O)
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, Hq, Hkv;
  // strides in elements: batch, sequence, head (the last dimension has stride 1)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool visible(const BwdParams& p, int q, int key) {
  return q < p.Sq && key < p.Sk && (!p.causal || key <= q);
}

// ---------------------------------------------------------------------------
// D = rowsum(dO * O): one warp per (batch, position, head) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) bwd_delta(const BwdParams p, int hd) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.B * p.Sq * p.Hq) return;
  const int h = (int)(row % p.Hq);
  const long long bs = row / p.Hq;
  const int s = (int)(bs % p.Sq), b = (int)(bs / p.Sq);
  const T* o = (const T*)p.o + b * p.o_sb + s * p.o_ss + h * p.o_sh;
  const T* d = (const T*)p.dout + b * p.do_sb + s * p.do_ss + h * p.do_sh;
  float acc = 0.f;
  for (int i = lane; i < hd; i += 32) acc = fmaf(to_f(o[i]), to_f(d[i]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[((long long)b * p.Hq + h) * p.Sq + s] = acc;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, bf16 operands, fp32 sums
// ---------------------------------------------------------------------------

constexpr int kRows = 64;  // rows of a tile: 4 warps x 16

template <int HD>
struct Bf16Cfg {
  static constexpr int LDS = HD + 8;          // row stride in bf16: 16-byte rows, no bank conflicts
  static constexpr int TILE = kRows * LDS;    // elements of one staged tile
  static constexpr int SMEM = 4 * TILE * 2;   // four tiles
  static constexpr int KS = HD / 16;          // k16 steps over hd
  static constexpr int NT = HD / 8;           // n8 tiles over hd
};

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A (kRows x HD) bf16 tile from global memory into shared memory, 16-byte
// chunks; rows at or past `valid` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(uint16_t* dst, const __nv_bfloat16* src,
                                          long long stride, int valid) {
  constexpr int CPR = HD / 8;
  for (int c = threadIdx.x; c < kRows * CPR; c += 128) {
    const int r = c / CPR, cc = c % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (long long)r * stride + cc * 8);
    *reinterpret_cast<uint4*>(dst + r * Bf16Cfg<HD>::LDS + cc * 8) = val;
  }
}

// Fragments of m16n8k16 (g = lane / 4, t = lane % 4).  A 16 x 16 block of a
// row-major tile: rows r0 + g (+ 8), columns c0 + 2t (+ 1, + 8, + 9).
template <int LDS>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint16_t* s, int r0, int c0,
                                       int g, int t) {
  const uint16_t* p0 = s + (r0 + g) * LDS + c0 + 2 * t;
  const uint16_t* p1 = p0 + 8 * LDS;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B (k16 x n8) whose k runs along a tile's rows: element (k, n) is
// s[(n0 + n) * LDS + k0 + k]  (K-major, e.g. K for S = Q.K^T).
template <int LDS>
__device__ __forceinline__ void frag_b_rowk(uint32_t& b0, uint32_t& b1, const uint16_t* s, int n0,
                                            int k0, int g, int t) {
  const uint16_t* p = s + (n0 + g) * LDS + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B (k16 x n8) whose k runs down a tile's columns: element (k, n) is
// s[(k0 + k) * LDS + n0 + n]  (MN-major, e.g. dO for dV = P^T.dO).
template <int LDS>
__device__ __forceinline__ void frag_b_colk(uint32_t& b0, uint32_t& b1, const uint16_t* s, int k0,
                                            int n0, int g, int t) {
  const uint16_t* p = s + (k0 + 2 * t) * LDS + n0 + g;
  b0 = (uint32_t)p[0] | ((uint32_t)p[LDS] << 16);
  b1 = (uint32_t)p[8 * LDS] | ((uint32_t)p[9 * LDS] << 16);
}

// Accumulators of two n8 tiles (2j, 2j + 1) as the bf16 A operand of one k16
// step: the m16n8 accumulator layout is the A layout, half by half.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// X(16 x 64) = A(16 x HD) . B(64 x HD)^T for one warp: rows r0.. of tile `a`
// against the 64 rows of tile `b`, both row-major over hd.
template <int HD>
__device__ __forceinline__ void rows_times_rows(float (&x)[8][4], const uint16_t* a,
                                                const uint16_t* b, int r0, int g, int t) {
  constexpr int LDS = Bf16Cfg<HD>::LDS;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < Bf16Cfg<HD>::KS; ++kk) {
    uint32_t af[4];
    frag_a<LDS>(af, a, r0, kk * 16, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b0, b1;
      frag_b_rowk<LDS>(b0, b1, b, j * 8, kk * 16, g, t);
      mma16816(x[j], af, b0, b1);
    }
  }
}

// acc(16 x HD) += X(16 x 64, accumulators rounded to bf16) . B(64 x HD) for
// one warp, B a row-major tile whose 64 rows are the k dimension.
template <int HD>
__device__ __forceinline__ void acc_times_tile(float (&acc)[Bf16Cfg<HD>::NT][4],
                                               const float (&x)[8][4], const uint16_t* b, int g,
                                               int t) {
  constexpr int LDS = Bf16Cfg<HD>::LDS;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t af[4];
    acc_to_a(af, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < Bf16Cfg<HD>::NT; ++n) {
      uint32_t b0, b1;
      frag_b_colk<LDS>(b0, b1, b, kk * 16, n * 8, g, t);
      mma16816(acc[n], af, b0, b1);
    }
  }
}

// Rows r_lo = row0 + g and r_hi = r_lo + 8 of a warp's accumulator (columns
// n * 8 + 2t, + 1) times `mul`, as bf16, to global memory; rows >= n_rows skipped.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long stride,
                                           const float (&acc)[Bf16Cfg<HD>::NT][4], int r_lo,
                                           int n_rows, float mul, int t) {
#pragma unroll
  for (int n = 0; n < Bf16Cfg<HD>::NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (r_lo < n_rows)
      *reinterpret_cast<uint32_t*>(base + (long long)r_lo * stride + col) =
          pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    if (r_lo + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (long long)(r_lo + 8) * stride + col) =
          pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// dK and dV of 64 keys.  Warp w owns keys k0 + 16w .. + 15 and computes the
// transposed tiles S^T = K.Q^T and dP^T = V.dO^T, so that P^T and dS^T come
// out with the keys as rows, which is the A operand of dV += P^T.dO and
// dK += dS^T.Q.
template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_bf16(const BwdParams p) {
  using C = Bf16Cfg<HD>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sV = sK + C::TILE;
  uint16_t* sQ = sV + C::TILE;
  uint16_t* sO = sQ + C::TILE;  // dO
  __shared__ float sL[kRows], sD[kRows];

  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kRows;  // early (long-walking) key tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int group = p.Hq / p.Hkv;
  const float c2 = p.scale * kLog2e;

  load_tile<HD>(sK, (const __nv_bfloat16*)p.k + b * p.k_sb + k0 * p.k_ss + hk * p.k_sh, p.k_ss,
                p.Sk - k0);
  load_tile<HD>(sV, (const __nv_bfloat16*)p.v + b * p.v_sb + k0 * p.v_ss + hk * p.v_sh, p.v_ss,
                p.Sk - k0);

  float dk[C::NT][4], dv[C::NT][4];
#pragma unroll
  for (int n = 0; n < C::NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  const int key_lo = k0 + warp * 16 + g;
  const int n_qt = (p.Sq + kRows - 1) / kRows;
  const int qt0 = p.causal ? k0 / kRows : 0;  // earlier q tiles see none of these keys

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kRows;
      __syncthreads();  // the previous tile is consumed
      load_tile<HD>(sQ, (const __nv_bfloat16*)p.q + b * p.q_sb + q0 * p.q_ss + h * p.q_sh,
                    p.q_ss, p.Sq - q0);
      load_tile<HD>(sO, (const __nv_bfloat16*)p.dout + b * p.do_sb + q0 * p.do_ss + h * p.do_sh,
                    p.do_ss, p.Sq - q0);
      if (threadIdx.x < kRows) {
        const int q = q0 + threadIdx.x;
        const long long i = ((long long)b * p.Hq + h) * p.Sq + q;
        sL[threadIdx.x] = q < p.Sq ? p.lse[i] * kLog2e : 0.f;
        sD[threadIdx.x] = q < p.Sq ? p.delta[i] : 0.f;
      }
      __syncthreads();

      float s[8][4], dp[8][4];
      rows_times_rows<HD>(s, sK, sQ, warp * 16, g, t);   // S^T
      rows_times_rows<HD>(dp, sV, sO, warp * 16, g, t);  // dP^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = j * 8 + 2 * t + (i & 1);
          const int key = key_lo + ((i & 2) ? 8 : 0);
          const float pv = visible(p, q0 + qc, key) ? exp2f(fmaf(s[j][i], c2, -sL[qc])) : 0.f;
          s[j][i] = pv;                            // P^T
          dp[j][i] = pv * (dp[j][i] - sD[qc]);     // dS^T
        }
      acc_times_tile<HD>(dv, s, sO, g, t);   // dV += P^T.dO
      acc_times_tile<HD>(dk, dp, sQ, g, t);  // dK += dS^T.Q
    }
  }
  store_rows<HD>((__nv_bfloat16*)p.dk + b * p.dk_sb + hk * p.dk_sh, p.dk_ss, dk, key_lo, p.Sk,
                 p.scale, t);
  store_rows<HD>((__nv_bfloat16*)p.dv + b * p.dv_sb + hk * p.dv_sh, p.dv_ss, dv, key_lo, p.Sk,
                 1.f, t);
}

// dQ of 64 query rows of one head.  Warp w owns rows q0 + 16w .. + 15.
template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(const BwdParams p) {
  using C = Bf16Cfg<HD>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sO = sQ + C::TILE;  // dO
  uint16_t* sK = sO + C::TILE;
  uint16_t* sV = sK + C::TILE;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // long (late) q tiles first
  const int hk = h / (p.Hq / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float c2 = p.scale * kLog2e;

  load_tile<HD>(sQ, (const __nv_bfloat16*)p.q + b * p.q_sb + q0 * p.q_ss + h * p.q_sh, p.q_ss,
                p.Sq - q0);
  load_tile<HD>(sO, (const __nv_bfloat16*)p.dout + b * p.do_sb + q0 * p.do_ss + h * p.do_sh,
                p.do_ss, p.Sq - q0);
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const long long li = ((long long)b * p.Hq + h) * p.Sq;
  const float l_lo = row_lo < p.Sq ? p.lse[li + row_lo] * kLog2e : 0.f;
  const float l_hi = row_hi < p.Sq ? p.lse[li + row_hi] * kLog2e : 0.f;
  const float d_lo = row_lo < p.Sq ? p.delta[li + row_lo] : 0.f;
  const float d_hi = row_hi < p.Sq ? p.delta[li + row_hi] : 0.f;

  float dq[C::NT][4];
#pragma unroll
  for (int n = 0; n < C::NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  int n_kt = (p.Sk + kRows - 1) / kRows;
  if (p.causal) {
    const int upto = (min(q0 + kRows, p.Sq) - 1) / kRows + 1;  // tile holding key == last row
    n_kt = upto < n_kt ? upto : n_kt;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();  // the previous tile is consumed (and Q, dO are in, the first time)
    load_tile<HD>(sK, (const __nv_bfloat16*)p.k + b * p.k_sb + k0 * p.k_ss + hk * p.k_sh, p.k_ss,
                  p.Sk - k0);
    load_tile<HD>(sV, (const __nv_bfloat16*)p.v + b * p.v_sb + k0 * p.v_ss + hk * p.v_sh, p.v_ss,
                  p.Sk - k0);
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_times_rows<HD>(s, sQ, sK, warp * 16, g, t);   // S
    rows_times_rows<HD>(dp, sO, sV, warp * 16, g, t);  // dP
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + j * 8 + 2 * t + (i & 1);
        const bool hi = i & 2;
        const float pv = visible(p, hi ? row_hi : row_lo, key)
                             ? exp2f(fmaf(s[j][i], c2, -(hi ? l_hi : l_lo)))
                             : 0.f;
        dp[j][i] = pv * (dp[j][i] - (hi ? d_hi : d_lo));  // dS
      }
    acc_times_tile<HD>(dq, dp, sK, g, t);  // dQ += dS.K
  }
  store_rows<HD>((__nv_bfloat16*)p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, dq, row_lo, p.Sq,
                 p.scale, t);
}

// ---------------------------------------------------------------------------
// fp32: plain FMA
// ---------------------------------------------------------------------------

constexpr int kRowsF = 32;  // rows of an fp32 tile

template <int HD>
struct F32Cfg {
  static constexpr int LDF = HD + 4;  // 16-byte rows; 8 rows a warp reads land in distinct banks
  static constexpr int TILE = kRowsF * LDF;
  static constexpr int SMEM = 4 * TILE * 4;
};

template <int HD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long stride,
                                              int valid) {
  constexpr int CPR = HD / 4;
  for (int c = threadIdx.x; c < kRowsF * CPR; c += 128) {
    const int r = c / CPR, cc = c % CPR;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = *reinterpret_cast<const float4*>(src + (long long)r * stride + cc * 4);
    *reinterpret_cast<float4*>(dst + r * F32Cfg<HD>::LDF + cc * 4) = val;
  }
}

// x[i] = sum_d A[r][d] B[c0 + 4i][d], y[i] = sum_d A2[r][d] B2[c0 + 4i][d], i < 8
template <int HD>
__device__ __forceinline__ void dots8(float (&x)[8], float (&y)[8], const float* A,
                                      const float* B, const float* A2, const float* B2, int r,
                                      int c0) {
  constexpr int LDF = F32Cfg<HD>::LDF;
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = y[i] = 0.f;
  for (int d = 0; d < HD; ++d) {
    const float a = A[r * LDF + d], a2 = A2[r * LDF + d];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = fmaf(a, B[(c0 + 4 * i) * LDF + d], x[i]);
      y[i] = fmaf(a2, B2[(c0 + 4 * i) * LDF + d], y[i]);
    }
  }
}

// dK and dV of 32 keys; thread (r = tid / 4, c = tid % 4) computes the scores
// of key r against queries c, c + 4, ..., then owns dK / dV[r][c + 4i].
template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_f32(const BwdParams p) {
  using C = F32Cfg<HD>;
  constexpr int NI = HD / 4;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + C::TILE;
  float* sQ = sV + C::TILE;
  float* sO = sQ + C::TILE;
  __shared__ float sP[kRowsF][kRowsF + 1], sS[kRowsF][kRowsF + 1];
  __shared__ float sL[kRowsF], sD[kRowsF];

  const int hk = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kRowsF;
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int group = p.Hq / p.Hkv;
  load_tile_f32<HD>(sK, (const float*)p.k + b * p.k_sb + k0 * p.k_ss + hk * p.k_sh, p.k_ss,
                    p.Sk - k0);
  load_tile_f32<HD>(sV, (const float*)p.v + b * p.v_sb + k0 * p.v_ss + hk * p.v_sh, p.v_ss,
                    p.Sk - k0);
  float dk[NI], dv[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) dk[i] = dv[i] = 0.f;
  const int n_qt = (p.Sq + kRowsF - 1) / kRowsF;
  const int qt0 = p.causal ? k0 / kRowsF : 0;

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kRowsF;
      __syncthreads();
      load_tile_f32<HD>(sQ, (const float*)p.q + b * p.q_sb + q0 * p.q_ss + h * p.q_sh, p.q_ss,
                        p.Sq - q0);
      load_tile_f32<HD>(sO, (const float*)p.dout + b * p.do_sb + q0 * p.do_ss + h * p.do_sh,
                        p.do_ss, p.Sq - q0);
      if (threadIdx.x < kRowsF) {
        const int q = q0 + threadIdx.x;
        const long long i = ((long long)b * p.Hq + h) * p.Sq + q;
        sL[threadIdx.x] = q < p.Sq ? p.lse[i] : 0.f;
        sD[threadIdx.x] = q < p.Sq ? p.delta[i] : 0.f;
      }
      __syncthreads();
      float s[8], dp[8];
      dots8<HD>(s, dp, sK, sQ, sV, sO, r, c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qc = c + 4 * i;
        const float pv = visible(p, q0 + qc, k0 + r) ? expf(s[i] * p.scale - sL[qc]) : 0.f;
        sP[r][qc] = pv;
        sS[r][qc] = pv * (dp[i] - sD[qc]);
      }
      __syncthreads();
      for (int qc = 0; qc < kRowsF; ++qc) {
        const float pv = sP[r][qc], ds = sS[r][qc];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          dv[i] = fmaf(pv, sO[qc * C::LDF + c + 4 * i], dv[i]);
          dk[i] = fmaf(ds, sQ[qc * C::LDF + c + 4 * i], dk[i]);
        }
      }
    }
  }
  if (k0 + r < p.Sk) {
    float* dkp = (float*)p.dk + b * p.dk_sb + (long long)(k0 + r) * p.dk_ss + hk * p.dk_sh;
    float* dvp = (float*)p.dv + b * p.dv_sb + (long long)(k0 + r) * p.dv_ss + hk * p.dv_sh;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      dkp[c + 4 * i] = dk[i] * p.scale;
      dvp[c + 4 * i] = dv[i];
    }
  }
}

// dQ of 32 query rows of one head; thread (r = tid / 4, c = tid % 4) computes
// the scores of row r against keys c, c + 4, ..., then owns dQ[r][c + 4i].
template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32(const BwdParams p) {
  using C = F32Cfg<HD>;
  constexpr int NI = HD / 4;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sO = sQ + C::TILE;
  float* sK = sO + C::TILE;
  float* sV = sK + C::TILE;
  __shared__ float sS[kRowsF][kRowsF + 1];

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowsF;
  const int hk = h / (p.Hq / p.Hkv);
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  load_tile_f32<HD>(sQ, (const float*)p.q + b * p.q_sb + q0 * p.q_ss + h * p.q_sh, p.q_ss,
                    p.Sq - q0);
  load_tile_f32<HD>(sO, (const float*)p.dout + b * p.do_sb + q0 * p.do_ss + h * p.do_sh, p.do_ss,
                    p.Sq - q0);
  const int row = q0 + r;
  const long long li = ((long long)b * p.Hq + h) * p.Sq + row;
  const float lse = row < p.Sq ? p.lse[li] : 0.f;
  const float dd = row < p.Sq ? p.delta[li] : 0.f;
  float dq[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) dq[i] = 0.f;

  int n_kt = (p.Sk + kRowsF - 1) / kRowsF;
  if (p.causal) {
    const int upto = (min(q0 + kRowsF, p.Sq) - 1) / kRowsF + 1;
    n_kt = upto < n_kt ? upto : n_kt;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kRowsF;
    __syncthreads();
    load_tile_f32<HD>(sK, (const float*)p.k + b * p.k_sb + k0 * p.k_ss + hk * p.k_sh, p.k_ss,
                      p.Sk - k0);
    load_tile_f32<HD>(sV, (const float*)p.v + b * p.v_sb + k0 * p.v_ss + hk * p.v_sh, p.v_ss,
                      p.Sk - k0);
    __syncthreads();
    float s[8], dp[8];
    dots8<HD>(s, dp, sQ, sK, sO, sV, r, c);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kc = c + 4 * i;
      const float pv = visible(p, row, k0 + kc) ? expf(s[i] * p.scale - lse) : 0.f;
      sS[r][kc] = pv * (dp[i] - dd);
    }
    __syncthreads();
    for (int kc = 0; kc < kRowsF; ++kc) {
      const float ds = sS[r][kc];
#pragma unroll
      for (int i = 0; i < NI; ++i) dq[i] = fmaf(ds, sK[kc * C::LDF + c + 4 * i], dq[i]);
    }
  }
  if (row < p.Sq) {
    float* dqp = (float*)p.dq + b * p.dq_sb + (long long)row * p.dq_ss + h * p.dq_sh;
#pragma unroll
    for (int i = 0; i < NI; ++i) dqp[c + 4 * i] = dq[i] * p.scale;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  // the attribute sticks to the function; setting it on every call is cheap
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
int launch(const BwdParams& p, int is_bf16, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.Sq * p.Hq;
  if ((rows + 7) / 8 > 2147483647LL) return -2;
  const dim3 delta_grid((unsigned)((rows + 7) / 8));
  cudaError_t e;
  if (is_bf16) {
    bwd_delta<__nv_bfloat16><<<delta_grid, 256, 0, stream>>>(p, HD);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    constexpr int smem = Bf16Cfg<HD>::SMEM;
    if ((e = allow_smem(flash_bwd_dkdv_bf16<HD>, smem)) != cudaSuccess) return (int)e;
    if ((e = allow_smem(flash_bwd_dq_bf16<HD>, smem)) != cudaSuccess) return (int)e;
    flash_bwd_dkdv_bf16<HD>
        <<<dim3((p.Sk + kRows - 1) / kRows, p.Hkv, p.B), 128, smem, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    flash_bwd_dq_bf16<HD><<<dim3((p.Sq + kRows - 1) / kRows, p.Hq, p.B), 128, smem, stream>>>(p);
    return (int)cudaGetLastError();
  }
  bwd_delta<float><<<delta_grid, 256, 0, stream>>>(p, HD);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  constexpr int smem = F32Cfg<HD>::SMEM;
  if ((e = allow_smem(flash_bwd_dkdv_f32<HD>, smem)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(flash_bwd_dq_f32<HD>, smem)) != cudaSuccess) return (int)e;
  flash_bwd_dkdv_f32<HD>
      <<<dim3((p.Sk + kRowsF - 1) / kRowsF, p.Hkv, p.B), 128, smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_f32<HD><<<dim3((p.Sq + kRowsF - 1) / kRowsF, p.Hq, p.B), 128, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0, a cudaError_t from a launch, or -1 / -2 for a shape this file
// does not take.  `delta` is an fp32 (B, Hq, Sq) scratch buffer.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int Hq,
    int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh, long long dk_sb,
    long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int causal, int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -2;
  if (Hq > 65535 || B > 65535) return -2;
  BwdParams p{q,     k,     v,     o,     dout,  lse,   delta, dq,    dk,    dv,    B,
              Sq,    Sk,    Hq,    Hkv,   q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,  v_sb,
              v_ss,  v_sh,  o_sb,  o_ss,  o_sh,  do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh,
              dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale, causal};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 64: return launch<64>(p, is_bf16, s);
    case 80: return launch<80>(p, is_bf16, s);
    case 128: return launch<128>(p, is_bf16, s);
    default: return -1;
  }
}
