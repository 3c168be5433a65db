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
//   P  = exp(q.k^T * scale - lse)            recomputed tile by tile, with the
//                                            forward's masks (k_pos < Sk; if
//                                            causal, k_pos <= q_pos; with a
//                                            window, k_pos > q_pos - window)
//                                            as P = 0
//   dV = P^T dO
//   dS = P * (dO V^T - D)
//   dQ = dS K * scale,   dK = dS^T Q * scale
//
// and sums dK and dV over the Hq / Hkv query heads that read one KV head.
//
// Scheme: two kernels after the D pass, so that no two blocks write the same
// output and no atomics are needed (the result is deterministic, two calls
// give bit-equal gradients, and the grouped-query sum needs no second pass):
//   * dK/dV: a work item is (batch, KV head, 128-key tile); it walks every
//     query head of the group and every q tile that can see its keys (from
//     the diagonal on, if causal), and keeps dK and dV in registers;
//   * dQ: a work item is (batch, query head, q tile); it walks the key tiles
//     up to the diagonal and keeps dQ in registers.
// Both recompute S and dP = dO V^T: seven products where five would do with
// dQ summed by atomics (the bound at llama3.2-1b's training shape is 0.243 ms
// for the seven, 0.174 ms for the five).  With a sliding window (mixtral's;
// causal only) both walks are cut at both ends: a key tile's queries run from
// its first key to its last key + window - 1, a q tile's keys from its first
// row - window + 1 to the diagonal; the tiles at the window's edge are masked
// like the diagonal ones, and a tile none of a warpgroup's rows can see goes
// through the products with P = 0, as above the diagonal.
//
// What bounds it on this card.  At llama3.2-1b's training shape (B 4, S 2048,
// 32 query heads, 8 KV heads, hd 64, bf16, causal) the seven products are
// 240 GFLOP on 168 MB, far above the ~295 operations a byte where an H100
// turns tensor-core-bound (0.243 ms at 989 TFLOP/s); next come the
// 2 x 268 M exponentials of P (about 0.15 ms of the SFUs, 16 a clock an SM).
// So the design keeps the tensor cores fed and puts the recompute beside them:
//   * bf16, hd 64 and 128: warp-specialised, persistent, TMA + wgmma.  A block
//     of 384 threads: warpgroups 0 and 1 compute, one thread of warpgroup 2
//     produces.  The dK/dV kernel keeps its 128 keys of K and V resident in
//     shared memory (two slots, so the next item's K and V load while this one
//     finishes), 64 keys to each consumer warpgroup, and streams (query head,
//     64-row q tile) pairs through a ring of 4 stages (hd 64) or 2 (hd 128):
//     Q and dO by TMA, the tile's lse * log2(e) and D by a bulk copy from the
//     D pass's scratch (rows padded to 128), all on one full mbarrier a stage,
//     and a free mbarrier that the consumer warps arrive on.  A step is four
//     wgmma: S^T = K.Q^T and dP^T = V.dO^T (m64n64k16, both operands in shared
//     memory, K-major), then P^T = exp2(S^T scale log2(e) - lse) and dS^T =
//     P^T (dP^T - D) in registers, rounded to bf16 as the register A operand
//     of dV += P^T.dO and dK += dS^T.Q, dO and Q read through the transposed
//     (MN-major) descriptor.  The dQ kernel is the mirror: Q, dO (128 rows, 64
//     to each warpgroup), lse and D resident, 64-key tiles of K and V through
//     the ring, three wgmma a step (S = Q.K^T, dP = dO.V^T, dQ += dS.K).  A
//     step's S and dP are two commit groups: the exponentials run once S is in,
//     while dP is still on the tensor cores.  At hd 64 a step's dK/dV (dQ)
//     products are issued after the next step's S and dP (the first step of an
//     item is peeled off), so the exponentials also overlap them; at hd 128
//     they are issued at the step's end, and the dK/dV kernel waits for them
//     there (dK and dV hold 128 registers a thread; no spills).  Every wgmma
//     and every wait lies on the path of every step: one issued or waited for
//     on a data-dependent path makes ptxas serialise every wgmma of the
//     function (info C7518 / C7520, which `-Xptxas -v` prints as info, not as
//     a warning), so a tile that a warpgroup cannot see (above the diagonal,
//     or past Sk / Sq) goes through the products with P = 0 in place of the
//     exponentials.  setmaxnreg gives the consumers 232 registers and the
//     producer 40 (the block's 384 x 168 from its launch; asking for more
//     waits forever).  The mask runs only on tiles that cross the diagonal
//     or the ragged ends (TMA zero-fills rows past Sq / Sk; those rows still
//     get P = 0).  dK is scaled in the epilogue; results are staged in the
//     warpgroup's own rows of the resident tile and written with 16-byte
//     stores of the rows < Sk (< Sq).  Both grids are one block an SM walking
//     items longest first, dealt out in alternating order round by round,
//     which evens the causal items' lengths out across SMs.  The 4-D TMA maps
//     are built per call from the strides, before the D pass is launched so
//     that the three launches follow each other on the card (rows 16-byte
//     aligned, as the wrapper checks; a size-1 dimension gets a substitute
//     stride); -3 is returned when cuTensorMapEncodeTiled refuses one.  A barrier phase
//     off by one hangs the call: run a first check under `timeout`.
//   * bf16, hd 80 (zamba2's shared block, not trained yet): the first
//     design's `mma.sync.m16n8k16` kernels, blocks of 4 warps per 64-row tile with
//     synchronous 16-byte loads; 80 columns are not a whole number of the
//     128-byte boxes the kernels above are built on.
//   * fp32: plain FMAs (no TF32, for the reference's fp32 tolerance), blocks
//     of 32 rows, every product through shared memory.  This path serves
//     checks and small fp32 models.
//
// Plain C interface (no PyTorch headers): the wrapper in
// repro_torch/kernels/flash_attention.py passes raw pointers, element strides
// and the stream, and raises on a non-zero return.  The Hopper helpers (TMA,
// mbarrier, wgmma, tensor maps) are shared with the forward in csrc/hopper.cuh.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // (B, Hq, Sq), contiguous
  float* delta;        // (B, Hq, Sqp): D = rowsum(dO * O), 0 past Sq
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
  int Sqp;             // Sq rounded up to 128
  float* lse2;         // (B, Hq, Sqp): lse * log2(e), 0 past Sq; after delta in the scratch
  int window;          // > 0: key > q - window as well (causal only), 0: no window
};

// Offset of row 0 of (batch b, head h) in delta and lse2.
__device__ __forceinline__ long long row_base(const BwdParams& p, int b, int h) {
  return ((long long)b * p.Hq + h) * p.Sqp;
}

// The window is a template parameter W of every kernel (W = p.window > 0,
// chosen in `launch`), so that the build without one is the code of the
// kernels before the window came: no window test and no extra tile bound in
// the causal path.
template <bool W>
__device__ __forceinline__ bool visible(const BwdParams& p, int q, int key) {
  return q < p.Sq && key < p.Sk && (!p.causal || key <= q) && (!W || key > q - p.window);
}

// One past the last q tile (of `rows` rows) whose queries can see a key of
// [k0, k0 + n): with a window the last such query is k0 + n - 1 + window - 1.
template <bool W>
__device__ __forceinline__ int q_tiles_end(const BwdParams& p, int k0, int n, int rows) {
  const int n_qt = (p.Sq + rows - 1) / rows;
  if constexpr (!W) {
    return n_qt;
  } else {
    const long long e = ((long long)k0 + n - 1 + p.window - 1) / rows + 1;
    return e < n_qt ? (int)e : n_qt;
  }
}

// The first key tile (of `rows` keys) a query of [q0, ...) can see: with a
// window the tile holding key q0 - window + 1, else 0.  Never past `end` - 1,
// so that a q tile always walks one tile (the wrapper refuses the shapes,
// Sq > Sk with a window, where a row could see no key at all).
template <bool W>
__device__ __forceinline__ int k_tiles_first(const BwdParams& p, int q0, int rows, int end) {
  if constexpr (!W) {
    return 0;
  } else {
    const int k = q0 - p.window + 1;
    const int t = k > 0 ? k / rows : 0;
    return t < end - 1 ? t : end - 1;
  }
}

// ---------------------------------------------------------------------------
// D = rowsum(dO * O) and lse * log2(e), rows padded to Sqp with zeros: 16-byte
// loads, a power-of-two group of lanes per row
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, float acc) {
  const float* x = reinterpret_cast<const float*>(&a);
  const float* y = reinterpret_cast<const float*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc = fmaf(x[i], y[i], acc);
  return acc;
}
__device__ __forceinline__ float dot16_bf16(const uint4& a, const uint4& b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, fmaf(u.y, w.y, acc));
  }
  return acc;
}

template <typename T, int HD>
struct DeltaCfg {
  static constexpr int CPR = HD * (int)sizeof(T) / 16;                   // 16-byte chunks a row
  static constexpr int LPR = CPR <= 8 ? 8 : (CPR <= 16 ? 16 : 32);       // lanes a row
  static constexpr int ROWS_PER_BLOCK = 8 * (32 / LPR);                  // 8 warps
};

template <typename T, int HD>
__global__ void __launch_bounds__(256) bwd_delta(const BwdParams p) {
  using C = DeltaCfg<T, HD>;
  const long long n_rows = (long long)p.B * p.Sqp * p.Hq;
  const long long row = (long long)blockIdx.x * C::ROWS_PER_BLOCK + threadIdx.x / C::LPR;
  const int lane = threadIdx.x % C::LPR;
  float acc = 0.f;
  int b = 0, s = 0, h = 0;
  if (row < n_rows) {
    h = (int)(row % p.Hq);
    const long long bs = row / p.Hq;
    s = (int)(bs % p.Sqp);
    b = (int)(bs / p.Sqp);
  }
  if (s < p.Sq && row < n_rows) {
    const uint4* o = reinterpret_cast<const uint4*>((const T*)p.o + b * p.o_sb + s * p.o_ss +
                                                    h * p.o_sh);
    const uint4* d = reinterpret_cast<const uint4*>((const T*)p.dout + b * p.do_sb +
                                                    s * p.do_ss + h * p.do_sh);
    for (int c = lane; c < C::CPR; c += C::LPR)
      acc = sizeof(T) == 2 ? dot16_bf16(o[c], d[c], acc) : dot16(o[c], d[c], acc);
  }
#pragma unroll
  for (int off = C::LPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < n_rows && lane == 0) {
    const long long i = row_base(p, b, h) + s;
    p.delta[i] = acc;
    p.lse2[i] = s < p.Sq ? p.lse[((long long)b * p.Hq + h) * p.Sq + s] * kLog2e : 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16, hd 80: mma.sync m16n8k16, bf16 operands, fp32 sums (the first design's kernels)
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
template <int HD, bool W>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_mma(const BwdParams p) {
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
  const int n_qt = q_tiles_end<W>(p, k0, kRows, kRows);  // later q tiles: past the window
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
        const long long i = row_base(p, b, h) + q;   // q < Sqp
        sL[threadIdx.x] = p.lse2[i];
        sD[threadIdx.x] = p.delta[i];
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
          const float pv = visible<W>(p, q0 + qc, key) ? exp2f(fmaf(s[j][i], c2, -sL[qc])) : 0.f;
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
template <int HD, bool W>
__global__ void __launch_bounds__(128) flash_bwd_dq_mma(const BwdParams p) {
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
  const long long li = row_base(p, b, h);           // rows < Sqp
  const float l_lo = p.lse2[li + row_lo], l_hi = p.lse2[li + row_hi];
  const float d_lo = p.delta[li + row_lo], d_hi = p.delta[li + row_hi];

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
  for (int kt = k_tiles_first<W>(p, q0, kRows, n_kt); kt < n_kt; ++kt) {
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
        const float pv = visible<W>(p, hi ? row_hi : row_lo, key)
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
// bf16, hd 64 and 128: TMA + mbarrier ring + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kThreadsWg = 384;  // warpgroups 0, 1 consume; one thread of warpgroup 2 produces
constexpr int kResRows = 128;    // rows of a resident tile: K, V (dK/dV kernel); Q, dO (dQ kernel)
constexpr int kRingRows = 64;    // rows of a streamed tile: Q, dO (dK/dV kernel); K, V (dQ kernel)

template <int HD>
struct WgCfg {
  static constexpr int NCH = HD / 64;                 // 128-byte chunks of a row
  static constexpr int KSTEPS = HD / 16;              // k16 steps over hd
  static constexpr int RES_CHUNK = kResRows * 128;    // bytes of a chunk of a resident tile
  static constexpr int RING_CHUNK = kRingRows * 128;  // bytes of a chunk of a streamed tile
  static constexpr int RES_TILE = NCH * RES_CHUNK;
  static constexpr int RING_TILE = NCH * RING_CHUNK;
  static constexpr int SLOTS = 2;                     // resident pairs (K and V, or Q and dO)
  static constexpr int STAGES = NCH == 1 ? 4 : 2;     // ring depth
  static constexpr int SMEM = SLOTS * 2 * RES_TILE + STAGES * 2 * RING_TILE + 1024;
  // When a step's dK/dV (dQ) products are issued (see the consumers): after
  // the next step's S and dP at hd 64 (DEFER); at hd 128 at the step's end,
  // where the dK/dV kernel, whose dK and dV hold 128 registers a thread, also
  // waits for them, so that P^T, dS^T and S^T, dP^T are never live together.
  // hd 128's dQ measured faster on an H100 without deferring.
  static constexpr bool DEFER = NCH == 1;
};
// Registers a thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 = 384 x 168, what
// the block holds from its launch (setmaxnreg.inc waits for registers that no
// warp has freed).
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

// Item r of this block: items are numbered longest first and dealt out in
// rounds of gridDim.x, every other round in reverse, so that a block that drew
// a long item in one round draws a short one in the next.  -1 past the end.
__device__ __forceinline__ int nth_item(int r, int n_items) {
  const int i = r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return i < n_items ? i : -1;
}

// One entry of P: exp(s * scale - lse) with c2 = scale * log2(e), l2 = lse * log2(e).
__device__ __forceinline__ float prob(float s, float c2, float l2) {
  return ex2(fmaf(s, c2, -l2));
}

// X (64 x 64) = A (64 rows of a resident tile) . B (64 rows of a ring tile)^T,
// the k dimension running over hd; both operands K-major.
template <int HD>
__device__ __forceinline__ void issue_ss(float (&x)[32], const uint8_t* a, const uint8_t* b) {
  using C = WgCfg<HD>;
#pragma unroll
  for (int kk = 0; kk < C::KSTEPS; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_m64n64k16_ss(x, sw128_desc(a + c * C::RES_CHUNK + off, 16, 1024),
                       sw128_desc(b + c * C::RING_CHUNK + off, 16, 1024), kk > 0);
  }
}

// acc (64 x hd) += X (64 x 64, bf16 A fragments in registers) . B (a ring
// tile, its 64 rows the k dimension), B read through the transposed descriptor.
template <int HD>
__device__ __forceinline__ void issue_rs(float (&acc)[WgCfg<HD>::NCH][32],
                                         const uint32_t (&a)[4][4], const uint8_t* b) {
  using C = WgCfg<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
      wgmma_m64n64k16_rs(acc[c], a[kk], sw128_desc(b + c * C::RING_CHUNK + kk * 2048, 1024, 1024));
}

template <int HD>
__device__ __forceinline__ void fence_acc(float (&acc)[WgCfg<HD>::NCH][32]) {
#pragma unroll
  for (int c = 0; c < WgCfg<HD>::NCH; ++c) reg_fence(acc[c]);
}

// A warpgroup's 64 x hd result, times `mul`, into rows 0..63 of a swizzled
// tile region (chunk stride RES_CHUNK), as bf16.  Thread rows w4 * 16 + g (+ 8).
template <int HD>
__device__ __forceinline__ void stage_rows(uint8_t* dst, const float (&acc)[WgCfg<HD>::NCH][32],
                                           float mul, int w4, int g, int t4) {
  const int r_lo = w4 * 16 + g, r_hi = r_lo + 8;   // r_hi & 7 == r_lo & 7
#pragma unroll
  for (int c = 0; c < WgCfg<HD>::NCH; ++c) {
    uint8_t* base = dst + c * WgCfg<HD>::RES_CHUNK;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int byte = ((nt ^ (r_lo & 7)) << 4) + t4 * 4;
      *reinterpret_cast<uint32_t*>(base + r_lo * 128 + byte) =
          pack_bf16(acc[c][4 * nt] * mul, acc[c][4 * nt + 1] * mul);
      *reinterpret_cast<uint32_t*>(base + r_hi * 128 + byte) =
          pack_bf16(acc[c][4 * nt + 2] * mul, acc[c][4 * nt + 3] * mul);
    }
  }
}

// Rows 0..63 of a staged region to global memory, 16-byte stores, rows
// row0 + rr < n_rows only; the 128 threads of one warpgroup.
template <int HD>
__device__ __forceinline__ void store_staged(__nv_bfloat16* out, long long stride,
                                             const uint8_t* src, int row0, int n_rows) {
  constexpr int CPR = HD / 8;  // 16-byte chunks of a row
  for (int j = threadIdx.x & 127; j < 64 * CPR; j += 128) {
    const int rr = j / CPR, cc = j % CPR;
    if (row0 + rr >= n_rows) continue;
    const uint8_t* s =
        src + (cc >> 3) * WgCfg<HD>::RES_CHUNK + rr * 128 + (((cc & 7) ^ (rr & 7)) << 4);
    *reinterpret_cast<uint4*>(out + (long long)(row0 + rr) * stride + cc * 8) =
        *reinterpret_cast<const uint4*>(s);
  }
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// This warp is done with a barrier-guarded buffer.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// P (or P^T) of a 64 x 64 tile in place of the scores in x.  Thread rows are
// row_lo, row_lo + 8 (lse * log2(e): l_row[0], l_row[1]), its columns
// col0 + nt * 8 + 2 t4 (+ 1) (lse * log2(e): l_col[nt * 8 + 2 t4 (+ 1)]).  The
// kernel's rows are query rows (dQ) or keys (dK/dV, where lse goes by column):
// KEYS_ARE_ROWS picks the lse and the mask's orientation.
template <bool KEYS_ARE_ROWS, bool MASK, bool W>
__device__ __forceinline__ void probs(float (&x)[32], const BwdParams& p, float c2,
                                      const float* l_col, const float (&l_row)[2], int row_lo,
                                      int col0, int t4) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float2 lc = make_float2(0.f, 0.f);
    if (KEYS_ARE_ROWS) lc = *reinterpret_cast<const float2*>(l_col + nt * 8 + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = KEYS_ARE_ROWS ? ((e & 1) ? lc.y : lc.x) : l_row[e >> 1];
      float pr = prob(x[4 * nt + e], c2, l);
      if (MASK) {
        const int row = row_lo + ((e & 2) ? 8 : 0), col = col0 + nt * 8 + 2 * t4 + (e & 1);
        if (KEYS_ARE_ROWS ? !visible<W>(p, col, row) : !visible<W>(p, row, col)) pr = 0.f;
      }
      x[4 * nt + e] = pr;
    }
  }
}

// dS = P (dP - D) (or its transpose) as bf16 A fragments, and with PF also P,
// packed together so that each n8 tile's fp32 values die as its fragments are
// made.  D by column (d_col, dK/dV) or by row (d_row, dQ).
template <bool KEYS_ARE_ROWS, bool PF>
__device__ __forceinline__ void fragments(const float (&x)[32], const float (&dp)[32],
                                          uint32_t (&pf)[4][4], uint32_t (&df)[4][4],
                                          const float* d_col, const float (&d_row)[2], int t4) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float d[4];
    if (KEYS_ARE_ROWS) {
      const float2 dc = *reinterpret_cast<const float2*>(d_col + nt * 8 + 2 * t4);
      d[0] = d[2] = dc.x;
      d[1] = d[3] = dc.y;
    } else {
      d[0] = d[1] = d_row[0];
      d[2] = d[3] = d_row[1];
    }
    const int kk = nt >> 1, j = (nt & 1) * 2;
    if (PF) {
      pf[kk][j] = pack_bf16(x[4 * nt], x[4 * nt + 1]);
      pf[kk][j + 1] = pack_bf16(x[4 * nt + 2], x[4 * nt + 3]);
    }
    df[kk][j] = pack_bf16(x[4 * nt] * (dp[4 * nt] - d[0]), x[4 * nt + 1] * (dp[4 * nt + 1] - d[1]));
    df[kk][j + 1] =
        pack_bf16(x[4 * nt + 2] * (dp[4 * nt + 2] - d[2]), x[4 * nt + 3] * (dp[4 * nt + 3] - d[3]));
  }
}

// dK/dV work item: (batch, KV head, 128-key tile), long (early) key tiles
// first; it walks query heads h0 .. h1 - 1 and q tiles qt0 .. n_qt - 1 (n_qt:
// one past the last q tile that sees one of its keys).
struct KvItem {
  int b, hk, k0, h0, h1, qt0, n_qt;
};
template <bool W>
__device__ __forceinline__ KvItem kv_item(const BwdParams& p, int i) {
  const int bh = p.B * p.Hkv, rem = i % bh, group = p.Hq / p.Hkv;
  KvItem w;
  w.b = rem / p.Hkv;
  w.hk = rem % p.Hkv;
  w.k0 = (i / bh) * kResRows;
  w.h0 = w.hk * group;
  w.h1 = w.h0 + group;
  w.n_qt = q_tiles_end<W>(p, w.k0, kResRows, kRingRows);
  w.qt0 = p.causal ? w.k0 / kRingRows : 0;  // earlier q tiles see none of these keys
  return w;
}

template <int HD, bool W>
__global__ void __launch_bounds__(kThreadsWg, 1)
    flash_bwd_dkdv_wg(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                      const BwdParams p) {
  using C = WgCfg<HD>;
  constexpr int NCH = C::NCH, STAGES = C::STAGES;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_res[C::SLOTS], bar_res_free[C::SLOTS];
  __shared__ __align__(8) uint64_t bar_full[STAGES], bar_free[STAGES];
  __shared__ __align__(16) float sL[STAGES][kRingRows], sD[STAGES][kRingRows];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sRes = smem;                                 // [SLOTS][K, V][NCH][128 rows][128 B]
  uint8_t* sRing = sRes + C::SLOTS * 2 * C::RES_TILE;   // [STAGES][Q, dO][NCH][64 rows][128 B]

  const int n_items = ((p.Sk + kResRows - 1) / kResRows) * p.B * p.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::SLOTS; ++s) {
      mbar_init(&bar_res[s], 1);
      mbar_init(&bar_res_free[s], 8);      // lane 0 of every consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_free[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer: one thread keeps K, V and the ring (Q, dO, lse2, D) full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int it = 0, k = 0;
      for (int r = 0;; ++r, ++k) {
        const int i = nth_item(r, n_items);
        if (i < 0) break;
        const KvItem w = kv_item<W>(p, i);
        const int slot = k % C::SLOTS;
        if (k >= C::SLOTS) mbar_wait(&bar_res_free[slot], ((k / C::SLOTS) - 1) & 1);
        uint8_t* dst = sRes + slot * 2 * C::RES_TILE;
        mbar_expect_tx(&bar_res[slot], 2 * C::RES_TILE);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(dst + c * C::RES_CHUNK, &tk, &bar_res[slot], c * 64, w.hk, w.k0, w.b);
          tma_load_4d(dst + C::RES_TILE + c * C::RES_CHUNK, &tv, &bar_res[slot], c * 64, w.hk,
                      w.k0, w.b);
        }
        for (int h = w.h0; h < w.h1; ++h) {
          const long long rb = row_base(p, w.b, h);
          for (int qt = w.qt0; qt < w.n_qt; ++qt, ++it) {
            const int s = it % STAGES, q0 = qt * kRingRows;
            if (it >= STAGES) mbar_wait(&bar_free[s], ((it / STAGES) - 1) & 1);
            uint8_t* d2 = sRing + s * 2 * C::RING_TILE;
            mbar_expect_tx(&bar_full[s], 2 * C::RING_TILE + 2 * kRingRows * 4);
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
              tma_load_4d(d2 + c * C::RING_CHUNK, &tq, &bar_full[s], c * 64, h, q0, w.b);
              tma_load_4d(d2 + C::RING_TILE + c * C::RING_CHUNK, &tdo, &bar_full[s], c * 64, h,
                          q0, w.b);
            }
            bulk_load(sL[s], p.lse2 + rb + q0, kRingRows * 4, &bar_full[s]);   // q0 + 64 <= Sqp
            bulk_load(sD[s], p.delta + rb + q0, kRingRows * 4, &bar_full[s]);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2, w4 = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const float c2 = p.scale * kLog2e;
    const float none[2] = {0.f, 0.f};
    float dk[NCH][32], dv[NCH][32], x[32], dp[32];
    uint32_t pf[4][4], df[4][4];  // P^T and dS^T of the pending step, bf16 A fragments
    int it = 0, k = 0;

    for (int r = 0;; ++r, ++k) {
      const int i = nth_item(r, n_items);
      if (i < 0) break;
      const KvItem w = kv_item<W>(p, i);
      const int slot = k % C::SLOTS;
      const int wk0 = w.k0 + wg * 64;                 // this warpgroup's first key
      const int key_lo = wk0 + w4 * 16 + g;
      uint8_t* sK = sRes + slot * 2 * C::RES_TILE + wg * 8192;  // this warpgroup's 64 rows
      uint8_t* sV = sK + C::RES_TILE;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 32; ++j) dk[c][j] = dv[c][j] = 0.f;
      // A step issues S^T and dP^T as two commit groups, then the last step's
      // dV += P^T.dO and dK += dS^T.Q: the exponentials wait for S^T alone
      // and run while dP^T and those products are on the tensor cores.  Every
      // wgmma and every wait of the loop body is on the path of every step:
      // ptxas serialises all the wgmma of a function that issues or waits for
      // one on a data-dependent path (info C7518 / C7520).  So the first step
      // is peeled off, and a q tile that none of this warpgroup's keys can see
      // goes through the products too, with P^T = 0 in place of the
      // exponentials.
      mbar_wait(&bar_res[slot], (k / C::SLOTS) & 1);
      const int nq = w.n_qt - w.qt0;                  // steps of one query head
      const int n_steps = (w.h1 - w.h0) * nq;
      int pend = 0;  // the stage whose P^T, dS^T wait for their products
      auto fence_pending = [&]() {
        fence_acc<HD>(dk);
        fence_acc<HD>(dv);
        reg_fence(pf);
        reg_fence(df);
      };
      auto issue_pending = [&]() {
        const uint8_t* prev = sRing + pend * 2 * C::RING_TILE;
        fence_pending();
        wgmma_fence();
        issue_rs<HD>(dv, pf, prev + C::RING_TILE);         // dV += P^T.dO
        issue_rs<HD>(dk, df, prev);                        // dK += dS^T.Q
        wgmma_commit();
      };
      auto retire_pending = [&]() {
        wgmma_wait<0>();
        fence_pending();
        release(&bar_free[pend], lane);
      };
      // S^T and dP^T of step n on stage s, with the pending products after
      // them unless FIRST
      auto issue_step = [&](auto first, const uint8_t* tile) {
        reg_fence(x);
        reg_fence(dp);
        wgmma_fence();
        issue_ss<HD>(x, sK, tile);                         // S^T = K.Q^T
        wgmma_commit();
        issue_ss<HD>(dp, sV, tile + C::RING_TILE);         // dP^T = V.dO^T
        wgmma_commit();
        if constexpr (!decltype(first)::value) issue_pending();
      };
      // P^T in place of S^T in x (0 for a tile no key of this warpgroup sees)
      auto make_probs = [&](int s, int q0) {
        reg_fence(x);
        if (wk0 >= p.Sk || (p.causal && q0 + kRingRows - 1 < wk0) ||
            (W && q0 - (wk0 + 63) >= p.window)) {
#pragma unroll
          for (int j = 0; j < 32; ++j) x[j] = 0.f;
        } else if (q0 + kRingRows > p.Sq || wk0 + 64 > p.Sk || (p.causal && q0 < wk0 + 63) ||
                   (W && q0 + kRingRows - 1 - wk0 >= p.window)) {
          probs<true, true, W>(x, p, c2, sL[s], none, key_lo, q0, t4);
        } else {
          probs<true, false, W>(x, p, c2, sL[s], none, key_lo, q0, t4);
        }
      };
      if constexpr (!C::DEFER) {
        // hd 128: each step's own products are issued and waited for at its end
        for (int n = 0; n < n_steps; ++n, ++it) {
          const int s = it % STAGES, q0 = (w.qt0 + n % nq) * kRingRows;
          mbar_wait(&bar_full[s], (it / STAGES) & 1);
          issue_step(std::true_type{}, sRing + s * 2 * C::RING_TILE);
          wgmma_wait<1>();                                 // S^T
          make_probs(s, q0);
          wgmma_wait<0>();                                 // dP^T
          reg_fence(dp);
          fragments<true, true>(x, dp, pf, df, sD[s], none, t4);
          pend = s;
          issue_pending();
          retire_pending();
        }
      } else if (n_steps > 0) {
        auto step = [&](auto first, int n) {
          const int s = it % STAGES, q0 = (w.qt0 + n % nq) * kRingRows;
          mbar_wait(&bar_full[s], (it / STAGES) & 1);
          issue_step(first, sRing + s * 2 * C::RING_TILE);
          if constexpr (decltype(first)::value)
            wgmma_wait<1>();                               // S^T
          else
            wgmma_wait<2>();
          make_probs(s, q0);
          wgmma_wait<0>();                                 // dP^T, the pending products
          reg_fence(dp);
          if constexpr (!decltype(first)::value) {
            fence_pending();
            release(&bar_free[pend], lane);
          }
          fragments<true, true>(x, dp, pf, df, sD[s], none, t4);
          pend = s;
          ++it;
        };
        step(std::true_type{}, 0);
        for (int n = 1; n < n_steps; ++n) step(std::false_type{}, n);
        issue_pending();                                   // the last step's products
        retire_pending();
      }

      // ---- epilogue: dK * scale and dV into this warpgroup's rows of K and V
      // (no wgmma reads them any more), then 16-byte stores of the keys < Sk
      wg_sync(wg);
      stage_rows<HD>(sK, dk, p.scale, w4, g, t4);
      stage_rows<HD>(sV, dv, 1.f, w4, g, t4);
      wg_sync(wg);
      const KvItem e = kv_item<W>(p, i);                 // w's fields, not kept live till here
      store_staged<HD>((__nv_bfloat16*)p.dk + e.b * p.dk_sb + e.hk * p.dk_sh, p.dk_ss, sK, wk0,
                       p.Sk);
      store_staged<HD>((__nv_bfloat16*)p.dv + e.b * p.dv_sb + e.hk * p.dv_sh, p.dv_ss, sV, wk0,
                       p.Sk);
      release(&bar_res_free[slot], lane);
    }
  }
}

// dQ work item: (batch, query head, 128-row q tile), long (late) q tiles
// first; it walks key tiles kt0 .. n_kt - 1.
struct QItem {
  int b, h, q0, kt0, n_kt;
};
template <bool W>
__device__ __forceinline__ QItem q_item(const BwdParams& p, int i) {
  const int bh = p.B * p.Hq, rem = i % bh;
  const int n_qt = (p.Sq + kResRows - 1) / kResRows;
  QItem w;
  w.b = rem / p.Hq;
  w.h = rem % p.Hq;
  w.q0 = (n_qt - 1 - i / bh) * kResRows;
  w.n_kt = (p.Sk + kRingRows - 1) / kRingRows;
  if (p.causal) {
    const int upto = (min(w.q0 + kResRows, p.Sq) - 1) / kRingRows + 1;  // tile of key == last row
    w.n_kt = upto < w.n_kt ? upto : w.n_kt;
  }
  w.kt0 = k_tiles_first<W>(p, w.q0, kRingRows, w.n_kt);
  return w;
}

template <int HD, bool W>
__global__ void __launch_bounds__(kThreadsWg, 1)
    flash_bwd_dq_wg(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const BwdParams p) {
  using C = WgCfg<HD>;
  constexpr int NCH = C::NCH, STAGES = C::STAGES;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_res[C::SLOTS], bar_res_free[C::SLOTS];
  __shared__ __align__(8) uint64_t bar_full[STAGES], bar_free[STAGES];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sRes = smem;                                 // [SLOTS][Q, dO][NCH][128 rows][128 B]
  uint8_t* sRing = sRes + C::SLOTS * 2 * C::RES_TILE;   // [STAGES][K, V][NCH][64 rows][128 B]

  const int n_items = ((p.Sq + kResRows - 1) / kResRows) * p.B * p.Hq;
  const int group = p.Hq / p.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::SLOTS; ++s) {
      mbar_init(&bar_res[s], 1);
      mbar_init(&bar_res_free[s], 8);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_free[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer: one thread keeps Q, dO and the K / V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int it = 0, k = 0;
      for (int r = 0;; ++r, ++k) {
        const int i = nth_item(r, n_items);
        if (i < 0) break;
        const QItem w = q_item<W>(p, i);
        const int hk = w.h / group, slot = k % C::SLOTS;
        if (k >= C::SLOTS) mbar_wait(&bar_res_free[slot], ((k / C::SLOTS) - 1) & 1);
        uint8_t* dst = sRes + slot * 2 * C::RES_TILE;
        mbar_expect_tx(&bar_res[slot], 2 * C::RES_TILE);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(dst + c * C::RES_CHUNK, &tq, &bar_res[slot], c * 64, w.h, w.q0, w.b);
          tma_load_4d(dst + C::RES_TILE + c * C::RES_CHUNK, &tdo, &bar_res[slot], c * 64, w.h,
                      w.q0, w.b);
        }
        for (int kt = w.kt0; kt < w.n_kt; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&bar_free[s], ((it / STAGES) - 1) & 1);
          uint8_t* d2 = sRing + s * 2 * C::RING_TILE;
          mbar_expect_tx(&bar_full[s], 2 * C::RING_TILE);
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            tma_load_4d(d2 + c * C::RING_CHUNK, &tk, &bar_full[s], c * 64, hk, kt * kRingRows,
                        w.b);
            tma_load_4d(d2 + C::RING_TILE + c * C::RING_CHUNK, &tv, &bar_full[s], c * 64, hk,
                        kt * kRingRows, w.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2, w4 = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const float c2 = p.scale * kLog2e;
    float dq[NCH][32], x[32], dp[32];
    uint32_t df[4][4];  // dS of the pending step, bf16 A fragments
    int it = 0, k = 0;

    for (int r = 0;; ++r, ++k) {
      const int i = nth_item(r, n_items);
      if (i < 0) break;
      const QItem w = q_item<W>(p, i);
      const int slot = k % C::SLOTS;
      const int r0 = w.q0 + wg * 64;                  // this warpgroup's first row
      const int row_lo = r0 + w4 * 16 + g;
      const long long rb = row_base(p, w.b, w.h);   // rows < q0 + 128 <= Sqp
      const float l_row[2] = {p.lse2[rb + row_lo], p.lse2[rb + row_lo + 8]};
      const float d_row[2] = {p.delta[rb + row_lo], p.delta[rb + row_lo + 8]};
      uint8_t* sQ = sRes + slot * 2 * C::RES_TILE + wg * 8192;  // this warpgroup's 64 rows
      uint8_t* sO = sQ + C::RES_TILE;                           // dO
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 32; ++j) dq[c][j] = 0.f;
      // As in the dK/dV kernel: S and dP, then, at hd 64 (DEFER), the last
      // step's dQ += dS.K, the first step peeled off (an item has at least one
      // key tile); at hd 128 a step's dQ += dS.K is issued at its end and
      // completes under the next step's first wait.
      mbar_wait(&bar_res[slot], (k / C::SLOTS) & 1);
      int pend = -1;  // the stage whose dS waits for (or is in) its product, or -1
      auto fence_pending = [&]() {
        fence_acc<HD>(dq);
        reg_fence(df);
      };
      auto issue_pending = [&]() {
        fence_pending();
        wgmma_fence();
        issue_rs<HD>(dq, df, sRing + pend * 2 * C::RING_TILE);  // dQ += dS.K
        wgmma_commit();
      };
      auto issue_step = [&](auto with_pending, const uint8_t* tile) {
        reg_fence(x);
        reg_fence(dp);
        wgmma_fence();
        issue_ss<HD>(x, sQ, tile);                         // S = Q.K^T
        wgmma_commit();
        issue_ss<HD>(dp, sO, tile + C::RING_TILE);         // dP = dO.V^T
        wgmma_commit();
        if constexpr (decltype(with_pending)::value) issue_pending();
      };
      // P in place of S in x (0 for a tile no row of this warpgroup sees)
      auto make_probs = [&](int k0) {
        reg_fence(x);
        if (r0 >= p.Sq || (p.causal && k0 > r0 + 63) ||
            (W && r0 - (k0 + kRingRows - 1) >= p.window)) {
#pragma unroll
          for (int j = 0; j < 32; ++j) x[j] = 0.f;
        } else if (r0 + 64 > p.Sq || k0 + kRingRows > p.Sk || (p.causal && k0 + 63 > r0) ||
                   (W && r0 + 63 - k0 >= p.window)) {
          probs<false, true, W>(x, p, c2, nullptr, l_row, row_lo, k0, t4);
        } else {
          probs<false, false, W>(x, p, c2, nullptr, l_row, row_lo, k0, t4);
        }
      };
      if constexpr (C::DEFER) {
        auto step = [&](auto first, int kt) {
          const int s = it % STAGES;
          mbar_wait(&bar_full[s], (it / STAGES) & 1);
          issue_step(std::bool_constant<!decltype(first)::value>{},
                     sRing + s * 2 * C::RING_TILE);
          if constexpr (decltype(first)::value)
            wgmma_wait<1>();                               // S
          else
            wgmma_wait<2>();
          make_probs(kt * kRingRows);
          wgmma_wait<0>();                                 // dP, the last step's product
          reg_fence(dp);
          if constexpr (!decltype(first)::value) {
            fence_pending();
            release(&bar_free[pend], lane);
          }
          fragments<false, false>(x, dp, df, df, nullptr, d_row, t4);
          pend = s;
          ++it;
        };
        step(std::true_type{}, w.kt0);
        for (int kt = w.kt0 + 1; kt < w.n_kt; ++kt) step(std::false_type{}, kt);
        issue_pending();                                   // the last step's product
      } else {
        for (int kt = w.kt0; kt < w.n_kt; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&bar_full[s], (it / STAGES) & 1);
          issue_step(std::false_type{}, sRing + s * 2 * C::RING_TILE);
          wgmma_wait<1>();                                 // S, the last step's product
          fence_pending();
          if (pend >= 0) release(&bar_free[pend], lane);
          make_probs(kt * kRingRows);
          wgmma_wait<0>();                                 // dP
          reg_fence(dp);
          fragments<false, false>(x, dp, df, df, nullptr, d_row, t4);
          pend = s;
          issue_pending();
        }
      }
      wgmma_wait<0>();
      fence_pending();
      release(&bar_free[pend], lane);

      // ---- epilogue: dQ * scale into this warpgroup's rows of Q, then
      // 16-byte stores of the rows < Sq
      wg_sync(wg);
      stage_rows<HD>(sQ, dq, p.scale, w4, g, t4);
      wg_sync(wg);
      store_staged<HD>((__nv_bfloat16*)p.dq + w.b * p.dq_sb + w.h * p.dq_sh, p.dq_ss, sQ, r0,
                       p.Sq);
      release(&bar_res_free[slot], lane);
    }
  }
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
template <int HD, bool W>
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
  const int n_qt = q_tiles_end<W>(p, k0, kRowsF, kRowsF);
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
        sL[threadIdx.x] = q < p.Sq ? p.lse[((long long)b * p.Hq + h) * p.Sq + q] : 0.f;
        sD[threadIdx.x] = p.delta[row_base(p, b, h) + q];   // q < Sqp
      }
      __syncthreads();
      float s[8], dp[8];
      dots8<HD>(s, dp, sK, sQ, sV, sO, r, c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qc = c + 4 * i;
        const float pv = visible<W>(p, q0 + qc, k0 + r) ? expf(s[i] * p.scale - sL[qc]) : 0.f;
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
template <int HD, bool W>
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
  const float lse = row < p.Sq ? p.lse[((long long)b * p.Hq + h) * p.Sq + row] : 0.f;
  const float dd = p.delta[row_base(p, b, h) + row];   // row < Sqp
  float dq[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) dq[i] = 0.f;

  int n_kt = (p.Sk + kRowsF - 1) / kRowsF;
  if (p.causal) {
    const int upto = (min(q0 + kRowsF, p.Sq) - 1) / kRowsF + 1;
    n_kt = upto < n_kt ? upto : n_kt;
  }
  for (int kt = k_tiles_first<W>(p, q0, kRowsF, n_kt); kt < n_kt; ++kt) {
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
      const float pv = visible<W>(p, row, k0 + kc) ? expf(s[i] * p.scale - lse) : 0.f;
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

template <typename T, int HD>
int launch_delta(const BwdParams& p, cudaStream_t stream) {
  using D = DeltaCfg<T, HD>;
  const long long rows = (long long)p.B * p.Sqp * p.Hq;
  const long long blocks = (rows + D::ROWS_PER_BLOCK - 1) / D::ROWS_PER_BLOCK;
  if (blocks > 2147483647LL) return -2;
  bwd_delta<T, HD><<<(unsigned)blocks, 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The D pass and the two warp-specialised kernels, one persistent block an SM
// each; the tensor maps are encoded first, so the three launches follow each
// other on the card without a gap.
template <int HD, bool W>
int launch_wg(const BwdParams& p, cudaStream_t stream) {
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  if (!make_map(&q64, p.q, HD, p.Hq, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, kRingRows) ||
      !make_map(&do64, p.dout, HD, p.Hq, p.Sq, p.B, p.do_sh, p.do_ss, p.do_sb, kRingRows) ||
      !make_map(&k128, p.k, HD, p.Hkv, p.Sk, p.B, p.k_sh, p.k_ss, p.k_sb, kResRows) ||
      !make_map(&v128, p.v, HD, p.Hkv, p.Sk, p.B, p.v_sh, p.v_ss, p.v_sb, kResRows) ||
      !make_map(&q128, p.q, HD, p.Hq, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, kResRows) ||
      !make_map(&do128, p.dout, HD, p.Hq, p.Sq, p.B, p.do_sh, p.do_ss, p.do_sb, kResRows) ||
      !make_map(&k64, p.k, HD, p.Hkv, p.Sk, p.B, p.k_sh, p.k_ss, p.k_sb, kRingRows) ||
      !make_map(&v64, p.v, HD, p.Hkv, p.Sk, p.B, p.v_sh, p.v_ss, p.v_sb, kRingRows))
    return -3;
  constexpr int smem = WgCfg<HD>::SMEM;
  cudaError_t e;
  static bool attr_set = false;
  if (!attr_set) {
    if ((e = allow_smem(flash_bwd_dkdv_wg<HD, W>, smem)) != cudaSuccess) return (int)e;
    if ((e = allow_smem(flash_bwd_dq_wg<HD, W>, smem)) != cudaSuccess) return (int)e;
    attr_set = true;
  }
  static int n_sm = 0;
  if (!n_sm) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long long kv_items = (long long)((p.Sk + kResRows - 1) / kResRows) * p.B * p.Hkv;
  const long long q_items = (long long)((p.Sq + kResRows - 1) / kResRows) * p.B * p.Hq;
  if (q_items > 2147483647LL) return -2;
  if (int err = launch_delta<__nv_bfloat16, HD>(p, stream)) return err;
  flash_bwd_dkdv_wg<HD, W><<<(int)(kv_items < n_sm ? kv_items : n_sm), kThreadsWg, smem, stream>>>(
      q64, do64, k128, v128, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_wg<HD, W><<<(int)(q_items < n_sm ? q_items : n_sm), kThreadsWg, smem, stream>>>(
      q128, do128, k64, v64, p);
  return (int)cudaGetLastError();
}

template <int HD, bool W>
int launch(const BwdParams& p, int is_bf16, cudaStream_t stream) {
  cudaError_t e;
  if (is_bf16) {
    if constexpr (HD % 64 == 0) {
      return launch_wg<HD, W>(p, stream);
    } else {  // hd 80: the mma.sync kernels
      if (int err = launch_delta<__nv_bfloat16, HD>(p, stream)) return err;
      constexpr int smem = Bf16Cfg<HD>::SMEM;
      if ((e = allow_smem(flash_bwd_dkdv_mma<HD, W>, smem)) != cudaSuccess) return (int)e;
      if ((e = allow_smem(flash_bwd_dq_mma<HD, W>, smem)) != cudaSuccess) return (int)e;
      flash_bwd_dkdv_mma<HD, W>
          <<<dim3((p.Sk + kRows - 1) / kRows, p.Hkv, p.B), 128, smem, stream>>>(p);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      flash_bwd_dq_mma<HD, W>
          <<<dim3((p.Sq + kRows - 1) / kRows, p.Hq, p.B), 128, smem, stream>>>(p);
      return (int)cudaGetLastError();
    }
  }
  if (int err = launch_delta<float, HD>(p, stream)) return err;
  constexpr int smem = F32Cfg<HD>::SMEM;
  if ((e = allow_smem(flash_bwd_dkdv_f32<HD, W>, smem)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(flash_bwd_dq_f32<HD, W>, smem)) != cudaSuccess) return (int)e;
  flash_bwd_dkdv_f32<HD, W>
      <<<dim3((p.Sk + kRowsF - 1) / kRowsF, p.Hkv, p.B), 128, smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_f32<HD, W><<<dim3((p.Sq + kRowsF - 1) / kRowsF, p.Hq, p.B), 128, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const BwdParams& p, int is_bf16, cudaStream_t stream) {
  return p.window ? launch<HD, true>(p, is_bf16, stream) : launch<HD, false>(p, is_bf16, stream);
}

}  // namespace

// Returns 0, a cudaError_t from a launch, -1 / -2 for a shape this file does
// not take, or -3 if cuTensorMapEncodeTiled refuses a TMA descriptor (bf16,
// hd 64 / 128).  `delta` is fp32 scratch of 2 x B x Hq x Sqp floats, Sqp = Sq
// rounded up to 128: D, then lse * log2(e), each (B, Hq, Sqp), written by the
// D pass, zero past Sq.  `window` > 0 limits each query to the keys
// q - window < k <= q (with `causal` only), as in the forward.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int Hq,
    int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh, long long dk_sb,
    long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int causal, int window, int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -2;
  if (Hq > 65535 || B > 65535) return -2;
  if (window < 0 || (window > 0 && !causal)) return -2;
  BwdParams p{q,     k,     v,     o,     dout,  lse,   delta, dq,    dk,    dv,    B,
              Sq,    Sk,    Hq,    Hkv,   q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,  v_sb,
              v_ss,  v_sh,  o_sb,  o_ss,  o_sh,  do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh,
              dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale, causal};
  p.Sqp = (Sq + 127) / 128 * 128;
  p.lse2 = delta + (long long)B * Hq * p.Sqp;
  p.window = window;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 64: return launch<64>(p, is_bf16, s);
    case 80: return launch<80>(p, is_bf16, s);
    case 128: return launch<128>(p, is_bf16, s);
    default: return -1;
  }
}
