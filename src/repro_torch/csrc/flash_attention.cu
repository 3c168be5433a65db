// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py (the pallas_call at line 102).  It
// computes the same function: scores q.k^T * scale, mask `k_pos < Sk` and, if
// causal, `k_pos <= q_pos`, applied as the finite value -1e30 (never -inf, so
// no row computes inf - inf), running max / denominator / accumulator in fp32,
// finalise acc / max(l, 1e-30), output in q's dtype.  It also takes the
// model's sliding window (mixtral), which the Pallas kernel does not: with
// `window` > 0 (causal only; the wrapper checks) a key is seen if also
// `k_pos > q_pos - window`, the mask of `_block_mask` in
// src/repro/models/attention.py:83-92.  A q tile then visits only the kv
// tiles from the one holding its first row's first key (q_first - window + 1)
// to the diagonal, and masks the edge tiles.  A row whose first visited tile
// lies wholly outside its window sees only -1e30 there and its running max
// stays -1e30.  The fp32 kernel then takes p = exp(0) = 1 on those masked
// entries, the bf16 kernel p = 0 (see softmax_tile); either is wiped out
// exactly when the tile holding the row's own key (there is always one, the
// diagonal) sets a real max, whose correction exp((-1e30 - m) * c) is 0.
//
// What differs from the TPU kernel, and why.  There the grid is
// (batch*heads, q blocks, kv blocks) and the kv axis runs in order on one core,
// carrying m, l, acc in scratch memory from step to step.  Here blocks run in
// parallel and nothing carries between them: one thread block owns one
// (batch, head, q tile), loops over the kv tiles itself and keeps m, l and the
// accumulator in registers.  The kernel reads (B, S, H, hd) tensors through
// their strides, so the wrapper makes no transposed or padded copies.
// Grouped-query attention reads KV head h / (Hq / Hkv) directly instead of
// repeating K and V in memory.  With a causal mask the loop stops at the
// diagonal: a fully masked tile would add exp(-1e30 - m) = 0, so the result is
// the same as visiting every tile.
//
// What bounds it on this card.  At the serving prefill shape (B 8, S 2048,
// 32 query heads, 8 KV heads, hd 64, bf16, causal) the work is 137 GFLOP on
// 168 MB of q, k, v, o: about 820 operations per byte, far above the ~295
// where an H100 turns from memory- to tensor-core-bound.  So the bound is
// operations (0.139 ms at 989 TFLOP/s), and the design is about keeping the
// tensor cores fed:
//   * bf16, every head dim (64, 80, 128): warp-specialised.  A block of 384
//     threads owns 128 query rows: warpgroups 0 and 1 (64 rows each) compute,
//     one thread of warpgroup 2 issues TMA loads.  Q is loaded once; K and V
//     come in 128-key tiles through a ring of 3 stages (hd 64) or 2 (hd 80,
//     128) guarded by full / free mbarriers, so the next tiles load while this
//     one is multiplied.  The 4-D tensor maps (hd, H, S, B) are built per call
//     from the strides (rows 16-byte aligned, as the wrapper checks) with the
//     128-byte swizzle; a row longer than 128 bytes is two boxes of 64
//     columns, and hd 80's second box is zero-filled past column 80 (those
//     columns add zeros to Q.K^T and are never stored).  TMA zero-fills rows
//     past S; keys past Sk are still masked to -1e30 here, not left at 0.
//     S = Q.K^T is `wgmma` m64n128k16 with both operands in shared memory;
//     the online softmax runs in registers (exp2, scale folded in, the mask
//     only on the diagonal and ragged tiles); P is rounded to bf16 in
//     registers and is the register A operand of O += P.V (`wgmma` m64n64k16
//     per 64 columns of hd), V read through the transposed (MN-major)
//     descriptor.  Tile t's Q.K^T is issued together with tile t-1's P.V, so
//     a warpgroup's softmax overlaps its own P.V, and named barriers make the
//     two warpgroups take turns issuing, so that one's softmax overlaps the
//     other's products.  P alternates between two register sets: a register
//     rewritten while a wgmma may read it makes ptxas serialise every wgmma
//     (warning C7513).  setmaxnreg moves registers from the producer (40) to
//     the consumers (232).  The output is staged in shared memory and
//     written with 16-byte stores of the rows < Sq.  The grid is one
//     persistent block per SM that walks (batch, head, q tile) items, long
//     (late) q tiles first: Q and the K/V ring run on from one item into the
//     next, so an item's last products and its epilogue overlap the next
//     item's loads instead of leaving the SM idle between blocks.
//   * fp32: full fp32 FMAs, no TF32, because the reference's fp32 tolerance
//     (2e-5) does not survive a 10-bit mantissa.  A warp owns 4 query rows;
//     lanes split the 32 keys of a tile for the scores and the head dimension
//     for P.V.  This path serves checks and small fp32 models, not the bf16
//     serving path.
//
// Plain C interface (no PyTorch headers): the wrapper in
// repro_torch/kernels/flash_attention.py passes raw pointers, element strides
// and the stream, and raises on a non-zero return.  The TMA encoder,
// cuTensorMapEncodeTiled, lives in libcuda; it is fetched through the runtime's
// cudaGetDriverEntryPoint, so the library links against the runtime alone.
// The Hopper helpers (mbarriers, TMA, wgmma, tensor maps) are in
// csrc/hopper.cuh, shared with the backward.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, Hq, Sq) fp32 log-sum-exp of the scaled scores, or nullptr: not written
  int B, Sq, Sk, Hq, Hkv;
  // strides in elements: batch, sequence, head (the last dimension has stride 1)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
  int window;  // > 0: key > q - window as well (causal only), 0: no window
};

// One past the last kv tile a q tile has to visit.
__device__ __forceinline__ int kv_tiles(const Params& p, int q_last, int bn) {
  int n = (p.Sk + bn - 1) / bn;
  if (p.causal) {
    int upto = q_last / bn + 1;  // tile holding key == q_last
    n = upto < n ? upto : n;
  }
  return n;
}

// The window is a template parameter W of every kernel (W = p.window > 0,
// chosen in `launch`), so that the build without one is the code of the
// kernels before the window came: no window test, no extra tile bound, no
// offset select left in the causal path.

// The first kv tile a q tile starting at row q_first has to visit: with a
// window the tile holding key q_first - window + 1, else 0.  Never past the
// last tile `end` - 1, so that a tile is always visited (the wrapper refuses
// the shapes, Sq > Sk with a window, where a row could see no key at all).
template <bool W>
__device__ __forceinline__ int kv_first(const Params& p, int q_first, int bn, int end) {
  if constexpr (!W) {
    return 0;
  } else {
    const int k = q_first - p.window + 1;
    const int t = k > 0 ? k / bn : 0;
    return t < end - 1 ? t : end - 1;
  }
}

template <bool W>
__device__ __forceinline__ bool key_allowed(const Params& p, int kpos, int qpos) {
  return kpos < p.Sk && (!p.causal || kpos <= qpos) && (!W || kpos > qpos - p.window);
}


// ---------------------------------------------------------------------------
// fp32: plain FMA
// ---------------------------------------------------------------------------

template <int HD, bool W>
__global__ void __launch_bounds__(128) flash_fwd_f32(const Params p) {
  constexpr int WARPS = 4, R = 4, BM = WARPS * R, BN = 32;
  constexpr int LD = HD + 4;            // row stride in floats: 16-byte rows, distinct banks
  constexpr int NI = (HD + 31) / 32;    // head-dim slices per lane
  constexpr int CH = HD / 4;            // 16-byte chunks per row

  __shared__ __align__(16) float Qs[BM * LD];
  __shared__ __align__(16) float Ks[BN * LD];
  __shared__ __align__(16) float Vs[BN * LD];
  __shared__ __align__(16) float Ps[WARPS][BN][R];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;  // long (late) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * BM;

  const float* qp = (const float*)p.q + b * p.q_sb + h * p.q_sh;
  const float* kp = (const float*)p.k + b * p.k_sb + hk * p.k_sh;
  const float* vp = (const float*)p.v + b * p.v_sb + hk * p.v_sh;
  float* op = (float*)p.o + b * p.o_sb + h * p.o_sh;

  for (int c = tid; c < BM * CH; c += 128) {
    int r = c / CH, cc = c % CH;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.Sq) val = *(const float4*)(qp + (long long)(q0 + r) * p.q_ss + cc * 4);
    *(float4*)&Qs[r * LD + cc * 4] = val;
  }

  float m[R], l[R], acc[R][NI];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  }

  const int q_last = min(q0 + BM, p.Sq) - 1;
  const int n_tiles = kv_tiles(p, q_last, BN);

  for (int t = kv_first<W>(p, q0, BN, n_tiles); t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the previous tile is consumed (and Qs is written, first time)
    for (int c = tid; c < BN * CH; c += 128) {
      int r = c / CH, cc = c % CH;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < p.Sk) {
        kv = *(const float4*)(kp + (long long)(k0 + r) * p.k_ss + cc * 4);
        vv = *(const float4*)(vp + (long long)(k0 + r) * p.v_ss + cc * 4);
      }
      *(float4*)&Ks[r * LD + cc * 4] = kv;
      *(float4*)&Vs[r * LD + cc * 4] = vv;
    }
    __syncthreads();

    // scores: this lane's key against the warp's R query rows
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const float* kr = &Ks[lane * LD];
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kv = *(const float4*)(kr + d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *(const float4*)&Qs[(warp * R + r) * LD + d];
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    const int kpos = k0 + lane;
    float pr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = q0 + warp * R + r;
      const float sv = key_allowed<W>(p, kpos, qpos) ? s[r] * p.scale : kMasked;
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float pv = expf(sv - m_new);
      float sum = pv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= corr;
      pr[r] = pv;
    }
    *(float4*)&Ps[warp][lane][0] = make_float4(pr[0], pr[1], pr[2], pr[3]);
    __syncwarp();

    // acc += P . V, lanes split the head dimension
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float4 pj = *(const float4*)&Ps[warp][j][0];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        if (HD % 32 == 0 || d < HD) {
          const float vv = Vs[j * LD + d];
          acc[0][i] = fmaf(pj.x, vv, acc[0][i]);
          acc[1][i] = fmaf(pj.y, vv, acc[1][i]);
          acc[2][i] = fmaf(pj.z, vv, acc[2][i]);
          acc[3][i] = fmaf(pj.w, vv, acc[3][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qpos = q0 + warp * R + r;
    if (qpos >= p.Sq) continue;
    if (p.lse && lane == 0) p.lse[((long long)b * p.Hq + h) * p.Sq + qpos] = m[r] + logf(l[r]);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (HD % 32 == 0 || d < HD) op[(long long)qpos * p.o_ss + d] = acc[r][i] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + mbarrier ring + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kBM = 128;        // query rows of a block: two consumer warpgroups of 64
constexpr int kBN = 128;        // keys of a K/V tile
constexpr int kThreadsBf16 = 384;  // warpgroups 0, 1 consume; warpgroup 2 produces

template <int HD>
struct Cfg {
  static constexpr int NCH = (HD + 63) / 64;        // 64-column (128-byte) chunks of a row
  static constexpr int KSTEPS = HD / 16;            // k16 steps of Q.K^T (hd 80: 5)
  static constexpr int STAGES = NCH == 1 ? 3 : 2;   // K/V ring depth
  static constexpr int Q_CHUNK = kBM * 128;         // bytes of one chunk of the Q tile
  static constexpr int KV_CHUNK = kBN * 128;        // bytes of one chunk of a K or V tile
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int KV_BYTES = NCH * KV_CHUNK;
  static constexpr int SMEM = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // Q, O, K, V + slack
};

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)

// S(64 x 128) (+)= A(64 x 16, shared) . B(128 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : F16(0), F16(16), F16(32), F16(48)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef F16
#undef F4

// Named barriers 3 and 4 order the two consumer warpgroups' products: a
// warpgroup issues its wgmma batch only after the other has issued its own, so
// one warpgroup's softmax runs while the other's products occupy the tensor
// cores.  bar.sync waits for 256 threads: its own 128 and the other's arrive.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
}

// Running max (raw scores) and denominators of a thread's two rows.
struct Rows {
  float m_lo, m_hi, l_lo, l_hi;
};

// S = Q.K^T for one warpgroup: 64 x 128, both operands from shared memory.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[64], const uint8_t* q, const uint8_t* k) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < C::KSTEPS; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_m64n128k16_ss(sc, sw128_desc(q + c * C::Q_CHUNK + off, 16, 1024),
                        sw128_desc(k + c * C::KV_CHUNK + off, 16, 1024), kk > 0);
  }
}

// O += P.V: V's rows (keys) are the k dimension, read through the transposed
// descriptor; one m64n64k16 per 64 columns of hd and 16 keys.
template <int NCH>
__device__ __forceinline__ void issue_pv(float (&o)[NCH][32], const uint32_t (&pa)[8][4],
                                         const uint8_t* v) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      wgmma_m64n64k16_rs(o[c], pa[kk], sw128_desc(v + c * kBN * 128 + kk * 2048, 1024, 1024));
}

// Scores of keys past Sk, above the diagonal if causal, and at or before
// row - window with a window, become -1e30; only the diagonal tile, the
// window's first tiles and the ragged tail have any.  A warp's 16 rows run
// from warp_row0.
template <bool W>
__device__ __forceinline__ void mask_tile(float (&sc)[64], int k0, int row_lo, int row_hi,
                                          int warp_row0, int t4, const Params& p) {
  if (!((k0 + kBN > p.Sk) || (p.causal && k0 + kBN - 1 > warp_row0) ||
        (W && k0 <= warp_row0 + 15 - p.window)))
    return;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = k0 + (i >> 2) * 8 + t4 * 2 + (i & 1);
    const int row = (i & 2) ? row_hi : row_lo;
    if (!key_allowed<W>(p, col, row)) sc[i] = kMasked;
  }
}

// One online-softmax step on a thread's 64 scores (rows lo and hi, 16 n8
// tiles); a row lives in the 4 lanes of a quad.  Writes P as bf16 A
// fragments, updates the running max and denominators, and returns in corr_*
// the factors for the old accumulator rows.  Partial maxima and sums are
// taken four ways to shorten the dependency chains.
template <bool W>
__device__ __forceinline__ void softmax_tile(const float (&sc)[64], uint32_t (&pa)[8][4],
                                             Rows& r, float& corr_lo, float& corr_hi,
                                             float c2) {
  float ml[4], mh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ml[j] = fmaxf(sc[4 * j], sc[4 * j + 1]);
    mh[j] = fmaxf(sc[4 * j + 2], sc[4 * j + 3]);
  }
#pragma unroll
  for (int nt = 4; nt < 16; ++nt) {
    ml[nt & 3] = fmaxf(ml[nt & 3], fmaxf(sc[4 * nt], sc[4 * nt + 1]));
    mh[nt & 3] = fmaxf(mh[nt & 3], fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
  }
  float mx_lo = fmaxf(fmaxf(ml[0], ml[1]), fmaxf(ml[2], ml[3]));
  float mx_hi = fmaxf(fmaxf(mh[0], mh[1]), fmaxf(mh[2], mh[3]));
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(r.m_lo, mx_lo), mn_hi = fmaxf(r.m_hi, mx_hi);
  corr_lo = ex2((r.m_lo - mn_lo) * c2);
  corr_hi = ex2((r.m_hi - mn_hi) * c2);
  r.m_lo = mn_lo;
  r.m_hi = mn_hi;
  // With a window, a row that has seen only masked scores so far keeps
  // m = -1e30.  Its offset is then 0, so that p = 2^(-1e30 c2) = 0 on those
  // entries: with -m c2 the fma of the exact product -1e30 c2 and the
  // rounded offset leaves up to half an ulp of 1e30 c2 (~1e22), and 2^ of
  // that is inf when its sign is +.  Without one, every row's first tile
  // holds key 0, which it sees.
  const float bl = W && mn_lo == kMasked ? 0.f : -mn_lo * c2;
  const float bh = W && mn_hi == kMasked ? 0.f : -mn_hi * c2;
  float sl[4] = {0.f, 0.f, 0.f, 0.f}, sh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float p0 = ex2(fmaf(sc[4 * nt], c2, bl)), p1 = ex2(fmaf(sc[4 * nt + 1], c2, bl));
    const float p2 = ex2(fmaf(sc[4 * nt + 2], c2, bh)), p3 = ex2(fmaf(sc[4 * nt + 3], c2, bh));
    sl[nt & 3] += p0 + p1;
    sh[nt & 3] += p2 + p3;
    pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
    pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
  r.l_lo = r.l_lo * corr_lo + ((sl[0] + sl[1]) + (sl[2] + sl[3]));
  r.l_hi = r.l_hi * corr_hi + ((sh[0] + sh[1]) + (sh[2] + sh[3]));
}

// A block's work items, (batch, head, 128-row q tile), numbered long (late)
// q tiles first and, within a q tile, the heads of one KV group together.
struct Item {
  int b, h, q0;
};
__device__ __forceinline__ Item item_of(const Params& p, int i, int n_qt) {
  const int bh = p.B * p.Hq, rem = i % bh;
  return {rem / p.Hq, rem % p.Hq, (n_qt - 1 - i / bh) * kBM};
}

template <int HD, bool W>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<HD>;
  constexpr int NCH = C::NCH, STAGES = C::STAGES;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_qfree;
  __shared__ __align__(8) uint64_t bar_k[STAGES], bar_v[STAGES], bar_free[STAGES];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;                              // [NCH][128 rows][128 B]
  uint8_t* sO = sQ + C::Q_BYTES;                   // the output tile, staged (same layout)
  uint8_t* sK = sO + C::Q_BYTES;                   // [STAGES][NCH][128 keys][128 B]
  uint8_t* sV = sK + STAGES * C::KV_BYTES;         // same

  const int n_qt = (p.Sq + kBM - 1) / kBM;
  const int n_items = n_qt * p.B * p.Hq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    mbar_init(&bar_qfree, 8);                      // lane 0 of every consumer warp
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_free[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block is persistent: it walks items blockIdx.x, + gridDim.x, ...; kv
  // tiles are numbered across items (`it`), so the ring runs on from one item
  // into the next and the next item's Q and first tiles load while this one
  // finishes.
  if (warp >= 8) {
    // ---- producer: one thread keeps Q and the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int it = 0, k = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++k) {
        const Item w = item_of(p, i, n_qt);
        const int hk = w.h / (p.Hq / p.Hkv);
        const int n_tiles = kv_tiles(p, min(w.q0 + kBM, p.Sq) - 1, kBN);
        if (k > 0) mbar_wait(&bar_qfree, (k - 1) & 1);   // the last item's Q.K^T are done
        mbar_expect_tx(&bar_q, C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load_4d(sQ + c * C::Q_CHUNK, &tq, &bar_q, c * 64, w.h, w.q0, w.b);
        for (int t = kv_first<W>(p, w.q0, kBN, n_tiles); t < n_tiles; ++t, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&bar_free[s], ((it / STAGES) - 1) & 1);
          uint8_t* dk = sK + s * C::KV_BYTES;
          uint8_t* dv = sV + s * C::KV_BYTES;
          mbar_expect_tx(&bar_k[s], C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            tma_load_4d(dk + c * C::KV_CHUNK, &tk, &bar_k[s], c * 64, hk, t * kBN, w.b);
          mbar_expect_tx(&bar_v[s], C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            tma_load_4d(dv + c * C::KV_CHUNK, &tv, &bar_v[s], c * 64, hk, t * kBN, w.b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, w4 = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const float c2 = p.scale * 1.4426950408889634f;  // scores in units of log2
    float o[NCH][32];
    float sc[64];
    uint32_t pa[8][4], pb[8][4];       // P of two consecutive tiles, bf16 A fragments
    int it = 0, k = 0;

    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++k) {
      const Item w = item_of(p, i, n_qt);
      // tiles t0 .. t0 + n_tiles - 1 of the item, counted from 0 below
      const int t_end = kv_tiles(p, min(w.q0 + kBM, p.Sq) - 1, kBN);
      const int t0 = kv_first<W>(p, w.q0, kBN, t_end);
      const int n_tiles = t_end - t0;
      const int warp_row0 = w.q0 + wg * 64 + w4 * 16;
      const int row_lo = warp_row0 + g, row_hi = row_lo + 8;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[c][j] = 0.f;
      Rows r{kMasked, kMasked, 0.f, 0.f};
      float corr_lo, corr_hi;
      auto release_q = [&]() {         // this warp has done its last Q.K^T of the item
        __syncwarp();
        if (lane == 0) mbar_arrive(&bar_qfree);
      };

      // Tile t's S = Q.K^T is issued together with tile t-1's O += P.V; the
      // softmax of tile t then runs while P.V is still on the tensor cores.
      // Turns: warpgroup 0 goes first; each of the n_tiles + 1 batches below
      // waits for its turn and passes it on, except warpgroup 1's last.
      if (wg == 1) turn_pass(wg);
      mbar_wait(&bar_q, k & 1);
      mbar_wait(&bar_k[it % STAGES], (it / STAGES) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_qk<HD>(sc, sQ + wg * 8192, sK + (it % STAGES) * C::KV_BYTES);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      reg_fence(sc);
      if (n_tiles == 1) release_q();
      mask_tile<W>(sc, t0 * kBN, row_lo, row_hi, warp_row0, t4, p);
      softmax_tile<W>(sc, pa, r, corr_lo, corr_hi, c2);

      // One kv tile t >= 1.  P of tile t-1 is read from `pin` while P of tile
      // t is written to `pout`: the two alternate, so no register is redefined
      // while a wgmma reads it.
      auto step = [&](int t, uint32_t(&pin)[8][4], uint32_t(&pout)[8][4]) {
        const int n = it + t, s = n % STAGES, sp = (n - 1) % STAGES;
        mbar_wait(&bar_k[s], (n / STAGES) & 1);
        mbar_wait(&bar_v[sp], ((n - 1) / STAGES) & 1);
        reg_fence(sc);
        reg_fence(pin);
#pragma unroll
        for (int c = 0; c < NCH; ++c) reg_fence(o[c]);
        turn_wait(wg);
        wgmma_fence();
        issue_qk<HD>(sc, sQ + wg * 8192, sK + s * C::KV_BYTES);
        wgmma_commit();
        issue_pv<NCH>(o, pin, sV + sp * C::KV_BYTES);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<1>();               // S of tile t is in
        reg_fence(sc);
        if (t == n_tiles - 1) release_q();
        mask_tile<W>(sc, (t0 + t) * kBN, row_lo, row_hi, warp_row0, t4, p);
        softmax_tile<W>(sc, pout, r, corr_lo, corr_hi, c2);
        wgmma_wait<0>();               // P.V of tile t-1 is done: stage sp is free
#pragma unroll
        for (int c = 0; c < NCH; ++c) reg_fence(o[c]);
        reg_fence(pin);
        __syncwarp();
        if (lane == 0) mbar_arrive(&bar_free[sp]);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int j = 0; j < 32; j += 4) {
            o[c][j] *= corr_lo;
            o[c][j + 1] *= corr_lo;
            o[c][j + 2] *= corr_hi;
            o[c][j + 3] *= corr_hi;
          }
      };
      // The last tile's O += P.V, and its stage freed.
      auto last = [&](uint32_t(&pin)[8][4]) {
        const int n = it + n_tiles - 1, sp = n % STAGES;
        mbar_wait(&bar_v[sp], (n / STAGES) & 1);
        reg_fence(pin);
#pragma unroll
        for (int c = 0; c < NCH; ++c) reg_fence(o[c]);
        turn_wait(wg);
        wgmma_fence();
        issue_pv<NCH>(o, pin, sV + sp * C::KV_BYTES);
        wgmma_commit();
        if (wg == 0) turn_pass(wg);
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NCH; ++c) reg_fence(o[c]);
        reg_fence(pin);
        __syncwarp();
        if (lane == 0) mbar_arrive(&bar_free[sp]);
      };
      int t = 1;
      for (; t + 1 < n_tiles; t += 2) {
        step(t, pa, pb);
        step(t + 1, pb, pa);
      }
      if (t < n_tiles) {
        step(t, pa, pb);
        last(pb);
      } else {
        last(pa);
      }
      it += n_tiles;

      // ---- epilogue: normalise, stage the warpgroup's 64 rows in sO with the
      // Q tile's swizzle, then 16-byte stores of the rows < Sq
      float l_lo = r.l_lo, l_hi = r.l_hi;
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
      }
      const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
      if (p.lse && t4 == 0) {        // the backward's lse = m + log l, m in scaled units
        float* lp = p.lse + ((long long)w.b * p.Hq + w.h) * p.Sq;
        if (row_lo < p.Sq) lp[row_lo] = r.m_lo * p.scale + logf(l_lo);
        if (row_hi < p.Sq) lp[row_hi] = r.m_hi * p.scale + logf(l_hi);
      }
      const int r_lo = w4 * 16 + g, r_hi = r_lo + 8;   // rows within the warpgroup's 64
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        uint8_t* base = sO + c * C::Q_CHUNK + wg * 8192;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int byte = ((nt ^ (r_lo & 7)) << 4) + t4 * 4;   // r_hi & 7 == r_lo & 7
          *reinterpret_cast<uint32_t*>(base + r_lo * 128 + byte) =
              pack_bf16(o[c][4 * nt] * inv_lo, o[c][4 * nt + 1] * inv_lo);
          *reinterpret_cast<uint32_t*>(base + r_hi * 128 + byte) =
              pack_bf16(o[c][4 * nt + 2] * inv_hi, o[c][4 * nt + 3] * inv_hi);
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      constexpr int CPR = HD / 8;                 // 16-byte chunks of an output row
      __nv_bfloat16* op = (__nv_bfloat16*)p.o + w.b * p.o_sb + w.h * p.o_sh;
      for (int j = threadIdx.x & 127; j < 64 * CPR; j += 128) {
        const int rr = j / CPR, cc = j % CPR;
        const int row = w.q0 + wg * 64 + rr;
        if (row >= p.Sq) continue;
        const uint8_t* src =
            sO + (cc >> 3) * C::Q_CHUNK + wg * 8192 + rr * 128 + (((cc & 7) ^ (rr & 7)) << 4);
        *reinterpret_cast<uint4*>(op + (long long)row * p.o_ss + cc * 8) =
            *reinterpret_cast<const uint4*>(src);
      }
      // the next item's epilogue rewrites sO only after every thread of this
      // warpgroup has passed the turn barriers of that item
    }
  }
}

template <int HD, bool W>
int launch_bf16(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, HD, p.Hq, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, kBM) ||
      !make_map(&tk, p.k, HD, p.Hkv, p.Sk, p.B, p.k_sh, p.k_ss, p.k_sb, kBN) ||
      !make_map(&tv, p.v, HD, p.Hkv, p.Sk, p.B, p.v_sh, p.v_ss, p.v_sb, kBN))
    return -3;
  constexpr int smem = Cfg<HD>::SMEM;
  static bool attr_set = false;  // the attribute sticks to the function
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16<HD, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  static int n_sm = 0;                 // one persistent block per SM
  if (!n_sm) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long long items = (long long)((p.Sq + kBM - 1) / kBM) * p.B * p.Hq;
  if (items > 2147483647LL) return -2;
  const int grid = (int)(items < n_sm ? items : n_sm);
  flash_fwd_bf16<HD, W><<<grid, kThreadsBf16, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int HD, bool W>
int launch(const Params& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) return launch_bf16<HD, W>(p, stream);
  dim3 grid((p.Sq + 15) / 16, p.Hq, p.B);
  flash_fwd_f32<HD, W><<<grid, 128, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const Params& p, int is_bf16, cudaStream_t stream) {
  return p.window ? launch<HD, true>(p, is_bf16, stream) : launch<HD, false>(p, is_bf16, stream);
}

}  // namespace

// Returns 0, a cudaError_t from the launch, -1 / -2 for a shape this file does
// not take, or -3 if cuTensorMapEncodeTiled refuses a TMA descriptor (bf16).
// `lse`, if not nullptr, receives each row's log-sum-exp (fp32, (B, Hq, Sq)
// contiguous) for the backward (csrc/flash_attention_bwd.cu).  `window` > 0
// limits each query to the keys q - window < k <= q (with `causal` only).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int hd,
                                   long long q_sb,
                                   long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss, long long o_sh, float scale,
                                   int causal, int window, int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -2;
  if (Hq > 65535 || B > 65535) return -2;
  if (window < 0 || (window > 0 && !causal)) return -2;
  Params p{q,    k,    v,    o,    lse,  B,    Sq,   Sk,   Hq,    Hkv,  q_sb,  q_ss,   q_sh,
           k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal, window};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 64: return launch<64>(p, is_bf16, s);
    case 80: return launch<80>(p, is_bf16, s);
    case 128: return launch<128>(p, is_bf16, s);
    default: return -1;
  }
}
