// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py (the pallas_call at line 102).  It
// computes the same function: scores q.k^T * scale, mask `k_pos < Sk` and, if
// causal, `k_pos <= q_pos`, applied as the finite value -1e30 (never -inf, so
// no row computes inf - inf), running max / denominator / accumulator in fp32,
// finalise acc / max(l, 1e-30), output in q's dtype.
//
// What differs from the TPU kernel, and why.  There the grid is
// (batch*heads, q blocks, kv blocks) and the kv axis runs in order on one core,
// carrying m, l, acc in scratch memory from step to step.  Here blocks run in
// parallel and nothing carries between them: one thread block owns one
// (batch, head, q tile), loops over the kv tiles itself and keeps m, l and the
// accumulator in registers.  The kernel reads (B, S, H, hd) tensors through
// their strides, so the wrapper makes no transposed or padded copies; the
// ragged tail of Sq and Sk is masked here (rows past the end are loaded as
// zeros and never stored).  Grouped-query attention reads KV head
// h / (Hq / Hkv) directly instead of repeating K and V in memory.  With a
// causal mask the loop stops at the diagonal: a fully masked tile would add
// exp(-1e30 - m) = 0, so the result is the same as visiting every tile.
//
// What bounds it on this card.  At the serving prefill shape (B 8, S 2048,
// 32 query heads, 8 KV heads, hd 64, bf16, causal) the work is 137 GFLOP on
// 168 MB of q, k, v, o: about 820 operations per byte, far above the ~295
// where an H100 turns from memory- to tensor-core-bound.  So the bound is
// operations, and the design question is how the two products reach the tensor
// cores:
//   * bf16: both products are `mma.sync.m16n8k16` (bf16 operands, fp32
//     accumulate).  A block is 4 warps x 16 query rows against 64-key tiles.
//     Q fragments stay in registers for the whole loop; the score tile never
//     leaves registers: the accumulator layout of Q.K^T is re-packed in place
//     as the A operand of P.V.  K and V tiles are staged in shared memory with
//     rows padded by 16 bytes so fragment loads hit distinct banks; V fragments
//     come through `ldmatrix.trans`.  Softmax uses exp2 with the scale folded
//     in.  `wgmma`, TMA and a load/compute pipeline are what is left on the
//     table.
//   * fp32: full fp32 FMAs, no TF32, because the reference's fp32 tolerance
//     (2e-5) does not survive a 10-bit mantissa.  A warp owns 4 query rows;
//     lanes split the 32 keys of a tile for the scores and the head dimension
//     for P.V.  This path serves checks and small fp32 models, not the bf16
//     serving path.
//
// Plain C interface (no PyTorch headers): the wrapper in
// repro_torch/kernels/flash_attention.py passes raw pointers, element strides
// and the stream, and raises on a non-zero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, Hq, Hkv;
  // strides in elements: batch, sequence, head (the last dimension has stride 1)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// Number of kv tiles a q tile has to visit.
__device__ __forceinline__ int kv_tiles(const Params& p, int q_last, int bn) {
  int n = (p.Sk + bn - 1) / bn;
  if (p.causal) {
    int upto = q_last / bn + 1;  // tile holding key == q_last
    n = upto < n ? upto : n;
  }
  return n;
}

// ---------------------------------------------------------------------------
// fp32: plain FMA
// ---------------------------------------------------------------------------

template <int HD>
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

  for (int t = 0; t < n_tiles; ++t) {
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
      const bool ok = kpos < p.Sk && (!p.causal || kpos <= qpos);
      const float sv = ok ? s[r] * p.scale : kMasked;
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
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (HD % 32 == 0 || d < HD) op[(long long)qpos * p.o_ss + d] = acc[r][i] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core products, fp32 softmax
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(128) flash_fwd_bf16(const Params p) {
  constexpr int BM = 64, BN = 64;
  constexpr int LD = HD + 8;     // row stride in bf16: rows stay 16-byte aligned, banks distinct
  constexpr int KT = HD / 16;    // k steps of Q.K^T
  constexpr int DT = HD / 8;     // 8-wide output column tiles of P.V
  constexpr int NT = BN / 8;     // 8-wide key column tiles of the scores
  constexpr int CH = HD / 8;     // 16-byte chunks per row

  __shared__ __align__(16) __nv_bfloat16 Ks[BN * LD];  // also stages Q once
  __shared__ __align__(16) __nv_bfloat16 Vs[BN * LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // long (late) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * BM;

  const __nv_bfloat16* qp = (const __nv_bfloat16*)p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp = (const __nv_bfloat16*)p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vp = (const __nv_bfloat16*)p.v + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* op = (__nv_bfloat16*)p.o + b * p.o_sb + h * p.o_sh;

  // Q tile -> shared memory -> A fragments in registers, kept for the whole loop
  for (int c = tid; c < BM * CH; c += 128) {
    int r = c / CH, cc = c % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.Sq) val = *(const uint4*)(qp + (long long)(q0 + r) * p.q_ss + cc * 8);
    *(uint4*)&Ks[r * LD + cc * 8] = val;
  }
  __syncthreads();
  uint32_t qa[KT][4];
  {
    const __nv_bfloat16* base = &Ks[(warp * 16 + g) * LD + t4 * 2];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      qa[kt][0] = *(const uint32_t*)(base + kt * 16);
      qa[kt][1] = *(const uint32_t*)(base + 8 * LD + kt * 16);
      qa[kt][2] = *(const uint32_t*)(base + kt * 16 + 8);
      qa[kt][3] = *(const uint32_t*)(base + 8 * LD + kt * 16 + 8);
    }
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  // rows g and g + 8 of the warp's 16; l is this thread's partial sum (its 16 columns per tile)
  float m_lo = kMasked, m_hi = kMasked, l_lo = 0.f, l_hi = 0.f;

  const float c2 = p.scale * 1.4426950408889634f;  // scores in units of log2
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const int q_last = min(q0 + BM, p.Sq) - 1;
  const int n_tiles = kv_tiles(p, q_last, BN);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // everyone is done with the previous tile (or with Q in Ks)
    for (int c = tid; c < BN * CH; c += 128) {
      int r = c / CH, cc = c % CH;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < p.Sk) {
        kv = *(const uint4*)(kp + (long long)(k0 + r) * p.k_ss + cc * 8);
        vv = *(const uint4*)(vp + (long long)(k0 + r) * p.v_ss + cc * 8);
      }
      *(uint4*)&Ks[r * LD + cc * 8] = kv;
      *(uint4*)&Vs[r * LD + cc * 8] = vv;
    }
    __syncthreads();

    // S = Q . K^T  (16 x 64 per warp)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kb = &Ks[(nt * 8 + g) * LD + t4 * 2];
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const uint32_t b0 = *(const uint32_t*)(kb + kt * 16);
        const uint32_t b1 = *(const uint32_t*)(kb + kt * 16 + 8);
        mma_bf16(s[nt], qa[kt], b0, b1);
      }
    }

    // scale into log2 units and mask; only tiles on the diagonal or the tail need the test
    const bool edge = (k0 + BN > p.Sk) || (p.causal && k0 + BN - 1 > q0 + warp * 16);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float sv = s[nt][i] * c2;
        if (edge) {
          const int col = k0 + nt * 8 + t4 * 2 + (i & 1);
          const int row = (i < 2) ? row_lo : row_hi;
          const bool ok = col < p.Sk && (!p.causal || col <= row);
          sv = ok ? sv : kMasked;
        }
        s[nt][i] = sv;
      }
    }

    // online softmax; a row lives in the 4 lanes of a quad
    float mx_lo = kMasked, mx_hi = kMasked;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = exp2f(m_lo - mn_lo), corr_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn_lo);
      s[nt][1] = exp2f(s[nt][1] - mn_lo);
      s[nt][2] = exp2f(s[nt][2] - mn_hi);
      s[nt][3] = exp2f(s[nt][3] - mn_hi);
      sum_lo += s[nt][0] + s[nt][1];
      sum_hi += s[nt][2] + s[nt][3];
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= corr_lo;
      o[dt][1] *= corr_lo;
      o[dt][2] *= corr_hi;
      o[dt][3] *= corr_hi;
    }

    // O += P . V : two neighbouring 8-wide score tiles are one 16-deep A fragment
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // lane -> key row kk*16 + lane%16, head-dim column (lane/16)*8 of the pair of tiles
      const __nv_bfloat16* vb = &Vs[(kk * 16 + (lane & 15)) * LD + (lane >> 4) * 8];
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vb + dt * 8);
        mma_bf16(o[dt], pa, vf[0], vf[1]);
        mma_bf16(o[dt + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // finish the row sums across the quad, normalise, store
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (row_lo < p.Sq)
      *(uint32_t*)(op + (long long)row_lo * p.o_ss + col) =
          pack_bf16(o[dt][0] * inv_lo, o[dt][1] * inv_lo);
    if (row_hi < p.Sq)
      *(uint32_t*)(op + (long long)row_hi * p.o_ss + col) =
          pack_bf16(o[dt][2] * inv_hi, o[dt][3] * inv_hi);
  }
}

template <int HD>
void launch(const Params& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    dim3 grid((p.Sq + 63) / 64, p.Hq, p.B);
    flash_fwd_bf16<HD><<<grid, 128, 0, stream>>>(p);
  } else {
    dim3 grid((p.Sq + 15) / 16, p.Hq, p.B);
    flash_fwd_f32<HD><<<grid, 128, 0, stream>>>(p);
  }
}

}  // namespace

// Returns 0, a cudaError_t from the launch, or -1 / -2 for a shape this file does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int Sq, int Sk, int Hq, int Hkv, int hd, long long q_sb,
                                   long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss, long long o_sh, float scale,
                                   int causal, int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -2;
  if (Hq > 65535 || B > 65535) return -2;
  Params p{q,    k,    v,    o,    B,    Sq,   Sk,   Hq,   Hkv,  q_sb, q_ss, q_sh,  k_sb,
           k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 64: launch<64>(p, is_bf16, s); break;
    case 80: launch<80>(p, is_bf16, s); break;
    case 128: launch<128>(p, is_bf16, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
