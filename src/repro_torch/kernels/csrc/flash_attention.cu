// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/flash_attention.py
// (flash_attention_fwd, body _kernel).
//
// Bound on the card: the work is 4 * (unmasked query-key pairs) * hd
// operations per query head against q, k, v and o moved once.  At the
// serving path's shapes (T 512, hd 64, GQA group 3, causal) that is about
// 190 operations per byte, under the H100's bf16 ridge of ~295, so the
// least time is set by the bytes, with the operations close behind: only
// the tensor cores come near either.  Every K tile that causality, the
// window or the key length masks completely is skipped by the loop
// bounds, and the ragged q and k edges are masked here, so the caller never
// pads.  At head_dim 256 (Gemma-2's call, 8 x 512, 8 heads, 4 kv heads) the
// bytes are 50.3 MB, 0.0150 ms at 3.35 TB/s, and the work 8.6 GFLOP, 0.0087
// ms at the bf16 peak: bytes-bound too.  Three bodies, chosen in
// flash_attention_fwd:
//  - flash_fwd_wgmma_kernel (bf16, head_dim 64, 128 or 256, 16-byte aligned
//    operands and strides): one block per (query tile of BM positions,
//    query head, batch), the heaviest causal tiles first.  A producer warp
//    loads the Q tile once and keeps K/V tiles of BN keys in flight with TMA
//    (128-byte swizzle) in a ring of WG_STAGES shared-memory stages guarded
//    by full/empty mbarriers; each consumer warpgroup owns 64 query rows
//    and runs S = Q K^T as wgmma with both operands in shared memory, the
//    online softmax on the accumulator fragment (in the log2 domain, one
//    ex2.approx per score, and the cap's tanh as one tanh.approx), and O +=
//    P V as wgmma with P in registers and V read MN-major through the
//    descriptor's transpose bit.  The GQA group is not folded into the rows
//    as on the TPU: the G query heads of a kv head re-read its K/V tiles,
//    from L2.  Registers are budgeted for two or three blocks per SM, whose
//    softmax and products interleave, where their shared memory lets them
//    (wgmma_min_blocks); where two consumer warpgroups need more than the
//    168 registers a thread of a 288-thread block, the producer is a whole
//    warpgroup that hands its registers to them (wgmma_producer_threads).
//    Measured on an H100 at 700 W (chip_smoke.py, PERF.md) at the serving
//    shape: about 0.025 ms on the device against a 0.0063 ms bound and
//    SDPA's 0.023 ms.  What holds it back: each warpgroup's softmax runs
//    between its two products, not beside them (FlashAttention-3's overlap
//    of the next tile's Q K^T with this tile's softmax measured slower
//    here, for its registers); at head_dim 64 the special-function unit's
//    exponentials take as long as the tensor cores' products; a block with
//    few key tiles pays the latency of its first loads; and every (query
//    tile, head) reads its K/V tiles from L2 again.
//    At head_dim 256 a K or V tile of 64 keys is 32 KB, so the tiles are
//    (64, 64) and (128, 64) only (164,904 and 197,672 B of shared memory a
//    block; a 128-key tile needs 295,976 B), one block an SM; each
//    consumer thread holds 128 output accumulators, and PV is one
//    m64n256k16 a 16-key step.  Measured on an H100 at 700 W (PERF.md) at
//    Gemma-2's call (cap 50): 0.051 ms at (64, 64), the default, and 0.045
//    at (128, 64) on the device, against a 0.0150 ms bound, SDPA's 0.038
//    and the CUDA-core body's 1.61; at one sequence of 512 0.016 and 0.024
//    ms.  What holds it back: one block an SM, so at (64, 64) one consumer
//    warpgroup whose softmax leaves the tensor cores idle, and at (128, 64)
//    half as many blocks.  The cap's float32 tanhf took 41% of the time;
//    tanh.approx takes 4%.
//  - flash_fwd_mma_kernel (bf16, the other head sizes that are multiples of
//    16 up to 128, 16-byte aligned operands): one block per (batch x kv
//    head, query tile) with the GQA group folded into the rows; each of 4
//    warps owns 16 rows and runs QK^T and PV as mma.sync m16n8k16.
//  - flash_fwd_kernel (float32 at any head_dim up to 256, and views the
//    tensor-core bodies cannot read): CUDA cores, the group folded into
//    the rows; at head_dim 256 its float32 copies of Q, K and V take
//    198,912 B of shared memory, one 8-warp block an SM.  Each
//    warp owns up to RW rows and keeps their online-softmax state in float32
//    registers; lane j scores keys j and j + 32 of the tile, and the PV
//    product gives each lane head_dim / 32 output columns.
//
// Numerics match the reference in every body: scores are float32 products
// scaled after the QK product, P is rounded to V's dtype before the PV
// product while l sums the unrounded P, masked scores are the finite
// NEG_INF, and finalisation divides by max(l, 1e-30).
#include <cuda.h>   // CUtensorMap; its encoder is fetched through the runtime

#include <cstdint>

#include "attn_common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int RW = 8;                       // rows per warp: at most 64 rows per block
constexpr int MAX_ROWS = NWARPS * RW;

template <typename T, int DPL>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Tq, int Tk, int KV, int G, int hd,
                 long long q_sb, long long q_st, long long q_sh,
                 long long k_sb, long long k_st, long long k_sh,
                 long long v_sb, long long v_st, long long v_sh,
                 long long o_sb, long long o_st, long long o_sh,
                 int block_q, int causal, int window, float logit_cap, int q_offset,
                 float scale) {
  using namespace attn;
  const int bkv = blockIdx.x;
  const int b = bkv / KV, h = bkv - b * KV;
  const int p0 = blockIdx.y * block_q;
  const int nq = min(block_q, Tq - p0);
  const int rows = nq * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ float smem[];
  float* Qs = smem;                            // block_q * G rows of hd
  float* Ks = Qs + block_q * G * hd;           // BK rows of hd + 1
  float* Vs = Ks + BK * (hd + 1);              // BK rows of hd
  float* Pw = Vs + BK * hd + warp * BK;        // this warp's probabilities

  const T* qb = q + b * q_sb;
  for (int idx = threadIdx.x; idx < rows * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx - r * hd;
    const int t = p0 + r / G, g = r - (r / G) * G;
    Qs[idx] = to_f(qb[t * q_st + (long long)(h * G + g) * q_sh + d]);
  }
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  // keys any row of this tile can see
  const int q_first = q_offset + p0, q_last = q_offset + p0 + nq - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  float m[RW], l[RW], acc[RW][DPL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                           // the previous tile is consumed
    load_kv_tile(kb, vb, k_st, v_st, k0, Tk, hd, Ks, Vs);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + NWARPS * i;
      if (r >= rows) break;                    // warp-uniform
      const int qpos = q_offset + p0 + r / G;
      float s0, s1;
      row_scores(Qs + r * hd, Ks, hd, lane, s0, s1);
      s0 = cap_logit(s0 * scale, logit_cap);
      s1 = cap_logit(s1 * scale, logit_cap);
      const int kp0 = k0 + lane, kp1 = k0 + lane + 32;
      const bool ok0 = kp0 < Tk && (!causal || kp0 <= qpos) && (window <= 0 || kp0 > qpos - window);
      const bool ok1 = kp1 < Tk && (!causal || kp1 <= qpos) && (window <= 0 || kp1 > qpos - window);
      s0 = ok0 ? s0 : NEG_INF;
      s1 = ok1 ? s1 : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(e0 + e1);
      m[i] = m_new;
      Pw[lane] = round_to<T>(e0);
      Pw[lane + 32] = round_to<T>(e1);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= corr;
      for (int j = 0; j < BK; ++j) {
        const float pj = Pw[j];
        const float* vrow = Vs + j * hd;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) acc[i][c] = fmaf(pj, vrow[d], acc[i][c]);
        }
      }
      __syncwarp();                            // Pw is rewritten by the next row
    }
  }

  T* ob = o + b * o_sb;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + NWARPS * i;
    if (r >= rows) break;
    const int t = p0 + r / G, g = r - (r / G) * G;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = ob + t * o_st + (long long)(h * G + g) * o_sh;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) orow[d] = from_f<T>(acc[i][c] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// mma.sync body (bf16 at the head sizes the Hopper body does not take).
// Fragment layouts are those of PTX's
// mma.m16n8k16 for 16-bit A/B: lane = 4 * gid + tig; A holds rows gid and
// gid + 8 at columns 2 * tig (+1) and 2 * tig + 8 (+1); B holds rows 2 * tig
// (+1) and 2 * tig + 8 (+1) of column gid; C holds rows gid, gid + 8 at
// columns 2 * tig (+1).
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = 4;                // 4 x 16 rows = MAX_ROWS

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&t);
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <int HD>
__global__ void __launch_bounds__(MMA_WARPS * 32)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int Tq, int Tk, int KV, int G,
                     long long q_sb, long long q_st, long long q_sh,
                     long long k_sb, long long k_st, long long k_sh,
                     long long v_sb, long long v_st, long long v_sh,
                     long long o_sb, long long o_st, long long o_sh,
                     int block_q, int causal, int window, float logit_cap, int q_offset,
                     float scale) {
  using namespace attn;
  constexpr int KSTEPS = HD / 16;            // k-steps of the QK^T product
  constexpr int NT_O = HD / 8;               // 8-column tiles of the output
  constexpr int KST = HD + 8;                // padded rows: conflict-free fragment loads
  constexpr int VST = BK + 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * KST];   // K tile, [key][d]
  __shared__ __align__(16) __nv_bfloat16 Vt[HD * VST];   // V tile transposed, [d][key]

  const int bkv = blockIdx.x;
  const int b = bkv / KV, h = bkv - b * KV;
  const int p0 = blockIdx.y * block_q;
  const int nq = min(block_q, Tq - p0);
  const int rows = nq * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // this lane's two rows and their query positions
  const int r0 = warp * 16 + gid, r1 = r0 + 8;
  const bool ok_r0 = r0 < rows, ok_r1 = r1 < rows;
  const int t0 = p0 + (ok_r0 ? r0 : 0) / G, t1 = p0 + (ok_r1 ? r1 : 0) / G;
  const int g0 = (ok_r0 ? r0 : 0) % G, g1 = (ok_r1 ? r1 : 0) % G;
  const int qpos0 = q_offset + t0, qpos1 = q_offset + t1;

  // Q fragments, loaded once; rows past the tile are zero
  unsigned qa[KSTEPS][4];
  {
    const __nv_bfloat16* q0 = q + b * q_sb + t0 * q_st + (long long)(h * G + g0) * q_sh;
    const __nv_bfloat16* q1 = q + b * q_sb + t1 * q_st + (long long)(h * G + g1) * q_sh;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int c = ks * 16 + 2 * tig;
      qa[ks][0] = ok_r0 ? ld32(q0 + c) : 0u;
      qa[ks][1] = ok_r1 ? ld32(q1 + c) : 0u;
      qa[ks][2] = ok_r0 ? ld32(q0 + c + 8) : 0u;
      qa[ks][3] = ok_r1 ? ld32(q1 + c + 8) : 0u;
    }
  }
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  const int q_first = q_offset + p0, q_last = q_offset + p0 + nq - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                           // the previous tile is consumed
    // stage K and V^T: 16-byte loads of 8 values, zeros past Tk
    for (int idx = threadIdx.x; idx < BK * (HD / 8); idx += blockDim.x) {
      const int j = idx / (HD / 8), d8 = (idx - j * (HD / 8)) * 8;
      const int s = k0 + j;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (s < Tk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (long long)s * k_st + d8);
        vv4 = *reinterpret_cast<const uint4*>(vb + (long long)s * v_st + d8);
      }
      *reinterpret_cast<uint4*>(Ks + j * KST + d8) = kv4;
      const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(d8 + e) * VST + j] = vv[e];
    }
    __syncthreads();

    // S = Q K^T for the tile: 8 tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = Ks + (nt * 8 + gid) * KST + 2 * tig;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        mma_bf16(s[nt], qa[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
    }
    // scale, cap, mask; the tile's row maxima
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + nt * 8 + 2 * tig + (e & 1);
        const int qp = e < 2 ? qpos0 : qpos1;
        const bool ok = kp < Tk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        const float x = cap_logit(s[nt][e] * scale, logit_cap);
        s[nt][e] = ok ? x : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {    // the 4 lanes that share a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float c0 = expf(m[0] - mn0), c1 = expf(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l[0] = l[0] * c0 + sum0;
    l[1] = l[1] * c1 + sum1;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
    // O += P V, P rounded to bf16: the score tiles 2kk and 2kk + 1 are the
    // A fragment of the kk-th 16-key step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const __nv_bfloat16* vrow = Vt + (n * 8 + gid) * VST + kk * 16 + 2 * tig;
        mma_bf16(acc[n], pa, ld32(vrow), ld32(vrow + 8));
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
  __nv_bfloat16* o0 = o + b * o_sb + t0 * o_st + (long long)(h * G + g0) * o_sh;
  __nv_bfloat16* o1 = o + b * o_sb + t1 * o_st + (long long)(h * G + g1) * o_sh;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * tig;
    if (ok_r0) *reinterpret_cast<unsigned*>(o0 + c) = pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (ok_r1) *reinterpret_cast<unsigned*>(o1 + c) = pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int Tq,
                       int Tk, int KV, int G, const long long* st, int block_q, int causal,
                       int window, float logit_cap, int q_offset, float scale,
                       cudaStream_t stream) {
  const dim3 grid(B * KV, (Tq + block_q - 1) / block_q);
  flash_fwd_mma_kernel<HD><<<grid, MMA_WARPS * 32, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, Tq, Tk, KV, G, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], block_q, causal, window, logit_cap, q_offset,
      scale);
  return cudaGetLastError();
}

// The mma.sync body takes bf16 with head_dim a multiple of 16 up to 128
// and operands it can read 16 bytes at a time.
bool mma_ok(int dtype, int hd, const void* q, const void* k, const void* v, const void* o,
            const long long* st) {
  if (dtype != 1 || hd % 16 != 0 || hd > 128) return false;
  const unsigned long long addr = (unsigned long long)q | (unsigned long long)k |
                                  (unsigned long long)v | (unsigned long long)o;
  if (addr % 16 != 0) return false;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8 != 0) return false;
  return true;
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* o, int B, int Tq,
                         int Tk, int KV, int G, int hd, const long long* st, int block_q,
                         int causal, int window, float logit_cap, int q_offset, float scale,
                         cudaStream_t s) {
  switch (hd) {
    case 16: return launch_mma<16>(q, k, v, o, B, Tq, Tk, KV, G, st, block_q, causal, window, logit_cap, q_offset, scale, s);
    case 32: return launch_mma<32>(q, k, v, o, B, Tq, Tk, KV, G, st, block_q, causal, window, logit_cap, q_offset, scale, s);
    case 48: return launch_mma<48>(q, k, v, o, B, Tq, Tk, KV, G, st, block_q, causal, window, logit_cap, q_offset, scale, s);
    case 64: return launch_mma<64>(q, k, v, o, B, Tq, Tk, KV, G, st, block_q, causal, window, logit_cap, q_offset, scale, s);
    case 80: return launch_mma<80>(q, k, v, o, B, Tq, Tk, KV, G, st, block_q, causal, window, logit_cap, q_offset, scale, s);
    case 96: return launch_mma<96>(q, k, v, o, B, Tq, Tk, KV, G, st, block_q, causal, window, logit_cap, q_offset, scale, s);
    case 112: return launch_mma<112>(q, k, v, o, B, Tq, Tk, KV, G, st, block_q, causal, window, logit_cap, q_offset, scale, s);
    case 128: return launch_mma<128>(q, k, v, o, B, Tq, Tk, KV, G, st, block_q, causal, window, logit_cap, q_offset, scale, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Hopper body (bf16, head_dim 64, 128 or 256).  Shared memory, from a
// 1024-byte aligned base (the 128-byte swizzle's period): the Q tile, then
// WG_STAGES K tiles, then WG_STAGES V tiles, then the mbarriers.  Every
// tile is kept as head_dim / 64 column chunks of rows of 128 bytes, each
// chunk one TMA box, as TMA writes them with CU_TENSOR_MAP_SWIZZLE_128B:
// row r at byte 128 r, its 16-byte chunk c at chunk c ^ (r % 8).  That is
// wgmma's 128-byte-swizzle canonical layout with 8-row groups 1024 bytes
// apart.
// ---------------------------------------------------------------------------
constexpr int WG_STAGES = 2;                 // K/V tiles in flight

__host__ __device__ constexpr int wgmma_smem_bytes(int hd, int bm, int bn) {
  return 1024 /* alignment slack */ + 2 * hd * (bm + 2 * WG_STAGES * bn) +
         8 * (2 * WG_STAGES + 1);
}

constexpr int WG_BM = 64, WG_BN = 64;        // the default tile, at every head_dim

// Every instance of the Hopper body, X(head_dim, BM, BN).  At head_dim 256 a
// 128-key tile does not fit a block's 232,448 bytes of shared memory
// (295,976 at BM 64), so that head_dim has 64-key tiles only.
#define FLASH_WGMMA_INSTANCES(X)                                                       \
  X(64, 64, 64) X(64, 64, 128) X(64, 128, 64) X(64, 128, 128)                          \
  X(128, 64, 64) X(128, 64, 128) X(128, 128, 64) X(128, 128, 128)                      \
  X(256, 64, 64) X(256, 128, 64)
#define FLASH_WGMMA_FITS(HD_, BM_, BN_) \
  static_assert(wgmma_smem_bytes(HD_, BM_, BN_) <= 232448, "wgmma tile over shared memory");
FLASH_WGMMA_INSTANCES(FLASH_WGMMA_FITS)
#undef FLASH_WGMMA_FITS

// Blocks per SM each instance's register budget is cut for: three of 64
// rows and two of 128 where the scores and the output fit (head_dim 64 and
// 64-key tiles), else two of 64 rows where two fit the SM's shared memory,
// and one.
__host__ __device__ constexpr int wgmma_min_blocks(int hd, int bm, int bn) {
  return hd == 64 && bn == 64 ? (bm == 64 ? 3 : 2)
         : bm == 64 && 2 * wgmma_smem_bytes(hd, bm, bn) <= 232448 ? 2 : 1;
}

// Threads of the producer: one warp, or a whole warpgroup where two
// consumer warpgroups hold output and score fragments of 128 registers or
// more (hd / 2 + bn / 2 a thread: head_dim 256, and 128 with 128-key
// tiles).  A block of 288 threads is allotted at most 168 registers a
// thread, too few for those; with a producer warpgroup (384 threads)
// setmaxnreg moves the producer's registers to the consumers: 128 x 40 +
// 256 x 232 = 64,512 of the SM's 65,536.
__host__ __device__ constexpr int wgmma_producer_threads(int hd, int bm, int bn) {
  return bm == 128 && hd + bn >= 256 ? 128 : 32;
}
constexpr int WG_PRODUCER_REGS = 40, WG_CONSUMER_REGS = 232;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.  A wait of more
// than 2^32 cycles (seconds) can only be a fault: the kernel traps, and the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start < 0) start = clock64();
    else if (clock64() - start > (1ll << 32)) __trap();
  }
}

// One box of a 4-D tensor map into shared memory; completion is counted on
// `bar` in bytes.  Coordinates are innermost first; rows past the tensor's
// extent arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers a wgmma reads or writes asynchronously: the empty asm keeps the
// compiler from moving their other uses across the fence / wait around it.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22; results
// below float32's normal range flush to zero).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh on the special-function unit (relative error about 2^-11), for the
// logit cap: against the float32 tanhf, one instruction instead of two
// special-function ones and a polynomial a score.
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile at `addr`:
// 8-row groups 1024 bytes apart (stride byte offset); `lbo` is the leading
// byte offset, which only the MN-major V operand reads (the distance between
// its 64-column halves).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma m64nNk16, bf16 in, float32 accumulators.  The accumulator fragment
// of a 64 x N tile: thread t of the warpgroup holds rows 16 (t / 32) + gid
// and + 8 (gid = t % 32 / 4), columns 8 i + 2 tig and + 1 (tig = t % 4) in
// d[4 i .. 4 i + 3] -- the m16n8 layout of each warp repeated over N / 8.
template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  // D (64 x 64) += A B: A and B from shared memory, both K-major
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
  }
  // D (64 x 64) += A B: A from registers, B from shared memory, MN-major
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<128> {
  // D (64 x 128) += A B: A and B from shared memory, both K-major
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
  }
  // D (64 x 128) += A B: A from registers, B from shared memory, MN-major
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// Only PV at head_dim 256 is 256 wide (QK^T there takes 64-key tiles)
template <> struct Wgmma<256> {
  // D (64 x 256) += A B: A from registers, B from shared memory, MN-major
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <int HD, int BM, int BN>
__global__ void __launch_bounds__(BM / 64 * 128 + wgmma_producer_threads(HD, BM, BN),
                                  wgmma_min_blocks(HD, BM, BN))
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       int B, int H, int Tq, int Tk, int G, long long o_sb, long long o_st,
                       long long o_sh, int causal, int window, float logit_cap, int q_offset,
                       float scale) {
  using namespace attn;
  constexpr int NC = BM / 64;                // consumer warpgroups
  constexpr int HALVES = HD / 64;            // 128-byte column chunks of a row
  constexpr int Q_BYTES = BM * HD * 2;
  constexpr int T_BYTES = BN * HD * 2;       // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + Q_BYTES;          // stage s at sK + s * T_BYTES
  const uint32_t sV = sK + WG_STAGES * T_BYTES;
  const uint32_t bar_full = sV + WG_STAGES * T_BYTES;   // + 8 s
  const uint32_t bar_empty = bar_full + 8 * WG_STAGES;  // + 8 s
  const uint32_t bar_q = bar_empty + 8 * WG_STAGES;

  // block -> (query tile, head, batch), the last (heaviest causal) tile first
  const int ntq = (Tq + BM - 1) / BM;
  int idx = blockIdx.x;
  const int h = idx % H;
  idx /= H;
  const int b = idx % B;
  const int p0 = (ntq - 1 - idx / B) * BM;
  const int nq = min(BM, Tq - p0);

  // keys any row of this tile can see
  const int q_lo = q_offset + p0, q_hi = q_offset + p0 + nq - 1;
  const int k_end = causal ? min(Tk, q_hi + 1) : Tk;
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_begin = (k_begin / BN) * BN;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NC * 4);  // one arrival per consumer warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr bool REALLOC = wgmma_producer_threads(HD, BM, BN) == 128;
  if (warp >= NC * 4) {                      // the producer
    if constexpr (REALLOC)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    if (warp == NC * 4 && lane == 0) {
      const int hk = h / G;
      mbar_expect_tx(bar_q, Q_BYTES);
      for (int c = 0; c < HALVES; ++c) tma_load(sQ + c * BM * 128, &tq, bar_q, c * 64, h, p0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % WG_STAGES;
        const int k0 = k_begin + it * BN;
        mbar_wait(bar_empty + 8 * s, ((it / WG_STAGES) & 1) ^ 1);   // the stage is free
        mbar_expect_tx(bar_full + 8 * s, 2 * T_BYTES);
        for (int c = 0; c < HALVES; ++c) {
          tma_load(sK + s * T_BYTES + c * BN * 128, &tk, bar_full + 8 * s, c * 64, hk, k0, b);
          tma_load(sV + s * T_BYTES + c * BN * 128, &tv, bar_full + 8 * s, c * 64, hk, k0, b);
        }
      }
    }
    return;
  }

  if constexpr (REALLOC)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  // a consumer thread: rows row0 and row0 + 8 of the tile
  const int wg = warp >> 2, gid = lane >> 2, tig = lane & 3;
  const int row0 = wg * 64 + (warp & 3) * 16 + gid;
  const int qp0 = q_lo + row0, qp1 = qp0 + 8;
  const uint32_t sQw = sQ + wg * 64 * 128;   // this warpgroup's 64 rows

  // scores, and the running maxima m, are kept in the log2 domain (times
  // log2 e), so each exponential is one exp2_approx
  const float scale2 = scale * LOG2E;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  mbar_wait(bar_q, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % WG_STAGES;
    const int k0 = k_begin + it * BN;
    const uint32_t sKs = sK + s * T_BYTES, sVs = sV + s * T_BYTES;
    mbar_wait(bar_full + 8 * s, (it / WG_STAGES) & 1);

    // S = Q K^T: head_dim / 16 k-steps, each 32 bytes along a swizzled row
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      Wgmma<BN>::ss(sc, sw128_desc(sQw + (kk >> 2) * BM * 128 + (kk & 3) * 32, 16),
                    sw128_desc(sKs + (kk >> 2) * BN * 128 + (kk & 3) * 32, 16), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // scale, cap; the elementwise mask only on tiles that cross the
    // diagonal, the window's edge or Tk.  Each is a pass branched once per
    // tile (a select per score let the compiler evaluate the cap's tanh
    // for every score)
    const bool edge = k0 + BN > Tk || (causal && k0 + BN - 1 > q_lo) ||
                      (window > 0 && k0 <= q_hi - window);
    float mx0 = NEG_INF, mx1 = NEG_INF;
    if (logit_cap > 0.f) {                   // cap * tanh(s scale / cap)
      const float cap_in = scale / logit_cap, cap_out = logit_cap * LOG2E;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = cap_out * tanh_approx(sc[i] * cap_in);
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] *= scale2;
    }
    if (edge) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + n * 8 + 2 * tig + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          const bool ok = kp < Tk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
          if (!ok) sc[4 * n + e] = NEG_INF;
        }
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes that share a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2_approx(m0 - mn0), c1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      sc[4 * n] = exp2_approx(sc[4 * n] - mn0);
      sc[4 * n + 1] = exp2_approx(sc[4 * n + 1] - mn0);
      sc[4 * n + 2] = exp2_approx(sc[4 * n + 2] - mn1);
      sc[4 * n + 3] = exp2_approx(sc[4 * n + 3] - mn1);
      sum0 += sc[4 * n] + sc[4 * n + 1];
      sum1 += sc[4 * n + 2] + sc[4 * n + 3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[4 * n] *= c0;
      acc[4 * n + 1] *= c0;
      acc[4 * n + 2] *= c1;
      acc[4 * n + 3] *= c1;
    }

    // O += P V, P rounded to bf16 in registers: the score blocks 2 kk and
    // 2 kk + 1 are the A fragment of the kk-th 16-key step; V's 16 rows of
    // that step start 2048 bytes apart
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      Wgmma<HD>::rs(acc, pa[kk], sw128_desc(sVs + kk * 16 * 128, BN * 128));
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);   // this warp is done with the stage
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int t0 = p0 + row0, t1 = t0 + 8;
  __nv_bfloat16* o0 = o + b * o_sb + (long long)t0 * o_st + (long long)h * o_sh;
  __nv_bfloat16* o1 = o0 + 8 * o_st;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = n * 8 + 2 * tig;
    if (t0 < Tq)
      *reinterpret_cast<unsigned*>(o0 + c) = pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    if (t1 < Tq)
      *reinterpret_cast<unsigned*>(o1 + c) =
          pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched once through the runtime, so
// the library does not link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map {hd, heads, T, batch} over a bf16 tensor's own strides (in
// elements: per head, per position, per batch), boxes of 64 columns x 1
// head x `rows` positions x 1 batch, 128-byte swizzle, zeros past the edges.
bool encode_map(CUtensorMap* map, const void* ptr, int hd, int heads, int T, int B,
                long long s_h, long long s_t, long long s_b, int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_t * 2, (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int BM, int BN>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Tq,
                         int Tk, int KV, int G, const long long* st, int causal, int window,
                         float logit_cap, int q_offset, float scale, cudaStream_t stream) {
  constexpr int SMEM = wgmma_smem_bytes(HD, BM, BN);
  auto kern = flash_fwd_wgmma_kernel<HD, BM, BN>;
  static unsigned long long ready = 0;       // the attribute is set once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(ready >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    ready |= 1ull << dev;
  }
  const int H = KV * G;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, HD, H, Tq, B, st[2], st[1], st[0], BM) ||
      !encode_map(&tk, k, HD, KV, Tk, B, st[5], st[4], st[3], BN) ||
      !encode_map(&tv, v, HD, KV, Tk, B, st[8], st[7], st[6], BN))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)((Tq + BM - 1) / BM) * H * B;
  kern<<<(unsigned)blocks, BM / 64 * 128 + wgmma_producer_threads(HD, BM, BN), SMEM, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, B, H, Tq, Tk, G, st[9], st[10], st[11], causal, window,
      logit_cap, q_offset, scale);
  return cudaGetLastError();
}

// The Hopper body takes bf16 at head_dim 64, 128 or 256 with 16-byte
// aligned operands and strides that are positive multiples of 16 bytes
// (TMA's rule).
bool wgmma_ok(int dtype, int hd, int Tq, int Tk, const void* q, const void* k, const void* v,
              const void* o, const long long* st) {
  if (dtype != 1 || (hd != 64 && hd != 128 && hd != 256) || Tq < 1 || Tk < 1) return false;
  const unsigned long long addr = (unsigned long long)q | (unsigned long long)k |
                                  (unsigned long long)v | (unsigned long long)o;
  if (addr % 16 != 0) return false;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8 != 0 || (i < 9 && st[i] <= 0)) return false;
  return true;
}

cudaError_t dispatch_wgmma(int hd, int bm, int bn, const void* q, const void* k, const void* v,
                           void* o, int B, int Tq, int Tk, int KV, int G, const long long* st,
                           int causal, int window, float logit_cap, int q_offset, float scale,
                           cudaStream_t s) {
#define FLASH_WGMMA(HD_, BM_, BN_)                                                            \
  if (hd == HD_ && bm == BM_ && bn == BN_)                                                    \
    return launch_wgmma<HD_, BM_, BN_>(q, k, v, o, B, Tq, Tk, KV, G, st, causal, window,      \
                                       logit_cap, q_offset, scale, s);
  FLASH_WGMMA_INSTANCES(FLASH_WGMMA)
#undef FLASH_WGMMA
  return cudaErrorInvalidValue;              // a tile the body lacks
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Tq,
                   int Tk, int KV, int G, int hd, const long long* st, int block_q, int causal,
                   int window, float logit_cap, int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)block_q * G * hd + attn::BK * (hd + 1) +
                                       attn::BK * hd + NWARPS * attn::BK);
  auto kern = flash_fwd_kernel<T, DPL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KV, (Tq + block_q - 1) / block_q);
  kern<<<grid, NWARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Tq, Tk, KV, G, hd, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], block_q, causal, window,
      logit_cap, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dpl, const void* q, const void* k, const void* v, void* o, int B,
                     int Tq, int Tk, int KV, int G, int hd, const long long* st, int block_q,
                     int causal, int window, float logit_cap, int q_offset, float scale,
                     cudaStream_t s) {
  switch (dpl) {
    case 1: return launch<T, 1>(q, k, v, o, B, Tq, Tk, KV, G, hd, st, block_q, causal, window, logit_cap, q_offset, scale, s);
    case 2: return launch<T, 2>(q, k, v, o, B, Tq, Tk, KV, G, hd, st, block_q, causal, window, logit_cap, q_offset, scale, s);
    case 4: return launch<T, 4>(q, k, v, o, B, Tq, Tk, KV, G, hd, st, block_q, causal, window, logit_cap, q_offset, scale, s);
    case 8: return launch<T, 8>(q, k, v, o, B, Tq, Tk, KV, G, hd, st, block_q, causal, window, logit_cap, q_offset, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, o: (B, Tq, H, hd); k, v: (B, Tk, KV, hd), H = KV * G, last dim
// contiguous.
// strides: q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh
// (elements).  dtype 0 = float32, 1 = bfloat16.  window <= 0 and
// logit_cap <= 0 mean none.  block_q / block_k: the Hopper body's tile (64
// or 128 each); the other bodies have one tile, 64 / G query positions by
// 64 keys (G <= 64).  0 takes the body's default.  tuned: bit 0 / bit 1 set
// where block_q / block_k came from the autotune cache, which holds the
// Hopper body's tile: the other bodies take their own there.  *body is set
// to the body launched: 0 CUDA cores, 1 mma.sync, 2 wgmma.  Returns
// cudaGetLastError() after the launch, or an error without launching for a
// tile or an input no body takes.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                        int B, int Tq, int Tk, int KV, int G, int hd,
                        const long long* strides, int causal, int window, float logit_cap,
                        int q_offset, float scale, int block_q, int block_k, int tuned,
                        int* body, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (wgmma_ok(dtype, hd, Tq, Tk, q, k, v, o, strides)) {
    *body = 2;
    return (int)dispatch_wgmma(hd, block_q ? block_q : WG_BM, block_k ? block_k : WG_BN, q, k,
                               v, o, B, Tq, Tk, KV, G, strides, causal, window, logit_cap,
                               q_offset, scale, s);
  }
  if (tuned & 1) block_q = 0;
  if (tuned & 2) block_k = 0;
  if (G > MAX_ROWS || hd % 8 != 0 || hd > 256) return (int)cudaErrorInvalidValue;
  if ((block_q && block_q != MAX_ROWS / G) || (block_k && block_k != attn::BK))
    return (int)cudaErrorInvalidValue;
  int bq = MAX_ROWS / G;                       // query positions per block
  if (bq > Tq) bq = Tq;
  if (bq < 1) bq = 1;
  if (mma_ok(dtype, hd, q, k, v, o, strides)) {
    *body = 1;
    return (int)dispatch_mma(q, k, v, o, B, Tq, Tk, KV, G, hd, strides, bq, causal, window,
                             logit_cap, q_offset, scale, s);
  }
  *body = 0;
  const int dpl = hd <= 32 ? 1 : hd <= 64 ? 2 : hd <= 128 ? 4 : 8;
  cudaError_t err = dtype == 0
      ? dispatch<float>(dpl, q, k, v, o, B, Tq, Tk, KV, G, hd, strides, bq, causal,
                        window, logit_cap, q_offset, scale, s)
      : dispatch<__nv_bfloat16>(dpl, q, k, v, o, B, Tq, Tk, KV, G, hd, strides, bq,
                                causal, window, logit_cap, q_offset, scale, s);
  return (int)err;
}

// The Hopper body's constants, for the launcher to hold its own copies
// against: default_tile[2] (BM, BN), *stages, and *n instances (at most
// `cap`), four ints each in `inst`: head_dim, BM, BN and the shared memory
// of a block.
void flash_wgmma_config(int cap, int* n, int* inst, int* default_tile, int* stages) {
  default_tile[0] = WG_BM;
  default_tile[1] = WG_BN;
  *stages = WG_STAGES;
  *n = 0;
#define FLASH_WGMMA_ROW(HD_, BM_, BN_)                                     \
  if (*n < cap) {                                                          \
    const int row[4] = {HD_, BM_, BN_, wgmma_smem_bytes(HD_, BM_, BN_)};   \
    for (int i = 0; i < 4; ++i) inst[4 * *n + i] = row[i];                 \
  }                                                                        \
  ++*n;
  FLASH_WGMMA_INSTANCES(FLASH_WGMMA_ROW)
#undef FLASH_WGMMA_ROW
}

}  // extern "C"
