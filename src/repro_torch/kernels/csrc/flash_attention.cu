// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/flash_attention.py
// (flash_attention_fwd, body _kernel).
//
// One block per (batch x kv-head, query tile).  The block's rows are the
// query tile's positions times the G query heads of the kv head (the GQA
// group folded into the rows, as the TPU kernel does), so every K/V tile
// staged in shared memory serves all G heads.  Every K tile that causality,
// the window or the key length masks completely is skipped, which halves
// causal work, and the ragged q and k edges are masked here, so the caller
// never pads.
//
// Bound on the card: per (batch, kv head) the work is 4 * G * (unmasked
// query-key pairs) * hd operations against q, k, v and o moved once.  At the
// serving path's shapes (T 512, hd 64, G 3, causal) that is about 190
// operations per byte, just under the H100's bf16 ridge of ~295, so the
// least time is set by the bytes, with the operations close behind: only
// the tensor cores come near either.  Two bodies:
//  - flash_fwd_mma_kernel (bf16, head_dim a multiple of 16 up to 128, 16-byte
//    aligned operands): each of 4 warps owns 16 rows and runs QK^T and PV as
//    mma.sync m16n8k16 bf16 products with float32 accumulators; the scores
//    stay in registers and become the A operand of PV, as in FlashAttention-2.
//  - flash_fwd_kernel (float32, and the other head sizes): CUDA cores.  Each
//    warp owns up to RW rows and keeps their online-softmax state in float32
//    registers; lane j scores keys j and j + 32 of the tile, and the PV
//    product gives each lane head_dim / 32 output columns.
//
// Numerics match the reference: scores are float32 products scaled after
// the QK product, P is rounded to V's dtype before the PV product while l
// sums the unrounded P, and finalisation divides by max(l, 1e-30).
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
// Tensor-core body (bf16).  Fragment layouts are those of PTX's
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

// The tensor-core body takes bf16 with head_dim a multiple of 16 up to 128
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

// q, o: (B, Tq, H, hd); k, v: (B, Tk, KV, hd), H = KV * G <= 64 * KV, last dim
// contiguous.
// strides: q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh
// (elements).  dtype 0 = float32, 1 = bfloat16.  window <= 0 and
// logit_cap <= 0 mean none.  bf16 with head_dim a multiple of 16 up to 128
// and 16-byte aligned operands runs on the tensor cores, the rest on the
// CUDA cores.  Returns cudaGetLastError() after the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                        int B, int Tq, int Tk, int KV, int G, int hd,
                        const long long* strides, int causal, int window, float logit_cap,
                        int q_offset, float scale, void* stream) {
  if (G > MAX_ROWS || hd % 8 != 0 || hd > 256) return (int)cudaErrorInvalidValue;
  int block_q = MAX_ROWS / G;                  // query positions per block
  if (block_q > Tq) block_q = Tq;
  if (block_q < 1) block_q = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (mma_ok(dtype, hd, q, k, v, o, strides))
    return (int)dispatch_mma(q, k, v, o, B, Tq, Tk, KV, G, hd, strides, block_q, causal,
                             window, logit_cap, q_offset, scale, s);
  const int dpl = hd <= 32 ? 1 : hd <= 64 ? 2 : hd <= 128 ? 4 : 8;
  cudaError_t err = dtype == 0
      ? dispatch<float>(dpl, q, k, v, o, B, Tq, Tk, KV, G, hd, strides, block_q, causal,
                        window, logit_cap, q_offset, scale, s)
      : dispatch<__nv_bfloat16>(dpl, q, k, v, o, B, Tq, Tk, KV, G, hd, strides, block_q,
                                causal, window, logit_cap, q_offset, scale, s);
  return (int)err;
}

}  // extern "C"
