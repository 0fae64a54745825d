// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/ssd_scan.py
// (ssd_scan_fwd, body _kernel) together with its wrapper's forming of
// xdt = x * dt and dA = dt * A (repro/kernels/ssd_scan/ops.py).  For each
// (batch, head), a zero initial state, and chunk by chunk:
//   cum    = inclusive cumsum of dA over the chunk            (float32)
//   y[t]   = sum_{s<=t} exp(cum[t]-cum[s]) (C[t].B[s]) xdt[s]  (intra-chunk)
//          + exp(cum[t]) (C[t] . S^T)                          (state entering)
//   S      = S exp(cum[last]) + sum_s xdt[s]^T B[s] exp(cum[last]-cum[s])
//
// Bound on the card: at the Mamba2 serving shape the tensor-core products
// (split ones counted thrice, C B^T once for all heads) bound it, the bytes
// close behind: 0.052 against 0.036 ms (PERF.md).  The standard SSD split,
// two launches per call:
//  1. ssd_chunk_state_kernel, in parallel over (batch, chunk, head): the
//     chunk's cumsum and its own state xdt^T (B exp(cum[last] - cum)); and,
//     in the same launch, over (batch, chunk, 64 x 64 tile below the
//     diagonal): C B^T, once per (batch, chunk) for all heads, into a
//     float32 workspace.  The only sequential part, the P x N state carried
//     across the chunks, S_in[c + 1] = S_in[c] exp(cum[last]) + S_local[c],
//     is done by the block that finishes last of its (batch, head), found by
//     an atomic counter; the final state is the last carry;
//  2. ssd_chunk_scan_kernel, over (batch, chunk, 64-row tile, group of
//     heads): (C B^T masked and decayed per head) xdt, then exp(cum) C
//     S_in^T.  Below the diagonal tile every t is past every s, so the
//     decay factors, exp(cum[t] - cum[s]) = exp(cum[t] - ref) exp(ref -
//     cum[s]) with ref = cum[t0 - 1], both at most 1: the column factor
//     goes with xdt, the row factor scales the result, and C B^T is used
//     as it is for every head of the block.  Only the diagonal tile forms
//     the decay per element and per head, the mask a branch before the
//     exponential (above the diagonal the exponent can overflow).
// The chunk's own state takes its decay to the chunk's end with xdt too,
// so B is used as it is.
// The products run on the tensor cores with float32 sums (mma.sync):
// C B^T in bf16 (m16n8k16) when B and C are bf16, everything else in TF32
// (m16n8k8).  TF32 keeps 10 bits of mantissa, about 5e-4 relative per
// operand, which would use most of the reference's 2e-3; an operand that
// is not exactly a TF32 number is split into big and small TF32 halves
// (x = big + small), and a product of two split operands is three
// products (big.big + big.small + small.big), which keeps float32
// accuracy.  bf16 operands (B and C in a bf16 model) are exact in TF32 and
// are never split.  Which operands are split is fixed here, per operand
// (SPLIT_*, below), from repro_torch.kernels.ssd_scan.precision's run on
// the card (PERF.md): plain TF32 on x dt, on C B^T or on float32 B and C
// moves y past the reference's bound at the Mamba2 shape; on the entering
// state it does with float32 C though not with bf16 C, and one body serves
// both, so it is split too.  (The -D overrides exist for that run only.)
// The kernels read x (B, T, H, P) in the model's dtype, dt (B, T, H) and A
// (H,) in float32 through their strides, form xdt and dA in float32 as the
// reference's wrapper does, and write y (B, T, H, P) float32 in the model's
// layout.  Tiles of x, B, C and C B^T come in through 16-byte cp.async
// (double-buffered in the scan kernel); a view whose pointers or strides
// break the 16-byte rule is copied element by element instead.  Rows past a
// chunk that is not a multiple of 64 are zero-filled.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#ifndef SSD_SPLIT_X
#define SSD_SPLIT_X 1      // x dt, times a decay, against B or C B^T
#endif
#ifndef SSD_SPLIT_W
#define SSD_SPLIT_W 1      // C B^T, and C B^T exp(cum[t] - cum[s]) on the diagonal
#endif
#ifndef SSD_SPLIT_S
#define SSD_SPLIT_S 1      // the state entering a chunk
#endif
#ifndef SSD_SPLIT_F32BC
#define SSD_SPLIT_F32BC 1  // B and C when they are float32
#endif

namespace {

constexpr bool SPLIT_X = SSD_SPLIT_X, SPLIT_W = SSD_SPLIT_W, SPLIT_S = SSD_SPLIT_S,
               SPLIT_F32BC = SSD_SPLIT_F32BC;
constexpr int TILE = 64;   // rows t (and columns s) per tile of a chunk
constexpr int KS = 32;     // rows s per slice of the chunk-state product
constexpr int STAGES1 = 2; // slices in the chunk-state kernel's ring
constexpr int HG = 2;      // heads per block of the scan kernel
constexpr int NT1 = 128;   // threads of the chunk-state kernel
constexpr int NT3 = 256;   // threads of the scan kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Elements a staged row is padded by: 8 puts rows 8 (float32) or 4 (bf16,
// two to a bank) banks apart, so the 4 x 8 lanes of a fragment load whose
// rows follow the lane's q (lane % 4) hit 32 banks, and a row stays a
// multiple of 16 bytes for cp.async.
template <typename T> __host__ __device__ constexpr int pad() { return 8; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, rows) of `cols` elements into dst (leading dimension ld), row r
// read at src + r * st; rows at or past `valid` are zero.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long st, int rows,
                                          int valid, int cols, bool vec, int nthreads) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int nv = cols / V;
    for (int i = threadIdx.x; i < rows * nv; i += nthreads) {
      const int r = i / nv, c = i - r * nv;
      const bool in = r < valid;
      cp_async16(dst + r * ld + c * V, src + (long long)(in ? r : 0) * st + c * V, in);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += nthreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld + c] = r < valid ? src[(long long)r * st + c] : zero<T>();
    }
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as a TF32 operand: big = x rounded to TF32; small = the rest, rounded
// (only where SPLIT).  An exact operand (bf16) is its own bits.
template <bool SPLIT>
__device__ __forceinline__ void to_tf32(float x, uint32_t& big, uint32_t& small) {
  if (SPLIT) {
    big = tf32(x);
    small = tf32(x - __uint_as_float(big));
  } else {
    big = tf32(x);
    small = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The m16n8k8 TF32 A fragment of rows [0, 16) and columns [0, 8) of a
// row-major float tile at `tile` (rows 16-byte aligned): four 8 x 4 blocks
// of 32-bit words, which ldmatrix hands out as the fragment wants them.
__device__ __forceinline__ void ldmatrix_a(uint32_t* a, const uint32_t* tile, int ld) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  const uint32_t* row = tile + (r + 8 * (m & 1)) * ld + 4 * (m >> 1);
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// c += a b with a and b each split or not: the small products first.
template <bool SA, bool SB>
__device__ __forceinline__ void mma3(float* c, const uint32_t* ab, const uint32_t* as,
                                     const uint32_t* bb, const uint32_t* bs) {
  if (SA) mma_tf32(c, as, bb);
  if (SB) mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

template <typename T> __host__ __device__ constexpr bool is_f32() { return sizeof(T) == 4; }

// out[i] = sum_{j <= i} in[j] * mul for i < n (n <= 1024), by NT threads:
// each a run of consecutive elements, then a scan of the runs' totals.
// wtot holds NT / 32 floats.  Ends with a barrier.
template <int NT>
__device__ void block_cumsum(const float* in, float mul, float* out, int n, float* wtot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + NT - 1) / NT, i0 = tid * per;
  float run = 0.f;
  for (int i = i0; i < min(i0 + per, n); ++i) run += in[i] * mul;
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  float pre = incl - run;
  for (int w = 0; w < warp; ++w) pre += wtot[w];
  for (int i = i0; i < min(i0 + per, n); ++i) {
    pre += in[i] * mul;
    out[i] = pre;
  }
  __syncthreads();
}

struct Strides {
  long long x_sb, x_st, x_sh, dt_sb, dt_st, dt_sh, b_sb, b_st, c_sb, c_st;
};

// ---------------------------------------------------------------------------
// 1. Each chunk's own state, and C B^T once per (batch, chunk).
// ---------------------------------------------------------------------------
template <typename TX, typename TB, int P, int N>
__device__ void chunk_state(const TX* __restrict__ x, const float* __restrict__ dt,
                            const float* __restrict__ A, const TB* __restrict__ Bm,
                            float* __restrict__ ws_state, float* __restrict__ tot,
                            float* __restrict__ cum2, float* __restrict__ state_out,
                            int* __restrict__ counters, int H, int nc, int chunk, int T_len,
                            const Strides& st, bool vec_x, bool vec_bc, unsigned char* smem) {
  constexpr int WM = P / 16, WN = 4 / WM, NW = N / WN, NT8 = NW / 8;
  constexpr int LDX = P + pad<TX>(), LDB = N + pad<TB>();
  const int bid = blockIdx.x, h = bid % H, c = (bid / H) % nc, b = bid / (H * nc);
  const int c0 = c * chunk, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int p0 = (warp % WM) * 16, n0 = (warp / WM) * NW;

  constexpr bool SPLIT_B = is_f32<TB>() && SPLIT_F32BC;
  float* sdt = (float*)smem;                     // chunk: dt
  float* w = sdt + 1024;                         // chunk: cum, then dt exp(last - cum)
  float* wtot = w + 1024;                        // NT1 / 32
  TX* Xs = (TX*)(wtot + 32);                     // STAGES1 stages of KS x LDX
  TB* Bs = (TB*)(Xs + STAGES1 * KS * LDX);       // STAGES1 stages of KS x LDB

  const TX* xs = x + b * st.x_sb + (long long)c0 * st.x_st + h * st.x_sh;
  const TB* bs = Bm + b * st.b_sb + (long long)c0 * st.b_st;
  const int nsl = (chunk + KS - 1) / KS;
  auto load = [&](int sl) {
    const int stage = sl % STAGES1, r0 = sl * KS, valid = min(KS, chunk - r0);
    load_rows(Xs + stage * KS * LDX, LDX, xs + (long long)r0 * st.x_st, st.x_st, KS, valid, P,
              vec_x, NT1);
    load_rows(Bs + stage * KS * LDB, LDB, bs + (long long)r0 * st.b_st, st.b_st, KS, valid, N,
              vec_bc, NT1);
  };
  // the first slices are in flight while the cumsum is formed
  for (int sl = 0; sl < STAGES1 - 1; ++sl) {
    if (sl < nsl) load(sl);
    cp_async_commit();
  }

  for (int s = tid; s < chunk; s += NT1)
    sdt[s] = dt[b * st.dt_sb + (long long)(c0 + s) * st.dt_st + h * st.dt_sh];
  __syncthreads();
  block_cumsum<NT1>(sdt, A[h], w, chunk, wtot);
  const float last = w[chunk - 1];
  __syncthreads();
  // the scan kernel's cumsum (times log2 e); the decay to the chunk's end
  // goes with x dt, so B is used as it is
  float* cum_out = cum2 + ((long long)b * H + h) * T_len + c0;
  for (int s = tid; s < chunk; s += NT1) {
    cum_out[s] = w[s] * 1.4426950408889634f;
    w[s] = sdt[s] * expf(last - w[s]);
  }
  if (tid == 0) tot[((long long)b * H + h) * nc + c] = last;

  float acc[NT8][4];
#pragma unroll
  for (int j = 0; j < NT8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int sl = 0; sl < nsl; ++sl) {
    if (sl + STAGES1 - 1 < nsl) load(sl + STAGES1 - 1);
    cp_async_commit();
    cp_async_wait<STAGES1 - 1>();
    __syncthreads();
    const TX* X = Xs + (sl % STAGES1) * KS * LDX;
    const TB* Bt = Bs + (sl % STAGES1) * KS * LDB;
    const int r0 = sl * KS;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 8) {
      // A[p][s] = x[s][p] dt[s] exp(last - cum[s]); rows past the chunk are
      // zero in X and their weight is taken as zero
      const int s0 = kk + q, s1 = kk + q + 4;
      const float d0 = r0 + s0 < chunk ? w[r0 + s0] : 0.f;
      const float d1 = r0 + s1 < chunk ? w[r0 + s1] : 0.f;
      uint32_t ab[4], as[4];
      to_tf32<SPLIT_X>(to_f(X[s0 * LDX + p0 + g]) * d0, ab[0], as[0]);
      to_tf32<SPLIT_X>(to_f(X[s0 * LDX + p0 + g + 8]) * d0, ab[1], as[1]);
      to_tf32<SPLIT_X>(to_f(X[s1 * LDX + p0 + g]) * d1, ab[2], as[2]);
      to_tf32<SPLIT_X>(to_f(X[s1 * LDX + p0 + g + 8]) * d1, ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int n = n0 + 8 * j + g;
        uint32_t bb[2], bsm[2];
        to_tf32<SPLIT_B>(to_f(Bt[s0 * LDB + n]), bb[0], bsm[0]);
        to_tf32<SPLIT_B>(to_f(Bt[s1 * LDB + n]), bb[1], bsm[1]);
        mma3<SPLIT_X, SPLIT_B>(acc[j], ab, as, bb, bsm);
      }
    }
    __syncthreads();   // this stage is free for the slice STAGES1 - 1 ahead
  }
  float* out = ws_state + (((long long)b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
    const int n = n0 + 8 * j + 2 * q;
    *(float2*)(out + (p0 + g) * N + n) = make_float2(acc[j][0], acc[j][1]);
    *(float2*)(out + (p0 + g + 8) * N + n) = make_float2(acc[j][2], acc[j][3]);
  }

  // The block that finishes last of its (batch, head) carries the state
  // across the chunks, S_in[c + 1] = S_in[c] exp(cum[last]) + S_local[c],
  // in place: ws_state[b, c, h] holds chunk c's own state and then the
  // state entering it (chunk 0's stays unread).  The final state is the
  // last carry.  The counter is set back to zero for the next call.
  __threadfence();
  __syncthreads();
  int* last_flag = (int*)wtot;
  if (tid == 0) {
    const int done = atomicAdd(counters + (long long)b * H + h, 1);
    *last_flag = done == nc - 1;
    if (done == nc - 1) counters[(long long)b * H + h] = 0;
  }
  __syncthreads();
  if (*last_flag) {
    __threadfence();
    // EPT float4 of the P x N state a thread, all of them loaded together
    // for each chunk in turn
    constexpr int EPT = P * N / (NT1 * 4);
    static_assert(EPT >= 1 && P * N % (NT1 * 4) == 0, "state split");
    const float* tb = tot + ((long long)b * H + h) * nc;
    float4 sv[EPT];
#pragma unroll
    for (int i = 0; i < EPT; ++i) sv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < nc; ++k) {
      float4* slot = (float4*)(ws_state + (((long long)b * nc + k) * H + h) * P * N) + tid;
      float4 local[EPT];
#pragma unroll
      for (int i = 0; i < EPT; ++i) local[i] = __ldcg(slot + i * NT1);
      const float d = expf(__ldcg(tb + k));
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        if (k > 0) __stcg(slot + i * NT1, sv[i]);
        sv[i] = make_float4(fmaf(sv[i].x, d, local[i].x), fmaf(sv[i].y, d, local[i].y),
                            fmaf(sv[i].z, d, local[i].z), fmaf(sv[i].w, d, local[i].w));
      }
    }
    float4* so = (float4*)(state_out + ((long long)b * H + h) * P * N) + tid;
#pragma unroll
    for (int i = 0; i < EPT; ++i) so[i * NT1] = sv[i];
  }
}

// C B^T for one 64 x 64 tile (rows t, columns s) of one (batch, chunk), at
// or below the diagonal, into ws_cb (B, nc, cpad, cpad).
template <typename TB, int N>
__device__ void chunk_cb(const TB* __restrict__ Bm, const TB* __restrict__ Cm,
                         float* __restrict__ ws_cb, int nc, int chunk, int cpad, int tile,
                         const Strides& st, bool vec_bc, unsigned char* smem) {
  constexpr int LDB = N + pad<TB>();
  const int nt = cpad / TILE, ntri = nt * (nt + 1) / 2;
  const int tri = tile % ntri, bc = tile / ntri, b = bc / nc, c = bc % nc;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tri) ++ti;
  const int si = tri - ti * (ti + 1) / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int c0 = c * chunk, t0 = ti * TILE, s0 = si * TILE;

  TB* Cs = (TB*)smem;              // TILE x LDB
  TB* Bs = Cs + TILE * LDB;        // TILE x LDB
  load_rows(Cs, LDB, Cm + b * st.c_sb + (long long)(c0 + t0) * st.c_st, st.c_st, TILE,
            min(TILE, chunk - t0), N, vec_bc, NT1);
  load_rows(Bs, LDB, Bm + b * st.b_sb + (long long)(c0 + s0) * st.b_st, st.b_st, TILE,
            min(TILE, chunk - s0), N, vec_bc, NT1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int r = warp * 16;
  if constexpr (is_f32<TB>()) {
#pragma unroll 4
    for (int kk = 0; kk < N; kk += 8) {
      uint32_t ab[4], as[4];
      to_tf32<SPLIT_F32BC>(to_f(Cs[(r + g) * LDB + kk + q]), ab[0], as[0]);
      to_tf32<SPLIT_F32BC>(to_f(Cs[(r + g + 8) * LDB + kk + q]), ab[1], as[1]);
      to_tf32<SPLIT_F32BC>(to_f(Cs[(r + g) * LDB + kk + q + 4]), ab[2], as[2]);
      to_tf32<SPLIT_F32BC>(to_f(Cs[(r + g + 8) * LDB + kk + q + 4]), ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bb[2], bsm[2];
        to_tf32<SPLIT_F32BC>(to_f(Bs[(8 * j + g) * LDB + kk + q]), bb[0], bsm[0]);
        to_tf32<SPLIT_F32BC>(to_f(Bs[(8 * j + g) * LDB + kk + q + 4]), bb[1], bsm[1]);
        mma3<SPLIT_F32BC, SPLIT_F32BC>(acc[j], ab, as, bb, bsm);
      }
    }
  } else {
#pragma unroll 4
    for (int kk = 0; kk < N; kk += 16) {
      const uint32_t* C32 = (const uint32_t*)Cs;
      const uint32_t* B32 = (const uint32_t*)Bs;
      constexpr int L = LDB / 2;   // 32-bit words per row
      uint32_t a[4] = {C32[(r + g) * L + kk / 2 + q], C32[(r + g + 8) * L + kk / 2 + q],
                       C32[(r + g) * L + kk / 2 + q + 4], C32[(r + g + 8) * L + kk / 2 + q + 4]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t bw[2] = {B32[(8 * j + g) * L + kk / 2 + q],
                                B32[(8 * j + g) * L + kk / 2 + q + 4]};
        mma_bf16(acc[j], a, bw);
      }
    }
  }
  float* out = ws_cb + ((long long)bc * cpad + t0) * cpad + s0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int s = 8 * j + 2 * q;
    *(float2*)(out + (long long)(r + g) * cpad + s) = make_float2(acc[j][0], acc[j][1]);
    *(float2*)(out + (long long)(r + g + 8) * cpad + s) = make_float2(acc[j][2], acc[j][3]);
  }
}

template <typename TX, typename TB, int P, int N>
__global__ void __launch_bounds__(NT1)
ssd_chunk_state_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const TB* __restrict__ Bm,
                       const TB* __restrict__ Cm, float* __restrict__ ws_state,
                       float* __restrict__ ws_cb, float* __restrict__ tot,
                       float* __restrict__ cum2, float* __restrict__ state_out,
                       int* __restrict__ counters, int H, int nc, int chunk, int cpad,
                       int T_len, int n_state, Strides st, int vec_x, int vec_bc) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x < n_state)
    chunk_state<TX, TB, P, N>(x, dt, A, Bm, ws_state, tot, cum2, state_out, counters, H, nc,
                              chunk, T_len, st, vec_x, vec_bc, smem);
  else
    chunk_cb<TB, N>(Bm, Cm, ws_cb, nc, chunk, cpad, blockIdx.x - n_state, st, vec_bc, smem);
}

// ---------------------------------------------------------------------------
// 2. The output: exp(cum[t]) C[t] S_in^T + sum_{s<=t} W[t][s] xdt[s].
// ---------------------------------------------------------------------------
template <typename TX, typename TB, int P, int N>
__global__ void __launch_bounds__(NT3, 2)
ssd_chunk_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ cum2, const TB* __restrict__ Cm,
                      const float* __restrict__ ws_state, const float* __restrict__ ws_cb,
                      float* __restrict__ y, int H, int nc, int chunk, int cpad, int T_len,
                      Strides st, int vec_x, int vec_bc) {
  constexpr int NH = HG;
  // warps: P / 8 column blocks of 8, the rest along the 64 rows; each warp
  // MT m16 tiles of one n8 column block
  constexpr int WN = P / 8, MT = 4 * WN / 8;
  constexpr int LDX = P + pad<TX>(), LDB = N + pad<TB>(), LDS = N + 4, LDW = TILE + 4;
  constexpr bool SPLIT_C = is_f32<TB>() && SPLIT_F32BC;
  const int ti = blockIdx.x, h0 = blockIdx.y * NH, bc = blockIdx.z, b = bc / nc, c = bc % nc;
  const int nh = min(NH, H - h0), t0 = ti * TILE, c0 = c * chunk;
  const int span = min(t0 + TILE, chunk);     // rows s this tile reads: [0, span)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int n0 = (warp % WN) * 8, m0 = (warp / WN) * MT * 16;

  extern __shared__ __align__(16) unsigned char smem[];
  float* cum = (float*)smem;                  // NH x cpad: cumsum of dA, times log2 e
  float* sdt = cum + NH * cpad;               // NH x cpad: dt (times a decay, below)
  unsigned char* area = (unsigned char*)(sdt + NH * cpad);

  float acc[NH][MT][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[j][i][0] = acc[j][i][1] = acc[j][i][2] = acc[j][i][3] = 0.f;

  float* CBs = (float*)area;                          // 2 stages of TILE x LDW
  TX* Xs = (TX*)(CBs + 2 * TILE * LDW);               // 2 stages of NH x TILE x LDX
  uint32_t* Ab = (uint32_t*)(Xs + 2 * NH * TILE * LDX);   // TILE x LDW: the A operand
  uint32_t* As = Ab + TILE * LDW;                         //   as TF32 big and small
  const float* cb = ws_cb + ((long long)bc * cpad + t0) * cpad;
  auto load = [&](int si) {
    const int stage = si & 1, s0 = si * TILE, valid = min(TILE, chunk - s0);
    load_rows(CBs + stage * TILE * LDW, LDW, cb + s0, cpad, TILE, TILE, TILE, true, NT3);
    for (int j = 0; j < nh; ++j)
      load_rows(Xs + (stage * NH + j) * TILE * LDX, LDX,
                x + b * st.x_sb + (long long)(c0 + s0) * st.x_st + (h0 + j) * st.x_sh,
                st.x_st, TILE, valid, P, vec_x, NT3);
  };
  // acc[j] += A (TILE x TILE, staged) times x dt of head j (s rows of the
  // tile, weighted by dj), over the k steps below kend
  auto product = [&](const TX* X, const float* dj, int s0, int kend, float (*accj)[4]) {
    for (int kk = 0; kk < kend; kk += 8) {
      const int sa = s0 + kk + q, sb = sa + 4;
      uint32_t bb[2], bsm[2];
      to_tf32<SPLIT_X>(sa < span ? to_f(X[(kk + q) * LDX + n0 + g]) * dj[sa] : 0.f, bb[0],
                       bsm[0]);
      to_tf32<SPLIT_X>(sb < span ? to_f(X[(kk + q + 4) * LDX + n0 + g]) * dj[sb] : 0.f,
                       bb[1], bsm[1]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int off = (m0 + 16 * i) * LDW + kk;
        uint32_t ab[4], as[4] = {0u, 0u, 0u, 0u};
        ldmatrix_a(ab, Ab + off, LDW);
        if (SPLIT_W) ldmatrix_a(as, As + off, LDW);
        mma3<SPLIT_W, SPLIT_X>(accj[i], ab, as, bb, bsm);
      }
    }
  };

  load(0);            // in flight while the prologue loads cum and dt
  cp_async_commit();

  for (int i = tid; i < nh * span; i += NT3) {
    const int j = i / span, sidx = i - j * span;
    cum[j * cpad + sidx] = cum2[((long long)b * H + h0 + j) * T_len + c0 + sidx];
    sdt[j * cpad + sidx] =
        dt[b * st.dt_sb + (long long)(c0 + sidx) * st.dt_st + (h0 + j) * st.dt_sh];
  }
  __syncthreads();
  // Below the diagonal tile every t is past every s, and exp(cum[t] -
  // cum[s]) = exp(cum[t] - ref) exp(ref - cum[s]) with ref = cum[t0 - 1]:
  // both factors are at most 1 (cum falls), so neither overflows.  The
  // second goes with x dt, the first scales the rows at the end, and C B^T
  // is used as it is, once for all the block's heads.
  for (int i = tid; i < nh * t0; i += NT3) {
    const int j = i / t0, sidx = i - j * t0;
    sdt[j * cpad + sidx] *= exp2f(cum[j * cpad + t0 - 1] - cum[j * cpad + sidx]);
  }
  __syncthreads();

  for (int si = 0; si <= ti; ++si) {
    if (si < ti) load(si + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* W = CBs + (si & 1) * TILE * LDW;
    const int s0 = si * TILE;
    if (si < ti) {
      // below the diagonal: C B^T, split once for every head
      for (int e = tid; e < TILE * TILE; e += NT3) {
        const int r = e / TILE, sc = e - r * TILE;
        to_tf32<SPLIT_W>(W[r * LDW + sc], Ab[r * LDW + sc], As[r * LDW + sc]);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NH; ++j)
        if (j < nh)
          product(Xs + ((si & 1) * NH + j) * TILE * LDX, sdt + j * cpad, s0, TILE, acc[j]);
    } else {
      // the rows' factor exp(cum[t] - ref) of what lies below the diagonal
      if (ti > 0) {
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          if (j < nh) {
            const float* cj = cum + j * cpad;
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              const int ta = t0 + m0 + 16 * i + g;
              const float e0 = ta < span ? exp2f(cj[ta] - cj[t0 - 1]) : 0.f;
              const float e1 = ta + 8 < span ? exp2f(cj[ta + 8] - cj[t0 - 1]) : 0.f;
              acc[j][i][0] *= e0;
              acc[j][i][1] *= e0;
              acc[j][i][2] *= e1;
              acc[j][i][3] *= e1;
            }
          }
        }
      }
      // the diagonal tile: W = C B^T exp(cum[t] - cum[s]) per head, the mask
      // a branch before the exponential (above the diagonal the exponent
      // can overflow)
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        if (j < nh) {
          const float* cj = cum + j * cpad;
          for (int e = tid; e < TILE * TILE; e += NT3) {
            const int r = e / TILE, sc = e - r * TILE;
            float v = 0.f;
            if (sc <= r && t0 + r < span) v = W[r * LDW + sc] * exp2f(cj[t0 + r] - cj[s0 + sc]);
            to_tf32<SPLIT_W>(v, Ab[r * LDW + sc], As[r * LDW + sc]);
          }
          __syncthreads();
          // k steps wholly above this warp's rows are zero
          product(Xs + ((si & 1) * NH + j) * TILE * LDX, sdt + j * cpad, s0,
                  m0 + MT * 16, acc[j]);
          __syncthreads();
        }
      }
    }
    __syncthreads();   // this stage and A are free again
  }

  // the state entering the chunk (zero in chunk 0): exp(cum[t]) C[t] S^T,
  // the next head's state in flight while one is multiplied
  if (c > 0) {
    TB* Cs = (TB*)area;                       // TILE x LDB
    float* Ss = (float*)(Cs + TILE * LDB);    // 2 x P x LDS
    auto load_state = [&](int j) {
      load_rows(Ss + (j & 1) * P * LDS, LDS,
                ws_state + (((long long)b * nc + c) * H + h0 + j) * P * N, N, P, P, N, true,
                NT3);
    };
    load_rows(Cs, LDB, Cm + b * st.c_sb + (long long)(c0 + t0) * st.c_st, st.c_st, TILE,
              span - t0, N, vec_bc, NT3);
    load_state(0);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      if (j < nh) {
        if (j + 1 < nh) load_state(j + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* S = Ss + (j & 1) * P * LDS;
        float tmp[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) tmp[i][0] = tmp[i][1] = tmp[i][2] = tmp[i][3] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < N; kk += 8) {
          uint32_t bb[2], bsm[2];
          to_tf32<SPLIT_S>(S[(n0 + g) * LDS + kk + q], bb[0], bsm[0]);
          to_tf32<SPLIT_S>(S[(n0 + g) * LDS + kk + q + 4], bb[1], bsm[1]);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int ra = (m0 + 16 * i + g) * LDB + kk + q, rb = ra + 8 * LDB;
            uint32_t ab[4], as[4];
            to_tf32<SPLIT_C>(to_f(Cs[ra]), ab[0], as[0]);
            to_tf32<SPLIT_C>(to_f(Cs[rb]), ab[1], as[1]);
            to_tf32<SPLIT_C>(to_f(Cs[ra + 4]), ab[2], as[2]);
            to_tf32<SPLIT_C>(to_f(Cs[rb + 4]), ab[3], as[3]);
            mma3<SPLIT_C, SPLIT_S>(tmp[i], ab, as, bb, bsm);
          }
        }
        __syncthreads();   // this state's buffer is free for the head after next
        const float* cj = cum + j * cpad;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int ta = t0 + m0 + 16 * i + g;
          const float e0 = ta < span ? exp2f(cj[ta]) : 0.f;
          const float e1 = ta + 8 < span ? exp2f(cj[ta + 8]) : 0.f;
          acc[j][i][0] = fmaf(tmp[i][0], e0, acc[j][i][0]);
          acc[j][i][1] = fmaf(tmp[i][1], e0, acc[j][i][1]);
          acc[j][i][2] = fmaf(tmp[i][2], e1, acc[j][i][2]);
          acc[j][i][3] = fmaf(tmp[i][3], e1, acc[j][i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NH; ++j) {
    if (j < nh) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = t0 + m0 + 16 * i + g + 8 * half;
          if (t < chunk)
            *(float2*)(y + (((long long)b * T_len + c0 + t) * H + h0 + j) * P + n0 + 2 * q) =
                make_float2(acc[j][i][2 * half], acc[j][i][2 * half + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
template <typename TX, typename TB, int P, int N>
size_t smem1() {
  const size_t state = sizeof(float) * (1024 + 1024 + 32) +
                       STAGES1 * KS *
                           ((P + pad<TX>()) * sizeof(TX) + (N + pad<TB>()) * sizeof(TB));
  const size_t cb = 2 * (size_t)TILE * (N + pad<TB>()) * sizeof(TB);
  return state > cb ? state : cb;
}

template <typename TX, typename TB, int P, int N>
size_t smem3(int cpad) {
  constexpr int NH = HG;
  const size_t head = sizeof(float) * 2 * (size_t)NH * cpad;
  const size_t inter =
      (size_t)TILE * (N + pad<TB>()) * sizeof(TB) + sizeof(float) * 2 * P * (N + 4);
  const size_t intra = 2 * ((size_t)TILE * (TILE + 4) * sizeof(float) +
                            (size_t)NH * TILE * (P + pad<TX>()) * sizeof(TX)) +
                       sizeof(uint32_t) * 2 * TILE * (TILE + 4);
  return head + (inter > intra ? inter : intra);
}

template <typename TX, typename TB, int P, int N>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, float* y, float* state, float* ws, int* counters, int B, int H,
                   int T_len, int chunk, const Strides& st, int vec_x, int vec_bc,
                   cudaStream_t stream) {
  const int nc = T_len / chunk, cpad = (chunk + TILE - 1) / TILE * TILE, nt = cpad / TILE;
  float* ws_state = ws;
  float* ws_cb = ws_state + (size_t)B * nc * H * P * N;
  float* tot = ws_cb + (size_t)B * nc * cpad * cpad;
  float* cum2 = tot + (size_t)B * H * nc;
  const size_t s1 = smem1<TX, TB, P, N>(), s3 = smem3<TX, TB, P, N>(cpad);
  auto k1 = ssd_chunk_state_kernel<TX, TB, P, N>;
  auto k3 = ssd_chunk_scan_kernel<TX, TB, P, N>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s3);
  if (err != cudaSuccess) return err;
  const int n_state = B * nc * H, n_cb = B * nc * nt * (nt + 1) / 2;
  k1<<<n_state + n_cb, NT1, s1, stream>>>((const TX*)x, dt, A, (const TB*)Bm, (const TB*)Cm,
                                          ws_state, ws_cb, tot, cum2, state, counters, H, nc,
                                          chunk, cpad, T_len, n_state, st, vec_x, vec_bc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k3<<<dim3(nt, (H + HG - 1) / HG, B * nc), NT3, s3, stream>>>(
      (const TX*)x, dt, cum2, (const TB*)Cm, ws_state, ws_cb, y, H, nc, chunk, cpad, T_len, st,
      vec_x, vec_bc);
  return cudaGetLastError();
}

template <typename TX, typename TB, int P>
cudaError_t by_n(int N, const void* x, const float* dt, const float* A, const void* Bm,
                 const void* Cm, float* y, float* state, float* ws, int* cnt, int B, int H,
                 int T_len, int chunk, const Strides& st, int vx, int vb, cudaStream_t s) {
  switch (N) {
    case 16: return launch<TX, TB, P, 16>(x, dt, A, Bm, Cm, y, state, ws, cnt, B, H, T_len, chunk, st, vx, vb, s);
    case 32: return launch<TX, TB, P, 32>(x, dt, A, Bm, Cm, y, state, ws, cnt, B, H, T_len, chunk, st, vx, vb, s);
    case 64: return launch<TX, TB, P, 64>(x, dt, A, Bm, Cm, y, state, ws, cnt, B, H, T_len, chunk, st, vx, vb, s);
    case 128: return launch<TX, TB, P, 128>(x, dt, A, Bm, Cm, y, state, ws, cnt, B, H, T_len, chunk, st, vx, vb, s);
  }
  return cudaErrorInvalidValue;
}

template <typename TX, typename TB>
cudaError_t by_p(int P, int N, const void* x, const float* dt, const float* A, const void* Bm,
                 const void* Cm, float* y, float* state, float* ws, int* cnt, int B, int H,
                 int T_len, int chunk, const Strides& st, int vx, int vb, cudaStream_t s) {
  switch (P) {
    case 32: return by_n<TX, TB, 32>(N, x, dt, A, Bm, Cm, y, state, ws, cnt, B, H, T_len, chunk, st, vx, vb, s);
    case 64: return by_n<TX, TB, 64>(N, x, dt, A, Bm, Cm, y, state, ws, cnt, B, H, T_len, chunk, st, vx, vb, s);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p, std::initializer_list<long long> strides, size_t size) {
  if ((size_t)p % 16) return false;
  for (long long s : strides)
    if ((s * (long long)size) % 16) return false;
  return true;
}

}  // namespace

extern "C" {

// The launcher's constants, for the Python side to check: {TILE, heads per
// output block, kernels per call}.
void ssd_scan_config(int* out) {
  out[0] = TILE;
  out[1] = HG;
  out[2] = 2;
}

// x: (B, T, H, P) float32 (x_dtype 0) or bfloat16 (1) with strides {x_sb,
// x_st, x_sh} and a contiguous last dim; dt: (B, T, H) float32 with strides
// {dt_sb, dt_st, dt_sh}; A: (H,) float32 contiguous; Bm, Cm: (B, T, N)
// float32 (bc_dtype 0) or bfloat16 (1) with strides {b_sb, b_st}, {c_sb,
// c_st} and a contiguous last dim; strides = {x_sb, x_st, x_sh, dt_sb,
// dt_st, dt_sh, b_sb, b_st, c_sb, c_st} in elements.  y: (B, T, H, P)
// float32 contiguous; state: (B, H, P, N) float32, written with the final
// state; ws: B * nc * (H * P * N + cpad^2 + H) + B * H * T float32 (cpad:
// the chunk rounded up to whole tiles).  P in {32, 64}, N in {16, 32, 64, 128},
// 1 <= chunk <= 1024, T % chunk == 0.  Three launches; returns
// cudaGetLastError() after them.
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                 void* y, void* state, void* ws, void* counters, int x_dtype, int bc_dtype, int B,
                 int H,
                 int T_len, int P, int N, int chunk, const long long* strides, void* stream) {
  if (chunk < 1 || chunk > 1024 || T_len % chunk != 0) return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8], strides[9]};
  const size_t xs = x_dtype == 0 ? 4 : 2, bs = bc_dtype == 0 ? 4 : 2;
  const int vx = aligned16(x, {st.x_sb, st.x_st, st.x_sh}, xs);
  const int vb = aligned16(Bm, {st.b_sb, st.b_st}, bs) && aligned16(Cm, {st.c_sb, st.c_st}, bs);
  cudaStream_t s = (cudaStream_t)stream;
  const float *d = (const float*)dt, *a = (const float*)A;
  float *yo = (float*)y, *so = (float*)state, *w = (float*)ws;
  int* cnt = (int*)counters;
  cudaError_t err;
  if (x_dtype == 0 && bc_dtype == 0)
    err = by_p<float, float>(P, N, x, d, a, Bm, Cm, yo, so, w, cnt, B, H, T_len, chunk, st, vx, vb, s);
  else if (x_dtype == 0)
    err = by_p<float, __nv_bfloat16>(P, N, x, d, a, Bm, Cm, yo, so, w, cnt, B, H, T_len, chunk, st, vx, vb, s);
  else if (bc_dtype == 0)
    err = by_p<__nv_bfloat16, float>(P, N, x, d, a, Bm, Cm, yo, so, w, cnt, B, H, T_len, chunk, st, vx, vb, s);
  else
    err = by_p<__nv_bfloat16, __nv_bfloat16>(P, N, x, d, a, Bm, Cm, yo, so, w, cnt, B, H, T_len, chunk, st, vx, vb, s);
  return (int)err;
}

}  // extern "C"
