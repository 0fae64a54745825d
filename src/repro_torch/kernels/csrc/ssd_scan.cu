// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/ssd_scan.py
// (ssd_scan_fwd, body _kernel).  For one (batch, head) and a zero initial
// state, chunk by chunk:
//   cum    = inclusive cumsum of dA over the chunk            (float32)
//   y[t]   = sum_{s<=t} exp(cum[t]-cum[s]) (C[t].B[s]) xdt[s]  (intra-chunk)
//          + exp(cum[t]) (C[t] . S^T)                          (state entering)
//   S      = S exp(cum[last]) + sum_s xdt[s]^T B[s] exp(cum[last]-cum[s])
// y is written before S is advanced: the inter-chunk term reads the state
// that enters the chunk.
//
// Bound on the card: per (b, h) and chunk of c rows the work is about
// c^2 (N + P) + 2 c P N multiply-adds against c (2 P + 2 N) values moved,
// some 60 operations per byte at the serving shape (c 256, P 64, N 128):
// above the float32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s = 20), so
// the kernel is bound by arithmetic.  This first version does it in
// float32 on the CUDA cores.  Design: one block of 256 threads per
// (b, h), looping over the chunks in order (the TPU grid's sequential
// axis); the P x N state lives in shared memory for the whole sequence.  A
// 256 x 256 float32 decay tile would be 256 KB, more than a block may
// have, so the chunk is tiled: 64 rows t at a time, and for each the
// 64-column s tiles up to the diagonal (tiles above it are never
// computed).  C and B stream through shared memory 16 state columns at a
// time; each thread keeps a 4 x (P/16) block of y and a 4 x 4 block of
// scores in registers.  Above the diagonal exp(cum[t]-cum[s]) can
// overflow, so the mask is a branch taken before the exponential, never a
// multiplication by zero.  C B^T is recomputed per head, as on the TPU
// (B and C are shared by all heads); sharing it is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block: a 16 x 16 grid (ty, tx)
constexpr int TT = 64;   // rows t per tile
constexpr int TS = 64;   // columns s per tile of the intra-chunk term
constexpr int NK = 16;   // state columns n per streamed slice of C and B
constexpr int SU = 32;   // rows s per slice of the state update
constexpr int WLD = TS + 1;
constexpr int KLD = NK + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Inclusive prefix sum of row[0, n) into cum, by warp scans and a carry
// across rounds of NT values.  wtot holds NT / 32 floats.
__device__ void chunk_cumsum(const float* __restrict__ row, float* cum, int n, float* wtot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < n; base += NT) {
    const int i = base + tid;
    float v = i < n ? row[i] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wtot[warp] = v;
    __syncthreads();
    float pre = carry, tot = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      if (w < warp) pre += wtot[w];
      tot += wtot[w];
    }
    if (i < n) cum[i] = v + pre;
    carry += tot;
    __syncthreads();
  }
}

// rows [r0, r0 + R) of a (time, n) matrix, columns [n0, n0 + NK), into
// dst[r * KLD + k]; rows at or past `rows` read as zero.
template <typename T, int R>
__device__ __forceinline__ void load_slice(const T* __restrict__ m, long long st, int r0,
                                           int rows, int n0, float* dst) {
  for (int idx = threadIdx.x; idx < R * NK; idx += NT) {
    const int r = idx / NK, k = idx - r * NK;
    dst[r * KLD + k] = r0 + r < rows ? to_f(m[(long long)(r0 + r) * st + n0 + k]) : 0.f;
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT, 2)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ state_out, int H, int T_len, int chunk, long long b_sb,
                long long b_st, long long c_sb, long long c_st) {
  constexpr int PC = P / 16, NC = N / 16, XLD = P + 1, SLD = N + 1;
  const int bh = blockIdx.x, b = bh / H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int chunk_pad = (chunk + TT - 1) / TT * TT;

  extern __shared__ float smem[];
  float* Ss = smem;                  // P x SLD: the running state
  float* Ws = Ss + P * SLD;          // TT x WLD scores; the state update's B slice
  float* Xs = Ws + TT * WLD;         // TS x XLD xdt tile; the state update's xdt slice
  float* Cs = Xs + TS * XLD;         // TT x KLD slice of C
  float* Bs = Cs + TT * KLD;         // TS x KLD slice of B
  float* cum = Bs + TS * KLD;        // chunk_pad
  float* wtot = cum + chunk_pad;     // NT / 32

  const float* xb = xdt + (long long)bh * T_len * P;
  float* yb = y + (long long)bh * T_len * P;
  const T* Bb = Bm + b * b_sb;
  const T* Cb = Cm + b * c_sb;

  for (int idx = tid; idx < P * SLD; idx += NT) Ss[idx] = 0.f;

  for (int c0 = 0; c0 < T_len; c0 += chunk) {
    __syncthreads();  // the state update of the previous chunk is done
    chunk_cumsum(dA + (long long)bh * T_len + c0, cum, chunk, wtot);
    const float* xc = xb + (long long)c0 * P;
    const T* Bc = Bb + c0 * b_st;
    const T* Cc = Cb + c0 * c_st;

    for (int t0 = 0; t0 < chunk; t0 += TT) {
      float acc[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;

      // inter-chunk term: exp(cum[t]) * C[t] . S^T (zero state in chunk 0)
      if (c0 > 0) {
        for (int n0 = 0; n0 < N; n0 += NK) {
          load_slice<T, TT>(Cc, c_st, t0, chunk, n0, Cs);
          __syncthreads();
#pragma unroll
          for (int k = 0; k < NK; ++k) {
            float cv[4], sv[PC];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * KLD + k];
#pragma unroll
            for (int j = 0; j < PC; ++j) sv[j] = Ss[(tx + 16 * j) * SLD + n0 + k];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
          const float e = t < chunk ? expf(cum[t]) : 0.f;
#pragma unroll
          for (int j = 0; j < PC; ++j) acc[i][j] *= e;
        }
      }

      // intra-chunk term over the s tiles up to the diagonal
      for (int s0 = 0; s0 <= t0; s0 += TS) {
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int n0 = 0; n0 < N; n0 += NK) {
          load_slice<T, TT>(Cc, c_st, t0, chunk, n0, Cs);
          load_slice<T, TS>(Bc, b_st, s0, chunk, n0, Bs);
          __syncthreads();
#pragma unroll
          for (int k = 0; k < NK; ++k) {
            float cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * KLD + k];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * KLD + k];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            float w = 0.f;
            if (s <= t && t < chunk) w = sc[i][j] * expf(cum[t] - cum[s]);
            Ws[(ty + 16 * i) * WLD + tx + 16 * j] = w;
          }
        }
        for (int idx = tid; idx < TS * P; idx += NT) {
          const int r = idx / P, p = idx - r * P;
          Xs[r * XLD + p] = s0 + r < chunk ? xc[(long long)(s0 + r) * P + p] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int s = 0; s < TS; ++s) {
          float wv[4], xv[PC];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = Ws[(ty + 16 * i) * WLD + s];
#pragma unroll
          for (int j = 0; j < PC; ++j) xv[j] = Xs[s * XLD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t < chunk) {
#pragma unroll
          for (int j = 0; j < PC; ++j) yb[(long long)(c0 + t) * P + tx + 16 * j] = acc[i][j];
        }
      }
    }

    // state update: S = S exp(cum[last]) + xdt^T (B * exp(cum[last] - cum))
    const float last = cum[chunk - 1];
    float su[PC][NC];
#pragma unroll
    for (int i = 0; i < PC; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) su[i][j] = 0.f;
    float* Bd = Ws;  // SU x N  (fits: SU * N <= TT * WLD for N <= 128)
    float* Xu = Xs;  // SU x P
    for (int s0 = 0; s0 < chunk; s0 += SU) {
      for (int idx = tid; idx < SU * N; idx += NT) {
        const int r = idx / N, n = idx - r * N;
        const int s = s0 + r;
        Bd[idx] = s < chunk ? to_f(Bc[(long long)s * b_st + n]) * expf(last - cum[s]) : 0.f;
      }
      for (int idx = tid; idx < SU * P; idx += NT) {
        const int r = idx / P;
        Xu[idx] = s0 + r < chunk ? xc[(long long)s0 * P + idx] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < SU; ++s) {
        float xv[PC], bv[NC];
#pragma unroll
        for (int i = 0; i < PC; ++i) xv[i] = Xu[s * P + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NC; ++j) bv[j] = Bd[s * N + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < PC; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) su[i][j] = fmaf(xv[i], bv[j], su[i][j]);
      }
      __syncthreads();
    }
    const float decay = expf(last);
#pragma unroll
    for (int i = 0; i < PC; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float* sp = Ss + (ty + 16 * i) * SLD + tx + 16 * j;
        *sp = fmaf(*sp, decay, su[i][j]);
      }
  }
  __syncthreads();
  float* so = state_out + (long long)bh * P * N;
  for (int idx = tid; idx < P * N; idx += NT) {
    const int p = idx / N, n = idx - p * N;
    so[idx] = Ss[p * SLD + n];
  }
}

template <typename T, int P, int N>
cudaError_t launch(const float* xdt, const float* dA, const void* Bm, const void* Cm, float* y,
                   float* state, int B, int H, int T_len, int chunk, const long long* st,
                   cudaStream_t stream) {
  const int chunk_pad = (chunk + TT - 1) / TT * TT;
  const size_t smem = sizeof(float) * ((size_t)P * (N + 1) + TT * WLD + TS * (P + 1) +
                                       TT * KLD + TS * KLD + chunk_pad + NT / 32);
  auto kern = ssd_scan_kernel<T, P, N>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B * H, NT, smem, stream>>>(xdt, dA, (const T*)Bm, (const T*)Cm, y, state, H, T_len,
                                    chunk, st[0], st[1], st[2], st[3]);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t by_n(int N, const float* xdt, const float* dA, const void* Bm, const void* Cm,
                 float* y, float* state, int B, int H, int T_len, int chunk,
                 const long long* st, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, P, 16>(xdt, dA, Bm, Cm, y, state, B, H, T_len, chunk, st, s);
    case 32: return launch<T, P, 32>(xdt, dA, Bm, Cm, y, state, B, H, T_len, chunk, st, s);
    case 64: return launch<T, P, 64>(xdt, dA, Bm, Cm, y, state, B, H, T_len, chunk, st, s);
    case 128: return launch<T, P, 128>(xdt, dA, Bm, Cm, y, state, B, H, T_len, chunk, st, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_p(int P, int N, const float* xdt, const float* dA, const void* Bm,
                 const void* Cm, float* y, float* state, int B, int H, int T_len, int chunk,
                 const long long* st, cudaStream_t s) {
  switch (P) {
    case 32: return by_n<T, 32>(N, xdt, dA, Bm, Cm, y, state, B, H, T_len, chunk, st, s);
    case 64: return by_n<T, 64>(N, xdt, dA, Bm, Cm, y, state, B, H, T_len, chunk, st, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// xdt, y: (B, H, T, P) float32 contiguous; dA: (B, H, T) float32 contiguous;
// Bm, Cm: (B, T, N) with strides {b_sb, b_st, c_sb, c_st} (elements) over
// batch and time and a contiguous last dim, float32 (dtype 0) or bfloat16
// (dtype 1); state: (B, H, P, N) float32, written with the final state.
// P in {32, 64}, N in {16, 32, 64, 128}, 1 <= chunk <= 1024, T % chunk == 0.
// Returns cudaGetLastError() after the launch.
int ssd_scan_fwd(const void* xdt, const void* dA, const void* Bm, const void* Cm, void* y,
                 void* state, int dtype, int B, int H, int T_len, int P, int N, int chunk,
                 const long long* strides, void* stream) {
  if (chunk < 1 || chunk > 1024 || T_len % chunk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *x = (const float*)xdt, *a = (const float*)dA;
  float *yo = (float*)y, *so = (float*)state;
  cudaError_t err =
      dtype == 0
          ? by_p<float>(P, N, x, a, Bm, Cm, yo, so, B, H, T_len, chunk, strides, s)
          : by_p<__nv_bfloat16>(P, N, x, a, Bm, Cm, yo, so, B, H, T_len, chunk, strides, s);
  return (int)err;
}

}  // extern "C"
