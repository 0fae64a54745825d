// Split-K decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/decode_attention.py
// (decode_attention_fwd, body _kernel), reached through decode_attention_kvmajor.
//
// One query token per sequence against its KV cache, valid on [0, pos].
// Bound on the card: each cache byte is used for ~G multiply-adds, far
// below the ~295 operations per byte where compute would limit, so the
// kernel is bound by the bytes of the live cache it reads.  A batch of a few
// sequences has too few (batch x kv-head) rows to fill 132 SMs, so the key
// axis is split (flash-decoding): grid (B*KV, n_split), each block scores
// its key range for all G query heads of the kv head (the G heads share
// every K/V tile read) and writes a partial (m, l, acc) in float32; a second
// small kernel merges the splits.  Tiles past `pos` or before the window are
// never read.  `pos` is read from device memory, so no step synchronises
// with the host and a later version can capture the step in a CUDA graph.
//
// Numerics match the reference: q is scaled first and rounded to its own
// dtype, the dot products and the softmax are float32, and the merge
// divides by max(l, 1e-30).
#include "attn_common.cuh"

namespace {

constexpr int NWARPS = 4;

template <typename T, int DPL>
__global__ void __launch_bounds__(NWARPS * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ pos_ptr, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc, int KV, int G,
                    int S, int hd, long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss, int split_len, int window,
                    float logit_cap, float scale) {
  using namespace attn;
  const int bkv = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = bkv / KV, h = bkv - b * KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos = *pos_ptr;

  extern __shared__ float smem[];
  float* Qs = smem;                            // G rows of hd, pre-scaled
  float* As = Qs + G * hd;                     // G rows of hd: accumulators
  float* Ms = As + G * hd;                     // G running maxima
  float* Ls = Ms + G;                          // G running sums
  float* Ks = Ls + G;                          // BK rows of hd + 1
  float* Vs = Ks + BK * (hd + 1);              // BK rows of hd
  float* Pw = Vs + BK * hd + warp * BK;

  const T* qb = q + (long long)bkv * G * hd;
  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x) {
    Qs[idx] = round_to<T>(to_f(qb[idx]) * scale);
    As[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < G; r += blockDim.x) {
    Ms[r] = NEG_INF;
    Ls[r] = 0.f;
  }
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  const int s_begin = split * split_len;
  const int hi = min(min(S, s_begin + split_len), pos + 1);
  int lo = s_begin;
  if (window > 0) lo = max(lo, pos - window + 1);
  lo = s_begin + ((lo - s_begin) / BK) * BK;

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();                           // previous tile consumed, state initialised
    load_kv_tile(kb, vb, k_ss, v_ss, k0, hi, hd, Ks, Vs);
    __syncthreads();
    for (int r = warp; r < G; r += NWARPS) {
      float s0, s1;
      row_scores(Qs + r * hd, Ks, hd, lane, s0, s1);
      s0 = cap_logit(s0, logit_cap);
      s1 = cap_logit(s1, logit_cap);
      const int kp0 = k0 + lane, kp1 = k0 + lane + 32;
      const bool ok0 = kp0 < hi && (window <= 0 || kp0 > pos - window);
      const bool ok1 = kp1 < hi && (window <= 0 || kp1 > pos - window);
      s0 = ok0 ? s0 : NEG_INF;
      s1 = ok1 ? s1 : NEG_INF;
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      const float corr = expf(m_old - m_new);
      const float l_new = Ls[r] * corr + warp_sum(e0 + e1);
      Pw[lane] = e0;
      Pw[lane + 32] = e1;
      __syncwarp();
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = l_new;
      }
      float* arow = As + r * hd;
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) {
          float a = arow[d] * corr;
          for (int j = 0; j < BK; ++j) a = fmaf(Pw[j], Vs[j * hd + d], a);
          arow[d] = a;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  const long long part = (long long)bkv * n_split + split;
  for (int r = threadIdx.x; r < G; r += blockDim.x) {
    part_m[part * G + r] = Ms[r];
    part_l[part * G + r] = Ls[r];
  }
  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x)
    part_acc[part * G * hd + idx] = As[idx];
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, float* pm,
                   float* pl, float* pa, void* o, int BKV, int KV, int G, int S, int hd,
                   const long long* st, int split_len, int n_split, int window,
                   float logit_cap, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)G * hd + 2 * G + attn::BK * (hd + 1) +
                                       attn::BK * hd + NWARPS * attn::BK);
  auto kern = decode_split_kernel<T, DPL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(BKV, n_split), NWARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, pos, pm, pl, pa, KV, G, S, hd, st[0], st[1],
      st[2], st[3], st[4], st[5], split_len, window, logit_cap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn::merge_splits_kernel<T><<<BKV, 128, 0, stream>>>(pm, pl, pa, (T*)o, G, hd, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dpl, const void* q, const void* k, const void* v, const int* pos,
                     float* pm, float* pl, float* pa, void* o, int BKV, int KV, int G, int S,
                     int hd, const long long* st, int split_len, int n_split, int window,
                     float logit_cap, float scale, cudaStream_t s) {
  switch (dpl) {
    case 1: return launch<T, 1>(q, k, v, pos, pm, pl, pa, o, BKV, KV, G, S, hd, st, split_len, n_split, window, logit_cap, scale, s);
    case 2: return launch<T, 2>(q, k, v, pos, pm, pl, pa, o, BKV, KV, G, S, hd, st, split_len, n_split, window, logit_cap, scale, s);
    case 4: return launch<T, 4>(q, k, v, pos, pm, pl, pa, o, BKV, KV, G, S, hd, st, split_len, n_split, window, logit_cap, scale, s);
    case 8: return launch<T, 8>(q, k, v, pos, pm, pl, pa, o, BKV, KV, G, S, hd, st, split_len, n_split, window, logit_cap, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, o: (B, H, hd) contiguous, H = KV * G; k, v: (B, KV, S, hd) or any layout
// with strides k_sb, k_sh, k_ss (elements) over batch, kv head and slot and a
// contiguous last dim; strides = {k_sb, k_sh, k_ss, v_sb, v_sh, v_ss}.  pos:
// one int32 on the device.  part_m, part_l: (B*KV, n_split, G) float32
// scratch; part_acc: (B*KV, n_split, G, hd).  split_len is a multiple of 64.
// dtype 0 = float32, 1 = bfloat16; window <= 0 and logit_cap <= 0 mean none.
// Returns cudaGetLastError() after the two launches.
int decode_attention_fwd(const void* q, const void* k, const void* v, const void* pos,
                         void* part_m, void* part_l, void* part_acc, void* o, int dtype,
                         int B, int KV, int G, int S, int hd, const long long* strides,
                         int split_len, int n_split, int window, float logit_cap, float scale,
                         void* stream) {
  if (hd % 8 != 0 || hd > 256 || split_len % attn::BK != 0) return (int)cudaErrorInvalidValue;
  const int dpl = hd <= 32 ? 1 : hd <= 64 ? 2 : hd <= 128 ? 4 : 8;
  cudaStream_t s = (cudaStream_t)stream;
  const int* p = (const int*)pos;
  float *pm = (float*)part_m, *pl = (float*)part_l, *pa = (float*)part_acc;
  cudaError_t err = dtype == 0
      ? dispatch<float>(dpl, q, k, v, p, pm, pl, pa, o, B * KV, KV, G, S, hd, strides,
                        split_len, n_split, window, logit_cap, scale, s)
      : dispatch<__nv_bfloat16>(dpl, q, k, v, p, pm, pl, pa, o, B * KV, KV, G, S, hd,
                                strides, split_len, n_split, window, logit_cap, scale, s);
  return (int)err;
}

}  // extern "C"
