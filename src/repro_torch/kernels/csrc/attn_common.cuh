// Helpers shared by the attention kernels (flash prefill, split-K decode,
// paged split-K decode).
//
// Numerics follow the JAX reference: NEG_INF is the finite -2^30 (a fully
// masked row averages V instead of turning into NaN), every score and the
// online-softmax state are float32, and finalisation clamps l at 1e-30.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr float NEG_INF = -1073741824.0f;  // -2^30
constexpr int BK = 64;                      // keys per shared-memory tile: two per lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision and read back as float (a cast to T and back).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float cap_logit(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// Copy keys [k0, k0 + BK) of one head into shared memory as float, zeros
// past `len`.  K rows are padded to hd + 1 floats so that lane j reading
// row j walks 32 different banks; V rows are read along d and need no pad.
template <typename T>
__device__ __forceinline__ void load_kv_tile(const T* __restrict__ k, const T* __restrict__ v,
                                             long long k_ss, long long v_ss, int k0, int len,
                                             int hd, float* Ks, float* Vs) {
  for (int idx = threadIdx.x; idx < BK * hd; idx += blockDim.x) {
    const int j = idx / hd, d = idx - j * hd;
    const int s = k0 + j;
    const bool in = s < len;
    Ks[j * (hd + 1) + d] = in ? to_f(k[(long long)s * k_ss + d]) : 0.f;
    Vs[j * hd + d] = in ? to_f(v[(long long)s * v_ss + d]) : 0.f;
  }
}

// Raw scores of one query row against the two keys this lane owns
// (tile rows `lane` and `lane + 32`).
__device__ __forceinline__ void row_scores(const float* qrow, const float* Ks, int hd, int lane,
                                           float& s0, float& s1) {
  const float* k0 = Ks + lane * (hd + 1);
  const float* k1 = Ks + (lane + 32) * (hd + 1);
  float a0 = 0.f, a1 = 0.f;
  for (int d = 0; d < hd; ++d) {
    const float qd = qrow[d];
    a0 = fmaf(qd, k0[d], a0);
    a1 = fmaf(qd, k1[d], a1);
  }
  s0 = a0;
  s1 = a1;
}

}  // namespace attn
