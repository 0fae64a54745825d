// Paged split-K decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention/paged_decode_attention.py (paged_decode_attention_fwd,
// body _paged_kernel) together with its wrapper's pool transpose
// (repro/kernels/decode_attention/ops.py, _paged_decode_attention).
//
// One new query per live slot against its own kv_lens[b] keys, which live in
// pages block_tables[b, :] of a pool shared by all slots.  Bound on the card:
// like the dense decode kernel, each key byte is used for ~G multiply-adds,
// far below the ~295 operations per byte where compute would limit, so the
// least time is the bytes of the live keys.  What the design does about it:
//  - the pool is read in place, (P, psz, KV, hd) through its strides: the
//    kernel turns (slot, kv head, logical key) into an address itself, so
//    no call copies or transposes the pool;
//  - the key axis is split across blocks (grid (B*KV, n_split)) so that a
//    small batch still fills the SMs; each split writes a partial
//    (m, l, acc) in float32 and attn::merge_splits_kernel merges them.  The
//    plan depends on shapes only: kv_lens stays on the device and nothing
//    synchronises with the host;
//  - keys at or past kv_lens[b], or outside the window, are never read: the
//    block's loop bound comes from kv_lens on the device, and a table entry
//    is read only for a page that holds a key the slot attends, so entries
//    past a slot's length may hold anything;
//  - keys are staged 64 at a time in shared memory whatever the page size:
//    a 64-key tile may span several small pages or be part of a large one,
//    and each of its rows is looked up through the table once.
// A freed slot (length 0), or a split wholly past the length, writes
// m = NEG_INF, l = 0 and acc = 0, which the merge turns into exact zeros.
//
// Numerics match the reference: q is scaled first and rounded to its own
// dtype, the dot products and the softmax are float32, and the merge
// divides by max(l, 1e-30).
#include "attn_common.cuh"

namespace {

constexpr int NWARPS = 4;

template <typename T, int DPL>
__global__ void __launch_bounds__(NWARPS * 32)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                   const int* __restrict__ lens, const int* __restrict__ tbl,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int KV, int G, int hd, int psz,
                   int ns, long long tbl_sb, long long k_sp, long long k_ss, long long k_sh,
                   long long v_sp, long long v_ss, long long v_sh, int split_len, int window,
                   float logit_cap, float scale) {
  using namespace attn;
  const int bkv = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = bkv / KV, h = bkv - b * KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = lens[b];

  extern __shared__ __align__(16) float smem[];
  long long* Koff = reinterpret_cast<long long*>(smem);  // BK pool offsets of K rows, -1: skip
  long long* Voff = Koff + BK;                           // BK pool offsets of V rows
  float* Qs = reinterpret_cast<float*>(Voff + BK);       // G rows of hd, pre-scaled
  float* As = Qs + G * hd;                               // G rows of hd: accumulators
  float* Ms = As + G * hd;                               // G running maxima
  float* Ls = Ms + G;                                    // G running sums
  float* Ks = Ls + G;                                    // BK rows of hd + 1
  float* Vs = Ks + BK * (hd + 1);                        // BK rows of hd
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

  // this split's keys that the slot attends lie in [max(lo, w_lo), hi);
  // none lies past the table's ns pages, whatever the length says
  const int w_lo = window > 0 ? len - window : 0;
  const int s_begin = split * split_len;
  const int hi = min(min(s_begin + split_len, len), ns * psz);
  int lo = max(s_begin, w_lo);
  lo = s_begin + ((lo - s_begin) / BK) * BK;   // tiles start at split-relative multiples of BK
  const int* tb = tbl + b * tbl_sb;

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();                           // previous tile consumed, state initialised
    if (threadIdx.x < BK) {
      const int s = k0 + threadIdx.x;
      long long ko = -1, vo = -1;
      if (s < hi && s >= w_lo) {
        const int page = s / psz;
        const long long phys = tb[page];
        const long long slot = s - page * psz;
        ko = phys * k_sp + slot * k_ss + h * k_sh;
        vo = phys * v_sp + slot * v_ss + h * v_sh;
      }
      Koff[threadIdx.x] = ko;
      Voff[threadIdx.x] = vo;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BK * hd; idx += blockDim.x) {
      const int j = idx / hd, d = idx - j * hd;
      const long long ko = Koff[j];
      Ks[j * (hd + 1) + d] = ko >= 0 ? to_f(kp[ko + d]) : 0.f;
      Vs[j * hd + d] = ko >= 0 ? to_f(vp[Voff[j] + d]) : 0.f;
    }
    __syncthreads();
    const bool ok0 = Koff[lane] >= 0, ok1 = Koff[lane + 32] >= 0;
    for (int r = warp; r < G; r += NWARPS) {
      float s0, s1;
      row_scores(Qs + r * hd, Ks, hd, lane, s0, s1);
      s0 = ok0 ? cap_logit(s0, logit_cap) : NEG_INF;
      s1 = ok1 ? cap_logit(s1, logit_cap) : NEG_INF;
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
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* lens,
                   const int* tbl, float* pm, float* pl, float* pa, void* o, int BKV, int KV,
                   int G, int hd, int psz, int ns, long long tbl_sb, const long long* st,
                   int split_len, int n_split, int window, float logit_cap, float scale,
                   cudaStream_t stream) {
  const size_t smem = 2 * sizeof(long long) * attn::BK +
                      sizeof(float) * (2 * (size_t)G * hd + 2 * G + attn::BK * (hd + 1) +
                                       attn::BK * hd + NWARPS * attn::BK);
  auto kern = paged_split_kernel<T, DPL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(BKV, n_split), NWARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, lens, tbl, pm, pl, pa, KV, G, hd, psz, ns,
      tbl_sb, st[0], st[1], st[2], st[3], st[4], st[5], split_len, window, logit_cap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn::merge_splits_kernel<T><<<BKV, 128, 0, stream>>>(pm, pl, pa, (T*)o, G, hd, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dpl, const void* q, const void* kp, const void* vp, const int* lens,
                     const int* tbl, float* pm, float* pl, float* pa, void* o, int BKV, int KV,
                     int G, int hd, int psz, int ns, long long tbl_sb, const long long* st,
                     int split_len, int n_split, int window, float logit_cap, float scale,
                     cudaStream_t s) {
  switch (dpl) {
    case 1: return launch<T, 1>(q, kp, vp, lens, tbl, pm, pl, pa, o, BKV, KV, G, hd, psz, ns, tbl_sb, st, split_len, n_split, window, logit_cap, scale, s);
    case 2: return launch<T, 2>(q, kp, vp, lens, tbl, pm, pl, pa, o, BKV, KV, G, hd, psz, ns, tbl_sb, st, split_len, n_split, window, logit_cap, scale, s);
    case 4: return launch<T, 4>(q, kp, vp, lens, tbl, pm, pl, pa, o, BKV, KV, G, hd, psz, ns, tbl_sb, st, split_len, n_split, window, logit_cap, scale, s);
    case 8: return launch<T, 8>(q, kp, vp, lens, tbl, pm, pl, pa, o, BKV, KV, G, hd, psz, ns, tbl_sb, st, split_len, n_split, window, logit_cap, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, o: (B, H, hd) contiguous, H = KV * G.  k_pages, v_pages: the pool,
// (P, page_size, KV, hd) or any layout with strides (elements) over page,
// slot and kv head and a contiguous last dim; strides = {k_sp, k_ss, k_sh,
// v_sp, v_ss, v_sh}.  kv_lens: (B,) int32 on the device.  block_tables:
// (B, ns) int32, rows tbl_sb elements apart, entry j the pool page holding
// keys [j * page_size, (j + 1) * page_size) of the slot; the entries of the
// pages a slot attends must lie in the pool, and keys past ns * page_size
// are not attended whatever kv_lens says.  part_m, part_l:
// (B*KV, n_split, G) float32 scratch; part_acc: (B*KV, n_split, G, hd).
// Split s covers keys [s * split_len, (s + 1) * split_len).  dtype 0 =
// float32, 1 = bfloat16; window <= 0 and logit_cap <= 0 mean none.  Returns
// cudaGetLastError() after the two launches.
int paged_decode_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                               const void* kv_lens, const void* block_tables, void* part_m,
                               void* part_l, void* part_acc, void* o, int dtype, int B, int KV,
                               int G, int hd, int page_size, int ns, long long tbl_sb,
                               const long long* strides, int split_len, int n_split,
                               int window, float logit_cap, float scale, void* stream) {
  if (hd % 8 != 0 || hd > 256 || page_size < 1 || ns < 1 || split_len < 1 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  const int dpl = hd <= 32 ? 1 : hd <= 64 ? 2 : hd <= 128 ? 4 : 8;
  cudaStream_t s = (cudaStream_t)stream;
  const int *lens = (const int*)kv_lens, *tbl = (const int*)block_tables;
  float *pm = (float*)part_m, *pl = (float*)part_l, *pa = (float*)part_acc;
  cudaError_t err = dtype == 0
      ? dispatch<float>(dpl, q, k_pages, v_pages, lens, tbl, pm, pl, pa, o, B * KV, KV, G, hd,
                        page_size, ns, tbl_sb, strides, split_len, n_split, window, logit_cap,
                        scale, s)
      : dispatch<__nv_bfloat16>(dpl, q, k_pages, v_pages, lens, tbl, pm, pl, pa, o, B * KV,
                                KV, G, hd, page_size, ns, tbl_sb, strides, split_len, n_split,
                                window, logit_cap, scale, s);
  return (int)err;
}

}  // extern "C"
