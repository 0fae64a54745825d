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
// least time is the bytes of the live keys.  What the design does about it,
// in ONE launch (the split-K decode kernel's structure, decode_attention.cu,
// read through a page table):
//  - the pool is read in place, (P, psz, KV, hd) through its strides: key s
//    of slot b and kv head h lies at tbl[b, s / psz] * sp + (s % psz) * ss +
//    h * sh, so no call copies or transposes the pool;
//  - the key axis is split so that a small batch still fills the SMs: grid
//    (B*KV, C, G chunks), C = min(n_split, MAX_CLUSTER) blocks of one (slot,
//    kv head) form a thread-block cluster, and block y walks splits y, y + C,
//    ... in turn.  The plan depends on shapes only: kv_lens stays on the
//    device and nothing synchronises with the host;
//  - before a split's first tile the block reads the table entries of the
//    pages it will touch into shared memory, once (a split holds at most
//    TBL pages); a tile of KT keys may span several small pages or lie
//    inside one large page, and each of its rows is looked up there;
//  - each block streams its keys through an NSTAGE-deep ring of K/V tiles in
//    shared memory, kept in the pool's dtype and filled by 16-byte cp.async,
//    zero-filled past the split, so several tiles are in flight while one is
//    scored.  A pool whose pointer or strides break the 16-byte rule is
//    copied element by element into the same ring;
//  - the work is split by keys, not by query rows: a group of LPK lanes owns
//    one key and reads its row as 16-byte vectors, the (up to GMAX) query
//    rows of the chunk sit in shared memory as float, and the dot products
//    reduce with shuffles inside the group;
//  - each warp keeps a float32 online softmax per query row; the warps merge
//    through shared memory, then, after a cluster barrier, each block of the
//    cluster reads every block's (m, l, acc) through distributed shared
//    memory for its share of the output elements and writes them.  Nothing
//    goes to device memory but the output.
// Keys at or past kv_lens[b] or ns * psz, or before the window, are not
// attended, and no address is formed for a key past the split's bound: the
// walk's bounds come from kv_lens on the device, and a table entry is read
// only for a page below ceil(len / psz), so entries past a slot's length may
// hold anything.
//
// Numerics match the reference: q is scaled first and rounded to its own
// dtype, the dot products and the softmax are float32 (finite NEG_INF), a
// key that is not attended weighs exactly 0, an empty split carries
// (NEG_INF, 0, 0) and adds nothing, and the merge divides by max(l, 1e-30),
// so a freed slot (length 0) returns exact zeros.
#include <cooperative_groups.h>

#include "attn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NWARPS = 4;
constexpr int NSTAGE = 4;         // K/V tiles in the shared-memory ring
constexpr int MAX_CLUSTER = 16;   // blocks of one (slot, kv head) in a cluster
constexpr int GMAX = 8;           // query rows a block holds at most (a G chunk)
constexpr int TBL = 256;          // table entries a block holds: one split's pages

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

// The tiles one block walks: keys [lo, hi) of splits y, y + C, ..., KT keys
// at a time, the first tile of a split aligned to KT from the split's start.
// `stop` = min(len, ns * psz) ends every split; the window starts at
// len - window.
struct PageWalk {
  int sp, k0, hi;
  int C, n_split, split_len, stop, wlo, KT;
  __device__ void range() {
    for (; sp < n_split; sp += C) {
      const int s_begin = sp * split_len;
      hi = min(s_begin + split_len, stop);
      const int lo = max(s_begin, wlo);
      k0 = s_begin + ((lo - s_begin) / KT) * KT;
      if (k0 < hi) return;
    }
  }
  __device__ bool valid() const { return sp < n_split; }
  __device__ void next() {
    k0 += KT;
    if (k0 >= hi) {
      sp += C;
      range();
    }
  }
};

// LPK lanes per key (a power of two), VPL 16-byte vectors per lane, GB
// query rows held (the block's chunk of the group has gb <= GB rows).
// Scores and the softmax state live in the log2 domain (scores times
// log2 e, exponentials by exp2f); NEG_INF stays the masked score.  pshift
// is log2(psz) where psz is a power of two, else -1.
template <typename T, int LPK, int VPL, int GB>
__global__ void __launch_bounds__(NWARPS * 32)
paged_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
             const int* __restrict__ lens, const int* __restrict__ tbl, T* __restrict__ o,
             int KV, int G, int hd, int psz, int pshift, int ns, long long tbl_sb,
             long long k_sp, long long k_ss, long long k_sh, long long v_sp, long long v_ss,
             long long v_sh, int split_len, int n_split, int window, float logit_cap,
             float scale, int vec16) {
  using namespace attn;
  constexpr float LOG2E = 1.4426950408889634f;
  constexpr int VEC = 16 / sizeof(T);      // elements per 16-byte vector
  constexpr int KPS = 32 / LPK;            // keys a warp scores at once
  constexpr int R0 = 4 / VPL, RMAX = 64 / (NWARPS * KPS);
  constexpr int R = R0 < RMAX ? R0 : RMAX; // keys per lane group per tile
  constexpr int KT = NWARPS * KPS * R;     // keys per tile: divides 64
  constexpr int E = VPL * VEC;             // accumulator columns per lane
  static_assert(64 % KT == 0 && R >= 1, "tile");

  cg::cluster_group cluster = cg::this_cluster();
  const int bkv = blockIdx.x, C = gridDim.y;
  const int b = bkv / KV, h = bkv - b * KV;
  const int g0 = blockIdx.z * GB, gb = min(GB, G - g0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / LPK, li = lane % LPK;
  const int NV = hd / VEC;                 // vectors per row
  const int len = lens[b];

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = (T*)smem;                                   // NSTAGE x {K, V} tiles
  const int tile_elems = KT * hd;
  float* Qs = (float*)(smem + (size_t)NSTAGE * 2 * tile_elems * sizeof(T));
  float* Bm = Qs + GB * hd;                             // the block's state
  float* Bl = Bm + GB;
  float* Bacc = Bl + GB;
  int* Tb = (int*)(Bacc + GB * hd);                     // the split's table entries

  const T* qb = q + ((long long)bkv * G + g0) * hd;
  for (int idx = tid; idx < GB * hd; idx += blockDim.x)
    Qs[idx] = idx < gb * hd ? round_to<T>(to_f(qb[idx]) * scale) : 0.f;
  const int* tb = tbl + b * tbl_sb;
  const T* kb = kp + h * k_sh;
  const T* vb = vp + h * v_sh;

  auto page_of = [&](int s) { return pshift >= 0 ? s >> pshift : s / psz; };
  // Tb holds entries [t_p0, ...) of split t_sp; a split's first tile reads
  // them, from the page of that tile to the page of the split's last key
  int t_sp = -1, t_p0 = 0;
  auto table = [&](const PageWalk& w) {
    if (w.sp == t_sp) return;
    __syncthreads();              // no thread still forms addresses from Tb
    t_sp = w.sp;
    t_p0 = page_of(w.k0);
    const int p1 = page_of(w.hi - 1) + 1;
    for (int j = t_p0 + tid; j < p1; j += blockDim.x) Tb[j - t_p0] = tb[j];
    __syncthreads();
  };
  // the offset of key s's row in the pool (head h's base added by kb, vb)
  auto row = [&](int s, long long sp, long long ss) {
    const int pg = page_of(s);
    return (long long)Tb[pg - t_p0] * sp + (long long)(s - pg * psz) * ss;
  };

  auto load = [&](int stage, int k0, int hi) {
    T* Kt = ring + (size_t)stage * 2 * tile_elems;
    T* Vt = Kt + tile_elems;
    if (vec16) {
      for (int idx = tid; idx < 2 * KT * NV; idx += blockDim.x) {
        const int mat = idx >= KT * NV, rem = idx - mat * KT * NV;
        const int j = rem / NV, c = rem - j * NV;
        const int key = k0 + j;
        const bool in = key < hi;
        const T* src = mat ? vb : kb;       // read nothing from it when !in
        if (in) src += (mat ? row(key, v_sp, v_ss) : row(key, k_sp, k_ss)) + c * VEC;
        cp_async16((mat ? Vt : Kt) + j * hd + c * VEC, src, in);
      }
    } else {
      for (int idx = tid; idx < 2 * KT * hd; idx += blockDim.x) {
        const int mat = idx >= KT * hd, rem = idx - mat * KT * hd;
        const int j = rem / hd, d = rem - j * hd;
        const int key = k0 + j;
        T x = from_f<T>(0.f);
        if (key < hi) x = mat ? vb[row(key, v_sp, v_ss) + d] : kb[row(key, k_sp, k_ss) + d];
        (mat ? Vt : Kt)[j * hd + d] = x;
      }
    }
  };

  const int stop = (int)min((long long)len, (long long)ns * psz);
  const int wlo = window > 0 ? len - window : 0;       // first key the window keeps
  PageWalk prod{(int)blockIdx.y, 0, 0, C, n_split, split_len, stop, wlo, KT};
  prod.range();
  PageWalk cons = prod;
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (prod.valid()) {
      table(prod);
      load(st, prod.k0, prod.hi);
      prod.next();
    }
    cp_async_commit();
  }

  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int it = 0; cons.valid(); ++it, cons.next()) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();              // tile `it` landed; stage it - 1 is free again
    if (prod.valid()) {
      table(prod);
      load((it + NSTAGE - 1) % NSTAGE, prod.k0, prod.hi);
      prod.next();
    }
    cp_async_commit();

    const T* Kt = ring + (size_t)(it % NSTAGE) * 2 * tile_elems;
    const T* Vt = Kt + tile_elems;
    float s[R][GB];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rw = warp * KPS * R + r * KPS + grp;
      float kv[E];
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int c = li + LPK * u;
        const uint4 raw = c < NV ? *(const uint4*)(Kt + rw * hd + c * VEC) : make_uint4(0, 0, 0, 0);
        const T* e = (const T*)&raw;
#pragma unroll
        for (int j = 0; j < VEC; ++j) kv[u * VEC + j] = to_f(e[j]);
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int c = min(li + LPK * u, NV - 1);   // idle lanes hold zeros in kv
          const float* qr = Qs + g * hd + c * VEC;
#pragma unroll
          for (int j = 0; j < VEC; j += 4) {
            const float4 qv = *(const float4*)(qr + j);
            dot = fmaf(qv.x, kv[u * VEC + j], dot);
            dot = fmaf(qv.y, kv[u * VEC + j + 1], dot);
            dot = fmaf(qv.z, kv[u * VEC + j + 2], dot);
            dot = fmaf(qv.w, kv[u * VEC + j + 3], dot);
          }
        }
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[r][g] = dot;
      }
    }
    if (logit_cap > 0.f) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int g = 0; g < GB; ++g) s[r][g] = logit_cap * tanhf(s[r][g] / logit_cap);
    }
    bool ok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int key = cons.k0 + warp * KPS * R + r * KPS + grp;
      ok[r] = key < cons.hi && key >= wlo;
#pragma unroll
      for (int g = 0; g < GB; ++g) s[r][g] = ok[r] ? s[r][g] * LOG2E : NEG_INF;
    }

#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int r = 1; r < R; ++r) mx = fmaxf(mx, s[r][g]);
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float corr = exp2f(m[g] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r][g] = ok[r] ? exp2f(s[r][g] - m_new) : 0.f;   // now the probability
        sum += s[r][g];
      }
      l[g] = fmaf(l[g], corr, sum);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rw = warp * KPS * R + r * KPS + grp;
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int c = li + LPK * u;
        const uint4 raw = c < NV ? *(const uint4*)(Vt + rw * hd + c * VEC) : make_uint4(0, 0, 0, 0);
        const T* e = (const T*)&raw;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float vv = to_f(e[j]);
#pragma unroll
          for (int g = 0; g < GB; ++g) acc[g][u * VEC + j] = fmaf(s[r][g], vv, acc[g][u * VEC + j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                // the ring is free: it holds the warps' states now

  // the lane groups of a warp share m; sum their l and acc
  float* Wm = (float*)smem;                   // NWARPS x GB
  float* Wl = Wm + NWARPS * GB;
  float* Wacc = Wl + NWARPS * GB;             // NWARPS x GB x hd
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
    if (grp == 0) {
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int c = li + LPK * u;
        if (c < NV) {
#pragma unroll
          for (int j = 0; j < VEC; j += 4)
            *(float4*)(Wacc + (warp * GB + g) * hd + c * VEC + j) =
                make_float4(acc[g][u * VEC + j], acc[g][u * VEC + j + 1],
                            acc[g][u * VEC + j + 2], acc[g][u * VEC + j + 3]);
        }
      }
    }
    if (lane == 0) {
      Wm[warp * GB + g] = m[g];
      Wl[warp * GB + g] = l[g];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < gb * hd; idx += blockDim.x) {
    const int g = idx / hd;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, Wm[w * GB + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float e = exp2f(Wm[w * GB + g] - M);
      L = fmaf(Wl[w * GB + g], e, L);
      A = fmaf(Wacc[(w * GB) * hd + idx], e, A);
    }
    Bacc[idx] = A;
    if (idx - g * hd == 0) {
      Bm[g] = M;
      Bl[g] = L;
    }
  }

  // the splits merge through distributed shared memory, each block of the
  // cluster finishing its own runs of blockDim.x output elements
  cluster.sync();
  const int nblk = C, rank = (int)cluster.block_rank();
  for (int idx = rank * blockDim.x + tid; idx < gb * hd; idx += nblk * blockDim.x) {
    const int g = idx / hd;
    float rm[MAX_CLUSTER], rl[MAX_CLUSTER], ra[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < nblk) {
        rm[r] = cluster.map_shared_rank(Bm, r)[g];
        rl[r] = cluster.map_shared_rank(Bl, r)[g];
        ra[r] = cluster.map_shared_rank(Bacc, r)[idx];
      }
    }
    float M = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < nblk) M = fmaxf(M, rm[r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < nblk) {
        const float e = exp2f(rm[r] - M);
        L = fmaf(rl[r], e, L);
        A = fmaf(ra[r], e, A);
      }
    }
    o[((long long)bkv * G + g0) * hd + idx] = from_f<T>(A / fmaxf(L, 1e-30f));
  }
  cluster.sync();                 // no block leaves while another reads it
}

// The arguments every instantiation takes, as the C entry received them.
struct Args {
  const void *q, *k, *v;
  const int *lens, *tbl;
  void* o;
  int BKV, KV, G, hd, psz, pshift, ns;
  long long tbl_sb;
  const long long* st;
  int split_len, n_split, window;
  float logit_cap, scale;
  int vec16;
  cudaStream_t stream;
};

template <typename T, int LPK, int VPL, int GB>
cudaError_t launch(const Args& a) {
  constexpr int KPS = 32 / LPK, R0 = 4 / VPL, RMAX = 64 / (NWARPS * KPS);
  constexpr int KT = NWARPS * KPS * (R0 < RMAX ? R0 : RMAX);
  const int n_chunk = (a.G + GB - 1) / GB;
  const int C = a.n_split < MAX_CLUSTER ? a.n_split : MAX_CLUSTER;
  const size_t smem = (size_t)NSTAGE * 2 * KT * a.hd * sizeof(T) +
                      sizeof(float) * (2 * GB * a.hd + 2 * GB) + sizeof(int) * TBL;
  auto kern = paged_kernel<T, LPK, VPL, GB>;
  // the kernel's attributes, set once per device and shared-memory size
  static size_t smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.BKV, C, n_chunk);
  cfg.blockDim = dim3(NWARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = C;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long long* st = a.st;
  err = cudaLaunchKernelEx(&cfg, kern, (const T*)a.q, (const T*)a.k, (const T*)a.v, a.lens,
                           a.tbl, (T*)a.o, a.KV, a.G, a.hd, a.psz, a.pshift, a.ns, a.tbl_sb,
                           st[0], st[1], st[2], st[3], st[4], st[5], a.split_len, a.n_split,
                           a.window, a.logit_cap, a.scale, a.vec16);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int LPK, int VPL>
cudaError_t by_group(const Args& a) {
  // rows per block: the group cut into chunks of at most GMAX, rounded up
  // to an instantiated size
  const int n_chunk = (a.G + GMAX - 1) / GMAX, need = (a.G + n_chunk - 1) / n_chunk;
  if (need <= 1) return launch<T, LPK, VPL, 1>(a);
  if (need <= 2) return launch<T, LPK, VPL, 2>(a);
  if (need <= 3) return launch<T, LPK, VPL, 3>(a);
  if (need <= 4) return launch<T, LPK, VPL, 4>(a);
  return launch<T, LPK, VPL, GMAX>(a);
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  constexpr int VEC = 16 / sizeof(T);
  const int nv = a.hd / VEC;      // 16-byte vectors per row: 1 .. 64
  if (nv <= 4) return by_group<T, 4, 1>(a);
  if (nv <= 8) return by_group<T, 8, 1>(a);
  if (nv <= 16) return by_group<T, 16, 1>(a);
  if (nv <= 32) return by_group<T, 32, 1>(a);
  if (sizeof(T) == 4 && nv <= 64) return by_group<T, 32, 2>(a);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p, const long long* st, int n, size_t size) {
  if ((size_t)p % 16) return false;
  for (int i = 0; i < n; ++i)
    if ((st[i] * (long long)size) % 16) return false;
  return true;
}

}  // namespace

extern "C" {

// The launcher's constants, for the Python side to check: {MAX_CLUSTER,
// NSTAGE, GMAX, TBL}.
void paged_decode_attention_config(int* out) {
  out[0] = MAX_CLUSTER;
  out[1] = NSTAGE;
  out[2] = GMAX;
  out[3] = TBL;
}

// q, o: (B, H, hd) contiguous, H = KV * G.  k_pages, v_pages: the pool,
// (P, page_size, KV, hd) or any layout with strides (elements) over page,
// slot and kv head and a contiguous last dim; strides = {k_sp, k_ss, k_sh,
// v_sp, v_ss, v_sh}.  kv_lens: (B,) int32 on the device.  block_tables:
// (B, ns) int32, rows tbl_sb elements apart, entry j the pool page holding
// keys [j * page_size, (j + 1) * page_size) of the slot; the entries of the
// pages a slot attends must lie in the pool, and keys past ns * page_size
// are not attended whatever kv_lens says.  Split s covers keys
// [s * split_len, (s + 1) * split_len): split_len is a whole number of
// pages, at most TBL of them, and n_split splits cover the table's keys (a
// cluster holds up to MAX_CLUSTER; its blocks walk the rest in turn).
// dtype 0 = float32, 1 = bfloat16; window <= 0 and logit_cap <= 0 mean
// none.  One launch; returns cudaGetLastError() after it.
int paged_decode_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                               const void* kv_lens, const void* block_tables, void* o,
                               int dtype, int B, int KV, int G, int hd, int page_size, int ns,
                               long long tbl_sb, const long long* strides, int split_len,
                               int n_split, int window, float logit_cap, float scale,
                               void* stream) {
  if (hd % 8 != 0 || hd > 256 || page_size < 1 || ns < 1 || split_len < 1 || n_split < 1 ||
      split_len % page_size != 0 || split_len / page_size > TBL ||
      (long long)n_split * split_len < (long long)ns * page_size)
    return (int)cudaErrorInvalidValue;
  int pshift = -1;
  if ((page_size & (page_size - 1)) == 0)
    for (pshift = 0; (1 << pshift) < page_size; ++pshift) {}
  const size_t size = dtype == 0 ? 4 : 2;
  const int vec16 = aligned16(k_pages, strides, 3, size) &&
                    aligned16(v_pages, strides + 3, 3, size);
  const Args a{q, k_pages, v_pages, (const int*)kv_lens, (const int*)block_tables, o,
               B * KV, KV, G, hd, page_size, pshift, ns, tbl_sb, strides, split_len,
               n_split, window, logit_cap, scale, vec16, (cudaStream_t)stream};
  return (int)(dtype == 0 ? dispatch<float>(a) : dispatch<__nv_bfloat16>(a));
}

}  // extern "C"
