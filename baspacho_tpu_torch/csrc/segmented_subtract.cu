// K2 segmented_subtract: deterministic assembly.
//
// Replaces PlannedBackend._apply_pairs
// (baspacho_tpu/ops/planned_backend.py:1466), the per-level block-pair
// scatter-add of the products x . x^T into later panels (PairBucket
// descriptors :116-135), and the below-row RHS scatter of the L solve
// pass (the vv[bidx] -= below . x half of _diag_solve, :2173-2179) and
// of the block mat-vec.
//
//   out[tgt[t] * width + k] -= sum_{j in [seg_ptr[t], seg_ptr[t+1])}
//                              src[src_idx[j] * width + k]
//
// The host builds the CSR once per level: contributions sorted by
// target, stable in origin order. width is 1 for the factor (targets
// are data elements) and nrhs for the solve and the mat-vec (targets are
// RHS rows). Bound by device memory traffic: the gathered source rows,
// the indices, one read-modify-write per target row.
//
// Segments differ by orders of magnitude: a factor level's targets take
// 1-7 sources, while FLAT+Schur 50k's 50,000 width-3 origins scatter ~3M
// below rows onto the 3,000 rows of its corner (~1,000 a row), and BAL
// 871's point level onto its cameras' rows (~3,000 a row). A thread per
// target walking its segment leaves the card idle behind a few hundred
// threads' chains of gathers there. So the host also cuts the CSR, once
// per level (ops/kernels.py seg_plan), into
//   seg_short_kernel: every segment of at most SEG_SHORT sources, a
//     thread each: its sources in order, each index read once for all
//     the row's columns (up to kCols at a time), four sources' loads in
//     flight;
//   seg_chunk_kernel: the longer ones, cut into chunks of at most
//     kChunk sources (a segment's chunks as equal as they come), a CTA of
//     kThreads each: thread t sums sources t, t + kThreads, ... of the
//     chunk in that order, the CTA's sums are joined by a butterfly in
//     each warp and the warps' sums in warp order. A segment of one chunk
//     is written by its CTA; the chunks of a longer one write partials;
//   seg_post_kernel: a thread per (segment of several chunks, column),
//     adding its partials in chunk order.
// Every sum's order depends on the CSR alone, not on the batch or the
// run, so the result is bitwise the same from run to run and a batch
// item equals its single run: no atomics. The plan's indices are int32
// (idx32) where they fit and the plan is large or has chunks, which
// halves their bytes; small plans of short segments read int64 faster.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // every grid
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                   // sources a thread of a chunk
constexpr int kChunk = kThreads * kPer;   // (ops/kernels.py SEG_CHUNK)
constexpr int kCols = 4;                  // columns a thread at a time

// the plan of one CSR (ops/kernels.py SegLayout; host memory, passed by
// value to the grids), its index arrays int32 or int64 (I)
struct SegPlan {
  const void* s_tgt;  // short segment g: target row s_tgt[g], sources
  const void* s_ptr;  //   s_src[s_ptr[g] .. s_ptr[g + 1])
  const void* s_src;
  const void* c_dst;  // chunk c: target row c_dst[c] >= 0, or partial
  const void* c_ptr;  //   slot -1 - c_dst[c]; sources l_src[c_ptr[c] ..
  const void* l_src;  //   c_ptr[c + 1])
  const void* p_tgt;  // post segment q: target row p_tgt[q], partial
  const void* p_ptr;  //   slots p_ptr[q] .. p_ptr[q + 1]
  int64_t n_short, n_chunk, n_post, n_slot;
  int idx32;
};

struct SegArgs {
  SegPlan pl;
  void* out;
  int64_t out_bs;
  const void* src;
  int64_t src_bs;
  void* part;  // (batch, n_slot, width)
  int width;
};

template <typename I>
__device__ __forceinline__ int64_t ix(const void* p, int64_t i) {
  return (int64_t)static_cast<const I*>(p)[i];
}

// columns k0 .. k0 + KW - 1 (those < w) of source row q
template <typename T, int KW>
__device__ __forceinline__ void row_load(const T* s, int64_t q, int w,
                                         int k0, T (&v)[KW]) {
#pragma unroll
  for (int kk = 0; kk < KW; ++kk)
    v[kk] = k0 + kk < w ? s[q * w + k0 + kk] : T(0);
}

template <typename T, typename I, int KW>
__global__ void __launch_bounds__(kThreads) seg_short_kernel(SegArgs a) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= a.pl.n_short) return;
  const T* s = static_cast<const T*>(a.src) + (int64_t)blockIdx.y * a.src_bs;
  T* o = static_cast<T*>(a.out) + (int64_t)blockIdx.y * a.out_bs;
  const int w = a.width;
  const int64_t b = ix<I>(a.pl.s_ptr, g), e = ix<I>(a.pl.s_ptr, g + 1);
  const int64_t t = ix<I>(a.pl.s_tgt, g);
  for (int k0 = 0; k0 < w; k0 += KW) {
    T acc[KW];
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) acc[kk] = T(0);
    int64_t j = b;
    for (; j + 4 <= e; j += 4) {
      int64_t q[4];
      T v[4][KW];
#pragma unroll
      for (int u = 0; u < 4; ++u) q[u] = ix<I>(a.pl.s_src, j + u);
#pragma unroll
      for (int u = 0; u < 4; ++u) row_load<T, KW>(s, q[u], w, k0, v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int kk = 0; kk < KW; ++kk) acc[kk] += v[u][kk];
    }
    for (; j < e; ++j) {
      T v[KW];
      row_load<T, KW>(s, ix<I>(a.pl.s_src, j), w, k0, v);
#pragma unroll
      for (int kk = 0; kk < KW; ++kk) acc[kk] += v[kk];
    }
#pragma unroll
    for (int kk = 0; kk < KW; ++kk)
      if (k0 + kk < w) o[t * w + k0 + kk] -= acc[kk];
  }
}

template <typename T, typename I, int KW>
__global__ void __launch_bounds__(kThreads) seg_chunk_kernel(SegArgs a) {
  __shared__ T red[kWarps][KW];
  const int64_t c = blockIdx.x;
  const T* s = static_cast<const T*>(a.src) + (int64_t)blockIdx.y * a.src_bs;
  const int w = a.width, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t b = ix<I>(a.pl.c_ptr, c), e = ix<I>(a.pl.c_ptr, c + 1);
  const int64_t dst = ix<I>(a.pl.c_dst, c);
  int64_t q[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int64_t j = b + tid + (int64_t)u * kThreads;
    q[u] = j < e ? ix<I>(a.pl.l_src, j) : -1;
  }
  for (int k0 = 0; k0 < w; k0 += KW) {
    T v[kPer][KW], acc[KW];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (q[u] >= 0)
        row_load<T, KW>(s, q[u], w, k0, v[u]);
      else
#pragma unroll
        for (int kk = 0; kk < KW; ++kk) v[u][kk] = T(0);
    }
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      acc[kk] = T(0);
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (q[u] >= 0) acc[kk] += v[u][kk];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[kk] += __shfl_xor_sync(0xffffffffu, acc[kk], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int kk = 0; kk < KW; ++kk) red[warp][kk] = acc[kk];
    }
    __syncthreads();
    if (tid < KW && k0 + tid < w) {
      T sum = red[0][tid];
#pragma unroll
      for (int wi = 1; wi < kWarps; ++wi) sum += red[wi][tid];
      if (dst >= 0)
        static_cast<T*>(a.out)[(int64_t)blockIdx.y * a.out_bs + dst * w + k0 +
                               tid] -= sum;
      else
        static_cast<T*>(a.part)[((int64_t)blockIdx.y * a.pl.n_slot - 1 -
                                 dst) * w + k0 + tid] = sum;
    }
    __syncthreads();
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads) seg_post_kernel(SegArgs a) {
  const int w = a.width;
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t qs = g / w;
  const int k = (int)(g % w);
  if (qs >= a.pl.n_post) return;
  const T* part = static_cast<const T*>(a.part) +
                  (int64_t)blockIdx.y * a.pl.n_slot * w + k;
  T sum = T(0);
  for (int64_t c = ix<I>(a.pl.p_ptr, qs); c < ix<I>(a.pl.p_ptr, qs + 1); ++c)
    sum += part[c * w];
  static_cast<T*>(a.out)[(int64_t)blockIdx.y * a.out_bs +
                         ix<I>(a.pl.p_tgt, qs) * w + k] -= sum;
}

template <typename T, typename I, int KW>
int launch(const SegArgs& a, int batch, cudaStream_t st) {
  cudaError_t e;
  if (a.pl.n_short > 0) {
    const int64_t blocks = (a.pl.n_short + kThreads - 1) / kThreads;
    seg_short_kernel<T, I, KW><<<dim3((unsigned)blocks, batch), kThreads, 0,
                                 st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (a.pl.n_chunk > 0) {
    seg_chunk_kernel<T, I, KW><<<dim3((unsigned)a.pl.n_chunk, batch),
                                 kThreads, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (a.pl.n_post > 0) {
    const int64_t blocks = (a.pl.n_post * a.width + kThreads - 1) / kThreads;
    seg_post_kernel<T, I><<<dim3((unsigned)blocks, batch), kThreads, 0, st>>>(
        a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T, typename I>
int launch_cols(const SegArgs& a, int batch, cudaStream_t st) {
  switch (a.width < kCols ? a.width : kCols) {
    case 1: return launch<T, I, 1>(a, batch, st);
    case 2: return launch<T, I, 2>(a, batch, st);
    case 3: return launch<T, I, 3>(a, batch, st);
    default: return launch<T, I, kCols>(a, batch, st);
  }
}

}  // namespace

// dtype: 0 float32, 1 float64; plan_ptr: the CSR's SegPlan (host
// memory); out, src: (batch, ...) buffers with batch strides out_bs,
// src_bs; part: the partials, batch * n_slot * width elements (unused
// without them). Returns the cudaError_t of the launches.
extern "C" int bs_segmented_subtract(int dtype, const void* plan_ptr,
                                     void* out, int64_t out_bs,
                                     const void* src, int64_t src_bs,
                                     void* part, int width, int batch,
                                     void* stream) {
  if (width < 1 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const SegPlan* plan = static_cast<const SegPlan*>(plan_ptr);
  const SegArgs a{*plan, out, out_bs, src, src_bs, part, width};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return plan->idx32 ? launch_cols<float, int32_t>(a, batch, s)
                       : launch_cols<float, int64_t>(a, batch, s);
  if (dtype == 1)
    return plan->idx32 ? launch_cols<double, int32_t>(a, batch, s)
                       : launch_cols<double, int64_t>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}
