// K6 grad_hess: deterministic gradient / Hessian assembly of one factor
// family of the LM optimizer.
//
// Replaces Optimizer._accumulate_family
// (baspacho_tpu/optimizer/optimizer.py:334-363, driven by _grad_hess_impl
// :365-407): per factor f, g_k += J_k^T r into grad[vec_off_k + i] and
// H_kl += J_k^T J_l into the coalesced Hessian buffer at off + i*stride + j
// (off + j*stride + i where the block is stored transposed, `flip`). The
// JAX package materialises every per-factor product (2.64M x 81 values on
// BAL 871) and scatter-adds it; here the products are formed on the fly
// inside a segmented reduction, without atomics.
//
//   W   (F, rdim, TDW)  the family's weighted Jacobians of every live slot
//                       side by side, then the weighted residual as the
//                       last column: W[f, q, a + i] = sqrt(w_f) J_k[f, q, i]
//
// The host (ops/assembly.py) sorts every (pair, factor) contribution by
// its destination block once per optimizer: segment s is one block of
// rows[s] x cols[s] elements at out[off[s] + r * stride[s] + c]; its
// records rec[ptr[s] .. ptr[s+1]) are f * Q + q, in factor order, where q
// names the two column offsets (tab_a[q], tab_b[q]) into W, so
//
//   out[off + r * stride + c] += sum_records sum_k W[f, k, tab_a + r]
//                                                  * W[f, k, tab_b + c]
//
// The gradient is the same reduction with cols 1 and tab_b the residual
// column. Products accumulate in the output type, as the JAX einsums'
// preferred_element_type does. No atomics: every sum is taken in one
// fixed order, the same bits from run to run.
//
// Bound by device memory: W, the touched output elements read and
// written once (BAL 871: 71M elements of 2.64M camera-point blocks), the
// plan's index arrays. A warp per short segment would leave most lanes
// idle (BAL's blocks are 9 x 3, 3 x 3 and 3 x 1) behind a chain of
// dependent loads, and a CTA per long segment (870 cameras of ~3,000
// records) would not fill the card. So the host orders each output's
// segments in classes (short ones of equal rows, cols and record count;
// long ones of equal rows and cols), and one call runs both outputs of a
// family in three grids:
//   gh_short_kernel: one thread per row of every short segment (at most
//     LONG_SEG records: point blocks, camera-point blocks, point
//     gradients), its elements in registers. Each class entry covers
//     whole CTAs; a thread finds its segment, row and records from the
//     entry's first segment and record by division, so that only the
//     record -> W loads wait on each other, and adds the records in
//     order to the values it read.
//     The host cuts the classes of both outputs into pieces and lays
//     them out piece by piece (ops/assembly.py `_entries`): the blocks
//     of one piece read the same few MB of W (a point's 3 x 3 block, its
//     camera-point blocks, its gradient), which L2 keeps between them.
//   gh_chunk_kernel: one CTA per chunk of at most chunk_rec records of a
//     long segment of either output (camera blocks and gradients: 12
//     chunks each on BAL, ~21,000 CTAs, the two outputs' chunks in
//     turn): the records' W offsets, then G = 256 / rows thread groups
//     summing interleaved records, a thread a row of the block in
//     registers, reading W directly, joined in group order into the
//     chunk's partial block in a scratch (staging the records' W columns
//     in shared memory instead bounds a chunk's records and the CTAs an
//     SM by the shared memory, and was slower on BAL).
//   gh_post_kernel: one thread per element of every long segment, adding
//     its chunks' partials in chunk order to the value it read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_tiles.cuh"

namespace {

constexpr int kThreads = 256;  // every grid
constexpr int kMaxCls = 32;    // class entries of one launch
constexpr int kMaxChunkRec = kThreads;  // records of a chunk at most

// one output's plan (Hessian data or gradient)
struct Out {
  void* out;
  const int64_t* off;
  const int64_t* stride;
  const int64_t* rows;
  const int64_t* cols;
  const int64_t* ptr;
  const int64_t* rec;
  const int64_t* chunk_seg;
  const int64_t* chunk_p0;
  const int64_t* chunk_ptr;
  void* part;  // chunk partials, nchunks x max_e
  int64_t nchunks;
  int64_t first_long;
  int chunk_rec;
  int max_rc;  // the largest long rows + cols
  int max_e;   // the partial block's stride: the largest long rows x cols
};

// one family's operands (bs_grad_hess)
struct Gh {
  const void* W;
  int64_t tdw;
  int rdim;
  const int64_t* tab_a;
  const int64_t* tab_b;
  int64_t Q;
  Out o[2];  // the Hessian data, the gradient
};

// up to kMaxCls class entries, each covering whole CTAs from cta[k]:
// nseg[k] segments of output out[k] from seg[k], r[k] x c[k] elements; a
// short class's segments hold cnt[k] records each, from record rec0[k] on
struct Cls {
  int n;
  int64_t cta[kMaxCls + 1];
  int64_t seg[kMaxCls];
  int64_t rec0[kMaxCls];
  int nseg[kMaxCls];
  int r[kMaxCls], c[kMaxCls], cnt[kMaxCls], out[kMaxCls];
};

// record v = f * Q + q -> (f, q); 32-bit division where it fits
__device__ __forceinline__ void split_rec(int64_t v, int64_t Q, int64_t& f,
                                          int64_t& q) {
  if (((uint64_t)v >> 32) == 0 && ((uint64_t)Q >> 32) == 0) {
    const unsigned fu = (unsigned)v / (unsigned)Q;
    f = fu;
    q = (int64_t)((unsigned)v - fu * (unsigned)Q);
  } else {
    f = v / Q;
    q = v - f * Q;
  }
}

// the class entry k of this CTA (a binary search of the entries' first
// CTAs) and its thread's index t in the entry
__device__ __forceinline__ int entry_of(const Cls& cl, unsigned& t) {
  int lo = 0, hi = cl.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if ((int64_t)blockIdx.x >= cl.cta[mid]) lo = mid;
    else hi = mid - 1;
  }
  t = (unsigned)(((int64_t)blockIdx.x - cl.cta[lo]) * kThreads + threadIdx.x);
  return lo;
}

constexpr int kRowCols = 4;  // columns a short-grid thread keeps at once

// one thread per row of a short segment: its C elements (kRowCols at a
// time) start from the values they hold, then each record adds sum_k
// W[f, k, a + r] * W[f, k, b + c] to them, in record order; the records
// are found from the entry's first record, so that the loads of the
// records, the block's offset and stride and the old values do not wait
// on one another
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gh_short_kernel(const __grid_constant__ Gh a,
                    const __grid_constant__ Cls cl) {
  unsigned t;
  const int k = entry_of(cl, t);
  const int R = cl.r[k], C = cl.c[k];
  const unsigned sl = t / (unsigned)R;
  if (sl >= (unsigned)cl.nseg[k]) return;
  const int r = (int)(t - sl * (unsigned)R);
  const int64_t s = cl.seg[k] + sl;
  const Out& d = a.o[cl.out[k]];
  const T* W = static_cast<const T*>(a.W);
  T* out = static_cast<T*>(d.out) + d.off[s] + r * d.stride[s];
  const int64_t p0 = cl.rec0[k] + (int64_t)sl * cl.cnt[k];
  const int cnt = cl.cnt[k];
  const int64_t tdw = a.tdw;
  const int rdim = a.rdim;
  for (int c0 = 0; c0 < C; c0 += kRowCols) {
    T acc[kRowCols];
#pragma unroll
    for (int c = 0; c < kRowCols; ++c)
      acc[c] = c0 + c < C ? out[c0 + c] : T(0);
    for (int j = 0; j < cnt; ++j) {
      int64_t f, q;
      split_rec(d.rec[p0 + j], a.Q, f, q);
      const T* wa = W + f * rdim * tdw + a.tab_a[q] + r;
      const T* wb = W + f * rdim * tdw + a.tab_b[q] + c0;
      T sum[kRowCols];
#pragma unroll
      for (int c = 0; c < kRowCols; ++c) sum[c] = T(0);
      for (int kk = 0; kk < rdim; ++kk) {
        const T av = wa[kk * tdw];
#pragma unroll
        for (int c = 0; c < kRowCols; ++c)
          if (c0 + c < C) sum[c] += av * wb[kk * tdw + c];
      }
#pragma unroll
      for (int c = 0; c < kRowCols; ++c) acc[c] += sum[c];
    }
#pragma unroll
    for (int c = 0; c < kRowCols; ++c)
      if (c0 + c < C) out[c0 + c] = acc[c];
  }
}

constexpr int kChunkCols = 12;  // columns a chunk-grid thread sums at once

// the chunks of both outputs' long segments, a CTA each, the two lists
// interleaved (Hessian chunk i, gradient chunk i, ..., then the rest of
// the longer list): where both outputs' long segments hold the same
// records in the same order (BAL: a camera's block and its gradient),
// the second reads its W rows from L2. The records' W offsets first,
// then thread (g, r) sums row r of the block over the records g, g + G,
// ... (G = kThreads / rows groups), kChunkCols columns at a time in
// registers, reading W directly (a record's columns are shared by its
// group's threads through L1); the groups' sums are joined in group order
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gh_chunk_kernel(const __grid_constant__ Gh a) {
  __shared__ int64_t wa[kMaxChunkRec], wb[kMaxChunkRec];
  __shared__ T red[kThreads * kChunkCols];
  const int64_t n0 = a.o[0].nchunks, n1 = a.o[1].nchunks;
  const int64_t both = n0 < n1 ? n0 : n1;
  int o;
  int64_t j;
  if ((int64_t)blockIdx.x < 2 * both) {
    o = blockIdx.x & 1;
    j = blockIdx.x >> 1;
  } else {
    o = n0 > n1 ? 0 : 1;
    j = both + (int64_t)blockIdx.x - 2 * both;
  }
  const Out& d = a.o[o];
  const int tid = threadIdx.x;
  const int64_t s = d.chunk_seg[j];
  const int R = (int)d.rows[s], C = (int)d.cols[s];
  const int rdim = a.rdim;
  const int64_t tdw = a.tdw;
  const int64_t p0 = d.chunk_p0[j];
  const int64_t pe = d.ptr[s + 1];
  const int nrec = (int)(pe - p0 < d.chunk_rec ? pe - p0 : d.chunk_rec);
  if (tid < nrec) {
    int64_t f, q;
    split_rec(d.rec[p0 + tid], a.Q, f, q);
    wa[tid] = f * rdim * tdw + a.tab_a[q];
    wb[tid] = f * rdim * tdw + a.tab_b[q];
  }
  __syncthreads();
  const T* W = static_cast<const T*>(a.W);
  const int G = kThreads / R, g = tid / R, r = tid - g * R;
  T* part = static_cast<T*>(d.part) + j * d.max_e;
  for (int c0 = 0; c0 < C; c0 += kChunkCols) {
    T acc[kChunkCols];
#pragma unroll
    for (int c = 0; c < kChunkCols; ++c) acc[c] = T(0);
#pragma unroll 2
    for (int jj = g; g < G && jj < nrec; jj += G) {
      const T* pa = W + wa[jj] + r;
      const T* pb = W + wb[jj] + c0;
      T sum[kChunkCols];
#pragma unroll
      for (int c = 0; c < kChunkCols; ++c) sum[c] = T(0);
      for (int k = 0; k < rdim; ++k) {
        const T av = pa[k * tdw];
#pragma unroll
        for (int c = 0; c < kChunkCols; ++c)
          if (c0 + c < C) sum[c] += av * pb[k * tdw + c];
      }
#pragma unroll
      for (int c = 0; c < kChunkCols; ++c) acc[c] += sum[c];
    }
#pragma unroll
    for (int c = 0; c < kChunkCols; ++c) red[tid * kChunkCols + c] = acc[c];
    __syncthreads();
    for (int e = tid; e < R * kChunkCols; e += kThreads) {
      const int rr = e / kChunkCols, cc = e - rr * kChunkCols;
      if (c0 + cc >= C) continue;
      T tot = T(0);
      for (int gg = 0; gg < G; ++gg)
        tot += red[(gg * R + rr) * kChunkCols + cc];
      part[rr * C + c0 + cc] = tot;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gh_post_kernel(const __grid_constant__ Gh a,
                   const __grid_constant__ Cls cl) {
  unsigned t;
  const int k = entry_of(cl, t);
  const int C = cl.c[k], E = cl.r[k] * C;
  const unsigned sl = t / (unsigned)E;
  if (sl >= (unsigned)cl.nseg[k]) return;
  const int e = (int)(t - sl * (unsigned)E), r = e / C, c = e - r * C;
  const int64_t s = cl.seg[k] + sl;
  const Out& d = a.o[cl.out[k]];
  T* out = static_cast<T*>(d.out);
  const T* part = static_cast<const T*>(d.part);
  const int64_t dst = d.off[s] + r * d.stride[s] + c;
  const int64_t L = s - d.first_long;
  const int64_t c0 = d.chunk_ptr[L], c1 = d.chunk_ptr[L + 1];
  T tot = out[dst];
  for (int64_t j = c0; j < c1; ++j) tot += part[j * d.max_e + e];
  out[dst] = tot;
}

// the class entries ent[7 i .. 7 i + 7) = (output, first segment,
// segments, rows, cols, records a segment, first record), i in [i0, i1),
// laid out on whole CTAs: a thread per row of a segment (per_row), else
// per element
Cls classes(const int64_t* ent, int i0, int i1, bool per_row) {
  Cls cl{};
  cl.n = i1 - i0;
  int64_t cta = 0;
  for (int i = i0; i < i1; ++i) {
    const int k = i - i0;
    const int64_t* e = ent + 7 * i;
    cl.out[k] = (int)e[0];
    cl.seg[k] = e[1];
    cl.nseg[k] = (int)e[2];
    cl.r[k] = (int)e[3];
    cl.c[k] = (int)e[4];
    cl.cnt[k] = (int)e[5];
    cl.rec0[k] = e[6];
    cl.cta[k] = cta;
    cta += (e[2] * e[3] * (per_row ? 1 : e[4]) + kThreads - 1) / kThreads;
  }
  cl.cta[cl.n] = cta;
  return cl;
}

template <typename T>
int launch(const Gh& a, const int64_t* short_ent, int n_short,
           const int64_t* long_ent, int n_long, cudaStream_t st) {
  cudaError_t e;
  for (const Out& d : a.o)
    if (d.nchunks > 0 &&
        (d.chunk_rec > kMaxChunkRec || d.max_rc > kThreads))
      return (int)cudaErrorInvalidValue;
  const int64_t nchunks = a.o[0].nchunks + a.o[1].nchunks;
  const bool chunks = nchunks > 0;
  if (chunks) {
    gh_chunk_kernel<T><<<(unsigned)nchunks, kThreads, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  for (int i = 0; i < n_short; i += kMaxCls) {
    const Cls cl = classes(
        short_ent, i, i + kMaxCls < n_short ? i + kMaxCls : n_short, true);
    gh_short_kernel<T><<<(unsigned)cl.cta[cl.n], kThreads, 0, st>>>(a, cl);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  for (int i = 0; i < n_long && chunks; i += kMaxCls) {
    const Cls cl = classes(
        long_ent, i, i + kMaxCls < n_long ? i + kMaxCls : n_long, false);
    gh_post_kernel<T><<<(unsigned)cl.cta[cl.n], kThreads, 0, st>>>(a, cl);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// dtype: 0 float32, 1 float64. outs: a host array of 16 values per
// output (the Hessian data, then the gradient): its buffer, off, stride,
// rows, cols, ptr, rec, chunk_seg, chunk_p0, chunk_ptr, part (addresses),
// nchunks, first_long, chunk_rec, max_rc, max_e (ops/assembly.py
// Segments; part: nchunks x max_e elements). short_ent / long_ent: host
// arrays of (output, first segment, segments, rows, cols, records a
// segment, first record) per class entry (FamilyAssembly.short_entries /
// long_entries). Launches the chunk grid of both outputs, the short grid
// and the post grid, up to 32 class entries a launch. Returns the
// cudaError_t of the launches.
extern "C" int bs_grad_hess(int dtype, const void* W, int64_t tdw, int rdim,
                            const int64_t* tab_a, const int64_t* tab_b,
                            int64_t Q, const int64_t* outs,
                            const int64_t* short_ent, int n_short,
                            const int64_t* long_ent, int n_long,
                            void* stream) {
  Gh a{};
  a.W = W;
  a.tdw = tdw;
  a.rdim = rdim;
  a.tab_a = tab_a;
  a.tab_b = tab_b;
  a.Q = Q;
  for (int o = 0; o < 2; ++o) {
    const int64_t* v = outs + 16 * o;
    Out& d = a.o[o];
    d.out = reinterpret_cast<void*>(v[0]);
    d.off = reinterpret_cast<const int64_t*>(v[1]);
    d.stride = reinterpret_cast<const int64_t*>(v[2]);
    d.rows = reinterpret_cast<const int64_t*>(v[3]);
    d.cols = reinterpret_cast<const int64_t*>(v[4]);
    d.ptr = reinterpret_cast<const int64_t*>(v[5]);
    d.rec = reinterpret_cast<const int64_t*>(v[6]);
    d.chunk_seg = reinterpret_cast<const int64_t*>(v[7]);
    d.chunk_p0 = reinterpret_cast<const int64_t*>(v[8]);
    d.chunk_ptr = reinterpret_cast<const int64_t*>(v[9]);
    d.part = reinterpret_cast<void*>(v[10]);
    d.nchunks = v[11];
    d.first_long = v[12];
    d.chunk_rec = (int)v[13];
    d.max_rc = (int)v[14];
    d.max_e = (int)v[15];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, short_ent, n_short, long_ent, n_long, s);
  if (dtype == 1)
    return launch<double>(a, short_ent, n_short, long_ent, n_long, s);
  return (int)cudaErrorInvalidValue;
}
